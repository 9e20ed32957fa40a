"""The persistent executable store behind ``aot_enabled: true`` (the
port's copy of ``video_features_tpu/aot/store.py``: the same manifest
records, payload layout, LRU eviction, orphan sweep and ``stats()``
keys, and one process-wide instance per directory).

Layout under ``aot_dir``::

    manifest.jsonl                  append-only op log (put / touch / del)
    objects/<k2>/<digest>/exec.bin  one stored executable

In the port an executable is one compiled kernel library, the ``.so``
that ``nvcc`` builds from ``csrc/<name>.cu`` (``aot/runtime.py``): an
entry holds the exact bytes the building process published.

Torch-free: the store moves bytes; what the bytes mean lives in
:mod:`aot.runtime`. Durability and integrity:

  * object files and full-manifest rewrites go through
    ``utils.output.atomic_write`` (tmp + ``os.replace``), so a reader
    never sees a torn payload;
  * incremental manifest updates are single-``write`` appended JSON
    lines; a crash tears at most the last line, which the loader skips;
  * later records win on replay, so processes sharing one ``aot_dir``
    converge (digest keys make double puts idempotent);
  * ``fetch`` size-checks the payload and, unlike the JAX store's,
    re-hashes it against the sha256 its put recorded before serving; it
    evicts (never serves) a missing, truncated, resized or rotted
    entry, so a ``.so`` with flipped bytes never reaches ``dlopen``;
    ``gc(verify=True)`` re-hashes every payload (the offline
    ``python -m video_features_torch aot-gc`` surface);
  * eviction under ``max_bytes`` pressure is LRU by last-fetch time.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from hashlib import sha256
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

from video_features_torch.utils.output import atomic_write

MANIFEST = 'manifest.jsonl'
OBJECTS = 'objects'
PAYLOAD = 'exec.bin'


def exec_digest(components: Dict[str, Any]) -> str:
    """The store key: sha256 over the canonical JSON of the identity
    components (``aot/runtime.py``): the library's program sha (its
    source, flags and nvcc release), the library lane, the torch and
    CUDA versions, platform, device kind, compute capability, host ISA
    and payload version. Any component changing is a silent miss by
    construction: the new identity simply hashes elsewhere."""
    return sha256(json.dumps(components, sort_keys=True).encode()).hexdigest()


class ExecStore:
    """One executable-store directory: index, manifest, payloads, counters."""

    _instances: Dict[str, 'ExecStore'] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get(cls, aot_dir: str,
            max_bytes: Optional[int] = None) -> 'ExecStore':
        """The process-wide instance for ``aot_dir`` (created on first
        use). A non-null ``max_bytes`` updates the shared bound — last
        writer wins (same policy as ``FeatureCache.get``)."""
        norm = os.path.abspath(os.path.expanduser(str(aot_dir)))
        with cls._instances_lock:
            inst = cls._instances.get(norm)
            if inst is None:
                inst = cls._instances[norm] = cls(norm, max_bytes=max_bytes)
            elif max_bytes is not None:
                inst.max_bytes = int(max_bytes)
            return inst

    def __init__(self, aot_dir: str,
                 max_bytes: Optional[int] = None) -> None:
        self.aot_dir = os.path.abspath(os.path.expanduser(str(aot_dir)))
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self._lock = threading.RLock()
        # digest → {'size': int, 'sha256': hex, 'meta': {...},
        #           'last_used': float}
        self._index: Dict[str, Dict[str, Any]] = {}
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.corrupt_evicted = 0
        os.makedirs(os.path.join(self.aot_dir, OBJECTS), exist_ok=True)
        self._load_manifest()

    # -- manifest ------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.aot_dir, MANIFEST)

    def _entry_dir(self, digest: str) -> str:
        return os.path.join(self.aot_dir, OBJECTS, digest[:2], digest)

    def _payload_path(self, digest: str) -> str:
        return os.path.join(self._entry_dir(digest), PAYLOAD)

    def _load_manifest(self) -> None:
        try:
            with open(self.manifest_path, 'rb') as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            return
        for line in lines:
            try:
                rec = json.loads(line)
            except (ValueError, UnicodeDecodeError):
                continue              # torn tail line from a crash: skip
            op, digest = rec.get('op'), rec.get('key')
            if not digest:
                continue
            if op == 'put' and isinstance(rec.get('size'), int):
                old = self._index.get(digest)
                if old is not None:
                    self._total_bytes -= old['size']
                self._index[digest] = {
                    'size': int(rec['size']),
                    'sha256': rec.get('sha256', ''),
                    'meta': rec.get('meta') or {},
                    'last_used': float(rec.get('t', 0.0)),
                }
                self._total_bytes += int(rec['size'])
            elif op == 'touch' and digest in self._index:
                self._index[digest]['last_used'] = float(rec.get('t', 0.0))
            elif op == 'del':
                old = self._index.pop(digest, None)
                if old is not None:
                    self._total_bytes -= old['size']

    def _append(self, rec: Dict[str, Any]) -> None:
        """One JSON line, one ``write`` call — a crash tears at most the
        final line, which the loader tolerates."""
        with open(self.manifest_path, 'a', encoding='utf-8') as f:
            f.write(json.dumps(rec, sort_keys=True) + '\n')

    def _rewrite_manifest_locked(self) -> None:
        """Compaction: one put line per live entry (atomic rewrite)."""
        def _write(f):
            for digest, e in self._index.items():
                f.write((json.dumps(
                    {'op': 'put', 'key': digest, 'size': e['size'],
                     'sha256': e['sha256'], 'meta': e['meta'],
                     't': e['last_used']}, sort_keys=True) + '\n')
                    .encode('utf-8'))
        atomic_write(self.manifest_path, _write)

    # -- core operations -----------------------------------------------------

    def contains(self, digest: str) -> bool:
        with self._lock:
            return digest in self._index

    def meta_for(self, digest: str) -> Optional[Dict[str, Any]]:
        """The recorded ``meta`` of one entry (None when absent) — the
        fleet artifact tier (``fleet/artifacts.py``) re-publishes a
        peer-compiled payload locally under the SAME meta so
        environment-drift diagnostics stay truthful on the pulling
        host."""
        with self._lock:
            entry = self._index.get(digest)
            if entry is None:
                return None
            return dict(entry['meta'])

    def metas_for(self, program_sha: str) -> list:
        """The recorded ``meta`` of every entry publishing
        ``program_sha`` — the runtime's environment-drift diagnostics
        surface (a miss for a program the store holds under a DIFFERENT
        environment names the drifted component)."""
        with self._lock:
            return [dict(e['meta']) for e in self._index.values()
                    if e.get('meta', {}).get('program_sha') == program_sha]

    def fetch(self, digest: str,
              on_corrupt: Optional[Callable[[str], None]] = None,
              ) -> Optional[bytes]:
        """The stored executable for ``digest``, or None (a miss).
        The payload is size-checked against the manifest record and
        re-hashed against the sha256 its put recorded before serving; a
        missing, truncated or resized payload, or one with rotted bytes
        at the same size, evicts the entry from this store as corrupt and
        reads as a miss — the store never serves bytes it can't vouch
        for. A sha256 mismatch also calls ``on_corrupt(aot_dir)``. The
        file read runs OUTSIDE the lock (a multi-MB payload read must not
        stall a concurrent publish)."""
        with self._lock:
            entry = self._index.get(digest)
            if entry is None:
                self.misses += 1
                return None
            size, recorded = entry['size'], entry['sha256']
        path = self._payload_path(digest)
        rotted = False
        try:
            if os.path.getsize(path) != size:
                raise OSError(f'size mismatch for {digest}')
            with open(path, 'rb') as f:
                payload = f.read()
            if len(payload) != size:
                raise OSError(f'short read for {digest}')
            rotted = sha256(payload).hexdigest() != recorded
            if rotted:
                raise OSError(f'sha256 mismatch for {digest}')
        except OSError:
            ExecStore.evict_corrupt(self, digest)
            if rotted and on_corrupt is not None:
                on_corrupt(self.aot_dir)
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            current = self._index.get(digest)
            now = time.time()
            if current is not None:
                current['last_used'] = now
                self._append({'op': 'touch', 'key': digest, 't': now})
            self.hits += 1
        return payload

    def put(self, digest: str, payload: bytes,
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Publish one freshly built executable under ``digest``.

        Idempotent: a digest already present only refreshes recency (two
        processes racing a publish store identical bytes by construction
        — the digest IS the program identity). Triggers inline LRU
        eviction when ``max_bytes`` is exceeded. The payload write runs
        OUTSIDE the lock; racing writers converge because every write is
        an atomic replace of identical bytes."""
        def _touch_locked():
            now = time.time()
            self._index[digest]['last_used'] = now
            self._append({'op': 'touch', 'key': digest, 't': now})

        with self._lock:
            if digest in self._index:
                _touch_locked()
                return
        os.makedirs(self._entry_dir(digest), exist_ok=True)
        atomic_write(self._payload_path(digest),
                     lambda f: f.write(payload))
        recorded_sha = sha256(payload).hexdigest()
        with self._lock:
            if digest in self._index:    # lost a racing publish: adopt it
                _touch_locked()
                return
            now = time.time()
            rec: Dict[str, Any] = {'op': 'put', 'key': digest,
                                   'size': len(payload),
                                   'sha256': recorded_sha, 't': now}
            if meta:
                rec['meta'] = meta
            self._append(rec)
            self._index[digest] = {'size': len(payload),
                                   'sha256': recorded_sha,
                                   'meta': dict(meta or {}),
                                   'last_used': now}
            self._total_bytes += len(payload)
            self.puts += 1
            if self.max_bytes is not None \
                    and self._total_bytes > self.max_bytes:
                self._gc_locked(self.max_bytes, verify=False)

    def evict_corrupt(self, digest: str) -> None:
        """Purge an entry whose payload failed integrity — either the
        store's own size check or the caller's sha256 check (the runtime
        layer reports bit-rot below the size check here, so a poisoned
        entry is purged instead of failing every future boot)."""
        with self._lock:
            self._evict_locked(digest, corrupt=True)

    def _evict_locked(self, digest: str, corrupt: bool = False) -> int:
        entry = self._index.pop(digest, None)
        if entry is None:
            return 0
        self._total_bytes -= entry['size']
        shutil.rmtree(self._entry_dir(digest), ignore_errors=True)
        self._append({'op': 'del', 'key': digest, 't': time.time(),
                      'corrupt': bool(corrupt)})
        if corrupt:
            self.corrupt_evicted += 1
        else:
            self.evictions += 1
        return entry['size']

    # -- garbage collection --------------------------------------------------

    def gc(self, target_bytes: Optional[int] = None, verify: bool = False,
           compact: bool = True) -> Dict[str, Any]:
        """Integrity sweep + LRU eviction + manifest compaction (the
        offline / ``aot/gc.py`` surface).

        ``verify=True`` re-hashes every payload against its recorded
        SHA-256 (otherwise only existence/size is checked); entries that
        fail either way are evicted as corrupt — a store must never keep
        an executable it would refuse to serve. Then entries are evicted
        oldest-fetch-first until total size ≤ ``target_bytes`` (default:
        the instance's ``max_bytes``; None = no size pressure). Orphan
        object directories (crashed writers) older than a grace window
        are removed. The manifest is RELOADED first so entries other
        processes appended since this instance loaded are neither
        compacted away nor swept as orphans."""
        with self._lock:
            self._index.clear()
            self._total_bytes = 0
            self._load_manifest()
            report = self._gc_locked(
                self.max_bytes if target_bytes is None else target_bytes,
                verify=verify, orphan_sweep=True)
            if compact:
                # adopt puts concurrent processes appended WHILE the
                # (possibly minutes-long) verify sweep ran: the
                # compaction rewrite below replaces the manifest
                # wholesale, and dropping a record whose payload a live
                # daemon is serving would turn a later orphan sweep
                # into data loss — only entries this sweep explicitly
                # evicted stay gone
                self._adopt_new_puts_locked(report.pop('_evicted'))
                self._rewrite_manifest_locked()
            else:
                report.pop('_evicted')
            report['entries_after'] = len(self._index)
            report['bytes_after'] = self._total_bytes
            return report

    def _adopt_new_puts_locked(self, evicted: set) -> None:
        """Re-replay the on-disk manifest and index any put that landed
        after this sweep's load — skipping digests the sweep itself
        evicted (their del records may not order after the racing put,
        but an evicted payload is gone either way)."""
        fresh = ExecStore.__new__(ExecStore)
        fresh.aot_dir = self.aot_dir
        fresh._index = {}
        fresh._total_bytes = 0
        fresh._load_manifest()
        for digest, entry in fresh._index.items():
            if digest in self._index or digest in evicted:
                continue
            self._index[digest] = entry
            self._total_bytes += entry['size']

    # object dirs younger than this are never swept as orphans: their
    # writer may simply not have appended its put record yet
    _ORPHAN_GRACE_S = 300.0

    def _gc_locked(self, target_bytes: Optional[int], verify: bool,
                   orphan_sweep: bool = False) -> Dict[str, Any]:
        """The sweep itself; compaction is the CALLER's step (``gc``)
        so it can reconcile concurrent puts first. ``_evicted`` in the
        report is internal bookkeeping for that reconciliation."""
        report: Dict[str, Any] = {
            'entries_before': len(self._index),
            'bytes_before': self._total_bytes,
            'corrupt_evicted': 0, 'lru_evicted': 0,
            'orphans_removed': 0, '_evicted': set()}
        for digest in list(self._index):
            entry = self._index[digest]
            path = self._payload_path(digest)
            bad = False
            try:
                if os.path.getsize(path) != entry['size']:
                    bad = True
                elif verify:
                    h = sha256()
                    with open(path, 'rb') as f:
                        for chunk in iter(lambda: f.read(1 << 20), b''):
                            h.update(chunk)
                    bad = h.hexdigest() != entry['sha256']
            except OSError:
                bad = True
            if bad:
                self._evict_locked(digest, corrupt=True)
                report['corrupt_evicted'] += 1
                report['_evicted'].add(digest)
        if target_bytes is not None:
            by_age = sorted(self._index,
                            key=lambda k: self._index[k]['last_used'])
            for digest in by_age:
                if self._total_bytes <= target_bytes:
                    break
                self._evict_locked(digest)
                report['lru_evicted'] += 1
                report['_evicted'].add(digest)
        if orphan_sweep:
            now = time.time()
            objects = Path(self.aot_dir) / OBJECTS
            for shard in objects.iterdir() if objects.is_dir() else ():
                if not shard.is_dir():
                    continue
                for edir in shard.iterdir():
                    if not edir.is_dir() or edir.name in self._index:
                        continue
                    try:
                        if now - edir.stat().st_mtime < self._ORPHAN_GRACE_S:
                            continue
                    except OSError:
                        continue
                    shutil.rmtree(edir, ignore_errors=True)
                    report['orphans_removed'] += 1
        report['entries_after'] = len(self._index)
        report['bytes_after'] = self._total_bytes
        return report

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                'dir': self.aot_dir,
                'entries': len(self._index),
                'bytes': self._total_bytes,
                'max_bytes': self.max_bytes,
                'hits': self.hits,
                'misses': self.misses,
                'hit_rate': (self.hits / total) if total else 0.0,
                'puts': self.puts,
                'evictions': self.evictions,
                'corrupt_evicted': self.corrupt_evicted,
            }


def merge_exec_stats(stats: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """One aggregate view over several stores' :meth:`ExecStore.stats`
    (the serve metrics document: requests may name different aot
    dirs)."""
    merged: Dict[str, Any] = {
        'stores': 0, 'entries': 0, 'bytes': 0, 'hits': 0, 'misses': 0,
        'puts': 0, 'evictions': 0, 'corrupt_evicted': 0,
        # fleet artifact-tier counters (fleet/artifacts.py): zero on
        # plain stores — always present so vft_aot_* keeps one schema
        'pulled': 0, 'published': 0,
    }
    for s in stats:
        merged['stores'] += 1
        for k in ('entries', 'bytes', 'hits', 'misses', 'puts',
                  'evictions', 'corrupt_evicted', 'pulled', 'published'):
            merged[k] += s.get(k, 0)
    total = merged['hits'] + merged['misses']
    merged['hit_rate'] = (merged['hits'] / total) if total else 0.0
    return merged


def log_aot_error(what: str) -> None:
    """Executable-store failures degrade to building on a miss, never to
    a failed run or video; silently eating them would hide a broken store
    dir (or a poisoned payload) forever, so they are reported through the
    structured event log like every other degraded path."""
    import logging

    from video_features_torch.obs.events import event
    event(logging.WARNING,
          f'executable store {what} failed (continuing with compile)',
          subsystem='aot', exc_info=True)
