"""The content-addressed feature store behind ``cache_enabled: true``
(the port's copy of ``video_features_tpu/cache/store.py``; the same
on-disk layout and manifest records, so one directory and one GC run
serve both packages, whose keys never collide: ``cache/key.py``'s
backend tag).

Layout under ``cache_dir``::

    manifest.jsonl                  append-only op log (put / touch / del)
    objects/<k2>/<key>/<name>       the stored feature files, verbatim

An entry holds the exact bytes the cold extraction wrote, so a hit
materializes byte-identical outputs by copying, never by serializing
again.

Durability: stored files and whole-manifest rewrites go through
``utils.output.atomic_write`` (tmp + ``os.replace``); incremental
manifest updates are single-``write`` appended JSON lines, so a crash
tears at most the last line, which the loader skips; later records win
on replay, so processes appending to one manifest converge.

Integrity: ``fetch_to`` checks every stored file's size before serving
and evicts (never serves) an entry that is missing, truncated or
resized; ``gc(verify=True)`` re-hashes content against the recorded
SHA-256 (``python -m video_features_torch.cache.gc``). Eviction under
``max_bytes`` is LRU by last fetch.

Instances are process-global per directory (:meth:`FeatureCache.get`):
the per-video loop, the packed loop and every extractor of a fused run
that share a ``cache_dir`` share one index, one lock and one set of
counters. No torch at import.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from hashlib import sha256
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from video_features_torch.utils.output import (
    atomic_write, make_path, write_fingerprint,
)

MANIFEST = 'manifest.jsonl'
OBJECTS = 'objects'


def _copy_hashed(src: str, dest: str) -> Tuple[int, str]:
    """Atomically copy ``src`` → ``dest``; returns (size, sha256 hex)."""
    h = sha256()
    size = 0

    def _write(out):
        nonlocal size
        with open(src, 'rb') as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                size += len(chunk)
                out.write(chunk)

    atomic_write(dest, _write)
    return size, h.hexdigest()


class FeatureCache:
    """One cache directory: index, manifest, objects, counters."""

    _instances: Dict[str, 'FeatureCache'] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get(cls, cache_dir: str,
            max_bytes: Optional[int] = None) -> 'FeatureCache':
        """The process-wide instance for ``cache_dir`` (created on first
        use). A non-null ``max_bytes`` updates the shared bound — last
        writer wins, which matches "the most recent config speaks for
        the operator"."""
        norm = os.path.abspath(os.path.expanduser(str(cache_dir)))
        with cls._instances_lock:
            inst = cls._instances.get(norm)
            if inst is None:
                inst = cls._instances[norm] = cls(norm, max_bytes=max_bytes)
            elif max_bytes is not None:
                inst.max_bytes = int(max_bytes)
            return inst

    def __init__(self, cache_dir: str,
                 max_bytes: Optional[int] = None) -> None:
        self.cache_dir = os.path.abspath(os.path.expanduser(str(cache_dir)))
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self._lock = threading.RLock()
        # key → {'files': {output_key: {'name','ext','size','sha256'}},
        #        'last_used': float, 'bytes': int}
        self._index: Dict[str, Dict[str, Any]] = {}
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.corrupt_evicted = 0
        self.bytes_saved = 0
        # eviction subscribers: ``fn(key, corrupt)`` fires for EVERY
        # entry leaving the store (LRU pressure, corrupt eviction,
        # offline GC) — the seam a feature index uses to tombstone rows
        # whose backing object is gone. Callbacks fire AFTER the store
        # lock is released (queued by ``_evict_locked``, drained by
        # ``_notify_evictions``): a subscriber may re-enter the store
        # from its callback, and firing under ``self._lock`` would order
        # cache-lock → subscriber-lock against the subscriber's own
        # subscriber-lock → cache-lock — a deadlock once a second lock
        # (the L2 tier's) joins the graph. The del record still lands
        # before the notice, so a subscriber observing the evict always
        # sees the manifest already agreeing.
        self.on_evict: List[Callable[[str, bool], None]] = []
        # (key, corrupt) notices queued under the lock, fired outside it
        self._pending_evict_notices: List[Tuple[str, bool]] = []
        os.makedirs(os.path.join(self.cache_dir, OBJECTS), exist_ok=True)
        self._load_manifest()

    # -- manifest ------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.cache_dir, MANIFEST)

    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.cache_dir, OBJECTS, key[:2], key)

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
            op, key = rec.get('op'), rec.get('key')
            if not key:
                continue
            if op == 'put' and isinstance(rec.get('files'), dict):
                total = sum(int(f.get('size', 0))
                            for f in rec['files'].values())
                old = self._index.get(key)
                if old is not None:
                    self._total_bytes -= old['bytes']
                self._index[key] = {
                    'files': rec['files'],
                    'last_used': float(rec.get('t', 0.0)),
                    'bytes': total,
                }
                self._total_bytes += total
            elif op == 'touch' and key in self._index:
                self._index[key]['last_used'] = float(rec.get('t', 0.0))
            elif op == 'del':
                old = self._index.pop(key, None)
                if old is not None:
                    self._total_bytes -= old['bytes']

    def _append(self, rec: Dict[str, Any]) -> None:
        """One JSON line, one ``write`` call — a crash tears at most the
        final line, which the loader tolerates."""
        with open(self.manifest_path, 'a', encoding='utf-8') as f:
            f.write(json.dumps(rec, sort_keys=True) + '\n')

    def _rewrite_manifest_locked(self) -> None:
        """Compaction: one put line per live entry (atomic rewrite)."""
        def _write(f):
            for key, e in self._index.items():
                f.write((json.dumps(
                    {'op': 'put', 'key': key, 'files': e['files'],
                     't': e['last_used']}, sort_keys=True) + '\n')
                    .encode('utf-8'))
        atomic_write(self.manifest_path, _write)

    # -- core operations -----------------------------------------------------

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._index

    def entry_exts(self, key: str) -> Optional[Dict[str, str]]:
        """Output key → file extension for a stored entry (None when
        absent) — the fleet tier (``fleet/tier.py``) uses this to
        re-publish a peer-served L2 entry into the local L1 without
        knowing anything about the family that produced it."""
        with self._lock:
            entry = self._index.get(key)
            if entry is None:
                return None
            return {okey: f['ext'] for okey, f in entry['files'].items()}

    def fetch_to(self, key: str, out_root: str, video_path: str,
                 fingerprint: Optional[str] = None) -> bool:
        """Materialize entry ``key`` as ``video_path``'s output files
        under ``out_root`` (byte-identical atomic copies, plus the resume
        fingerprint sidecar when ``fingerprint`` is given). Returns True
        on a served hit; a missing entry counts a miss, and a stored file
        that fails its size check evicts the whole entry (corrupt) and
        counts a miss — the cache never serves bytes it can't vouch for.

        The copies run OUTSIDE the lock (a multi-MB materialization must
        not stall every other thread's lookups behind disk I/O); an
        eviction racing the copy surfaces as an OSError and degrades to
        a miss.
        """
        with self._lock:
            entry = self._index.get(key)
            if entry is None:
                self.misses += 1
                return False
            files = dict(entry['files'])     # snapshot for lock-free I/O
        edir = self._entry_dir(key)
        ok = True
        try:
            for f in files.values():
                if os.path.getsize(os.path.join(edir, f['name'])) \
                        != int(f['size']):
                    ok = False
                    break
            if ok:
                os.makedirs(out_root, exist_ok=True)
                for okey, f in files.items():
                    dest = make_path(out_root, video_path, okey, f['ext'])
                    src = os.path.join(edir, f['name'])

                    def _copy(out, _src=src):
                        with open(_src, 'rb') as fh:
                            shutil.copyfileobj(fh, out)

                    atomic_write(dest, _copy)
        except OSError:
            ok = False
        if not ok:
            with self._lock:
                # evict only if the slot still holds the snapshot we
                # failed on — a concurrent evict/re-put must not be
                # double-punished
                current = self._index.get(key)
                if current is not None and current['files'] == files:
                    self._evict_locked(key, corrupt=True)
                self.misses += 1
            self._notify_evictions()
            return False
        if fingerprint is not None:
            write_fingerprint(out_root, video_path, fingerprint)
        with self._lock:
            current = self._index.get(key)
            now = time.time()
            if current is not None:
                current['last_used'] = now
                self._append({'op': 'touch', 'key': key, 't': now})
            self.hits += 1
            self.bytes_saved += sum(int(f['size']) for f in files.values())
        return True

    def put(self, key: str, files: Dict[str, Tuple[str, str]],
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Publish one video's freshly saved outputs under ``key``.

        ``files`` maps output key → ``(source path, extension)`` — the
        exact files ``action_on_extraction`` just wrote. Idempotent: a
        key already present only refreshes recency (two workers racing a
        publish store identical bytes by construction; durable via a
        touch record so the refresh survives a manifest replay).
        Triggers inline LRU eviction when ``max_bytes`` is exceeded.
        The object copies run OUTSIDE the lock (same reasoning as
        :meth:`fetch_to`); racing writers converge because every copy is
        an atomic replace of identical bytes.
        """
        def _touch_locked():
            now = time.time()
            self._index[key]['last_used'] = now
            self._append({'op': 'touch', 'key': key, 't': now})

        with self._lock:
            if key in self._index:
                _touch_locked()
                return
        edir = self._entry_dir(key)
        os.makedirs(edir, exist_ok=True)
        recorded: Dict[str, Dict[str, Any]] = {}
        total = 0
        for okey, (src, ext) in files.items():
            name = f'{okey}{ext}'
            size, digest = _copy_hashed(src, os.path.join(edir, name))
            recorded[okey] = {'name': name, 'ext': ext, 'size': size,
                              'sha256': digest}
            total += size
        with self._lock:
            if key in self._index:       # lost a racing publish: adopt it
                _touch_locked()
                return
            now = time.time()
            rec: Dict[str, Any] = {'op': 'put', 'key': key,
                                   'files': recorded, 't': now}
            if meta:
                rec['meta'] = meta
            self._append(rec)
            self._index[key] = {'files': recorded, 'last_used': now,
                                'bytes': total}
            self._total_bytes += total
            self.puts += 1
            if self.max_bytes is not None \
                    and self._total_bytes > self.max_bytes:
                self._gc_locked(self.max_bytes, verify=False,
                                compact=False, orphan_sweep=False)
        self._notify_evictions()

    def _evict_locked(self, key: str, corrupt: bool = False) -> int:
        entry = self._index.pop(key, None)
        if entry is None:
            return 0
        self._total_bytes -= entry['bytes']
        shutil.rmtree(self._entry_dir(key), ignore_errors=True)
        self._append({'op': 'del', 'key': key, 't': time.time(),
                      'corrupt': bool(corrupt)})
        if corrupt:
            self.corrupt_evicted += 1
        else:
            self.evictions += 1
        # queue, don't fire: subscribers run outside the lock (see the
        # on_evict declaration) — every public entry point that can
        # reach here drains via _notify_evictions after unlocking
        self._pending_evict_notices.append((key, bool(corrupt)))
        return entry['bytes']

    def _notify_evictions(self) -> None:
        """Drain queued eviction notices and fire the subscribers with
        NO store lock held — a callback may freely call back into this
        cache. Looped because a callback
        re-entering the store can itself queue further evictions."""
        while True:
            with self._lock:
                if not self._pending_evict_notices:
                    return
                notices = self._pending_evict_notices
                self._pending_evict_notices = []
            for key, corrupt in notices:
                for fn in list(self.on_evict):
                    try:
                        fn(key, corrupt)
                    except Exception:
                        log_cache_error(f'on_evict callback for {key}')

    # -- garbage collection --------------------------------------------------

    def gc(self, target_bytes: Optional[int] = None, verify: bool = False,
           compact: bool = True) -> Dict[str, Any]:
        """Integrity sweep + LRU eviction + manifest compaction (the
        offline / ``python -m video_features_torch.cache.gc`` surface).

        ``verify=True`` re-hashes every stored file against its recorded
        SHA-256 (otherwise only existence/size is checked); entries that
        fail either way are evicted as corrupt. Then entries are evicted
        oldest-fetch-first until total size ≤ ``target_bytes`` (default:
        the instance's ``max_bytes``; None = no size pressure). Orphan
        object directories (on disk but not in the manifest — crashed
        writers) are removed if older than a grace window. Returns a
        report dict.

        Cross-process safety: the manifest is RELOADED first, so entries
        other processes appended since this instance loaded are neither
        compacted away nor swept as orphans; the orphan grace window
        covers writers mid-publish during the sweep itself.
        """
        with self._lock:
            self._reload_locked()
            report = self._gc_locked(
                self.max_bytes if target_bytes is None else target_bytes,
                verify=verify, compact=compact, orphan_sweep=True)
        self._notify_evictions()
        return report

    def _reload_locked(self) -> None:
        """Re-replay the manifest from disk (puts/touches/dels appended
        by OTHER processes since construction win over our stale view;
        our own ops are all in the manifest too, so replay converges)."""
        self._index.clear()
        self._total_bytes = 0
        self._load_manifest()

    # object dirs younger than this are never swept as orphans: their
    # writer may simply not have appended its put record yet
    _ORPHAN_GRACE_S = 300.0

    def _gc_locked(self, target_bytes: Optional[int], verify: bool,
                   compact: bool, orphan_sweep: bool) -> Dict[str, Any]:
        report = {'entries_before': len(self._index),
                  'bytes_before': self._total_bytes,
                  'corrupt_evicted': 0, 'lru_evicted': 0,
                  'orphans_removed': 0}
        for key in list(self._index):
            edir = self._entry_dir(key)
            bad = False
            for f in self._index[key]['files'].values():
                src = os.path.join(edir, f['name'])
                try:
                    if os.path.getsize(src) != int(f['size']):
                        bad = True
                    elif verify:
                        h = sha256()
                        with open(src, 'rb') as fh:
                            for chunk in iter(lambda: fh.read(1 << 20), b''):
                                h.update(chunk)
                        bad = h.hexdigest() != f['sha256']
                except OSError:
                    bad = True
                if bad:
                    break
            if bad:
                self._evict_locked(key, corrupt=True)
                report['corrupt_evicted'] += 1
        if target_bytes is not None:
            by_age = sorted(self._index,
                            key=lambda k: self._index[k]['last_used'])
            for key in by_age:
                if self._total_bytes <= target_bytes:
                    break
                self._evict_locked(key)
                report['lru_evicted'] += 1
        # orphan sweep: object dirs no put record owns (crashed writers)
        # — offline GC only (the inline publish-pressure path must never
        # touch dirs another process may be mid-publish on), and gated
        # by an age window for writers racing this very sweep
        if orphan_sweep:
            now = time.time()
            objects = Path(self.cache_dir) / OBJECTS
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
        if compact:
            self._rewrite_manifest_locked()
        report['entries_after'] = len(self._index)
        report['bytes_after'] = self._total_bytes
        return report

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                'dir': self.cache_dir,
                'entries': len(self._index),
                'bytes': self._total_bytes,
                'max_bytes': self.max_bytes,
                'hits': self.hits,
                'misses': self.misses,
                'hit_rate': (self.hits / total) if total else 0.0,
                'puts': self.puts,
                'evictions': self.evictions,
                'corrupt_evicted': self.corrupt_evicted,
                'bytes_saved': self.bytes_saved,
            }


def merge_cache_stats(stats: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """One aggregate view over several caches' :meth:`FeatureCache.stats`
    (the extractors of a fused run may name different cache dirs)."""
    merged: Dict[str, Any] = {
        'caches': 0, 'entries': 0, 'bytes': 0, 'hits': 0, 'misses': 0,
        'puts': 0, 'evictions': 0, 'corrupt_evicted': 0, 'bytes_saved': 0,
        # fleet tier counters (fleet/tier.py): zero on plain caches —
        # always present so the merged view keeps one schema
        'peer_hits': 0, 'l2_publishes': 0,
    }
    for s in stats:
        merged['caches'] += 1
        for k in ('entries', 'bytes', 'hits', 'misses', 'puts',
                  'evictions', 'corrupt_evicted', 'bytes_saved',
                  'peer_hits', 'l2_publishes'):
            merged[k] += s.get(k, 0)
    total = merged['hits'] + merged['misses']
    merged['hit_rate'] = (merged['hits'] / total) if total else 0.0
    return merged


def log_cache_error(what: str) -> None:
    """A cache failure degrades to a miss, never to a failed extraction,
    but it is reported through the structured event log
    (``obs/events.py``): a warning with the traceback, on stderr."""
    import logging

    from video_features_torch.obs.events import event
    event(logging.WARNING,
          f'feature cache {what} failed (continuing uncached)',
          subsystem='cache', exc_info=True)
