"""Embedding shards + the append-only row manifest (the port's copy of
``video_features_tpu/index/shards.py``: the same directory layout, records
and bytes).

One :class:`IndexStore` owns one index directory:

    <index_dir>/
      manifest.jsonl                  # add / del / cursor op log
      shards/<family>_<dim>/shard_00000.npy   # (rows<=shard_rows, dim) f32

Vectors live in the shard ``.npy`` files (unpadded, row-major,
L2-normalized by the ingest path so scores are cosine similarities);
*identity* lives in the manifest: one ``add`` record per row mapping
(shard, row) -> (video name, video content hash, window t_ms, cache
key). A ``del`` record tombstones every row of one cache key — the
delete-on-evict coherence hook cache GC fires through
``FeatureCache.on_evict`` — and a ``cursor`` record persists how far
the ingest worker has tailed its source (a byte offset into the cache
manifest), so a restart resumes instead of re-reading.

Shard files are bounded (``shard_rows``) and rewritten atomically on
append (tmp + rename, same discipline as every other artifact in the
tree); ``compact()`` drops tombstoned rows from both the shard files
and the manifest in one atomic pass. Replay is torn-tail tolerant and
self-healing: a manifest row pointing past the end of a (crashed,
short) shard file is dropped, never served.

Everything here is numpy + stdlib: importing the store pulls in neither
torch nor jax (the offline GC tool and the ingest thread never touch a
device).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from video_features_torch.utils.output import (
    CorruptOutputError, atomic_write, load_numpy,
)

# manifest schema version; bump on incompatible record changes
MANIFEST_VERSION = 1

_GroupKey = Tuple[str, int]          # (family, dim)


def _l2_normalize(vectors: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Row-wise L2 normalization (float32): with both the indexed rows
    and the query normalized, the query program's matmul scores ARE
    cosine similarities, and a vector's own row is its argmax — the
    property the recall self-check and query-by-video acceptance pin."""
    v = np.asarray(vectors, dtype=np.float32)
    if v.ndim != 2:
        raise ValueError(f'expected (rows, dim) vectors, got {v.shape}')
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    return v / np.maximum(norms, eps)


class _Group:
    """One (family, dim) shard group: parallel vector/meta storage."""

    __slots__ = ('family', 'dim', 'shards', 'metas')

    def __init__(self, family: str, dim: int) -> None:
        self.family = family
        self.dim = dim
        # shards[i] is a (rows_i, dim) float32 array; metas[i][j] is the
        # row's identity dict, or None once tombstoned
        self.shards: List[np.ndarray] = []
        self.metas: List[List[Optional[Dict[str, Any]]]] = []

    def rows_live(self) -> int:
        return sum(1 for rows in self.metas for m in rows if m is not None)

    def rows_dead(self) -> int:
        return sum(1 for rows in self.metas for m in rows if m is None)


class IndexStore:
    """Embedding shards + row manifest for one index directory.

    Thread-safe (one RLock — ingest appends, queries read, GC compacts);
    process-global via :meth:`get` so the serve daemon and its loopback
    commands share one in-memory view, mirroring ``FeatureCache.get``.
    """

    _instances: Dict[str, 'IndexStore'] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get(cls, index_dir: str, shard_rows: int = 1024) -> 'IndexStore':
        index_dir = os.path.abspath(os.path.expanduser(index_dir))
        with cls._instances_lock:
            inst = cls._instances.get(index_dir)
            if inst is None:
                inst = cls(index_dir, shard_rows=shard_rows)
                cls._instances[index_dir] = inst
            return inst

    def __init__(self, index_dir: str, shard_rows: int = 1024) -> None:
        if shard_rows < 1:
            raise ValueError(f'shard_rows must be >= 1, got {shard_rows}')
        self.index_dir = os.path.abspath(os.path.expanduser(index_dir))
        self.shard_rows = int(shard_rows)
        self._lock = threading.RLock()
        self._groups: Dict[_GroupKey, _Group] = {}
        # cache key -> [(gkey, shard_i, row_j)] for delete-on-evict
        self._rows_by_key: Dict[str, List[Tuple[_GroupKey, int, int]]] = {}
        self._cursors: Dict[str, int] = {}
        self.rows_added = 0
        self.rows_dropped = 0
        os.makedirs(os.path.join(self.index_dir, 'shards'), exist_ok=True)
        self._load_manifest()

    # -- paths ---------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.index_dir, 'manifest.jsonl')

    def _group_dir(self, gkey: _GroupKey) -> str:
        family, dim = gkey
        return os.path.join(self.index_dir, 'shards', f'{family}_{dim}')

    def _shard_path(self, gkey: _GroupKey, shard_i: int) -> str:
        return os.path.join(self._group_dir(gkey), f'shard_{shard_i:05d}.npy')

    # -- manifest ------------------------------------------------------------

    def _load_manifest(self) -> None:
        """Replay the op log, then load shard arrays from disk. A torn
        tail (crashed writer) stops the replay at the last whole line; a
        row whose shard file is missing or shorter than its row index is
        dropped (the vectors are the ground truth — identity without a
        vector is unservable either way)."""
        adds: Dict[_GroupKey, Dict[int, Dict[int, Dict[str, Any]]]] = {}
        try:
            with open(self.manifest_path, 'rb') as f:
                raw = f.read()
        except FileNotFoundError:
            return
        for line in raw.split(b'\n'):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                op = rec['op']
            except (ValueError, KeyError, UnicodeDecodeError):
                continue                 # torn/foreign line: skip, keep going
            if op == 'add':
                try:
                    gkey = (str(rec['family']), int(rec['dim']))
                    shard_i, row_j = int(rec['shard']), int(rec['row'])
                    meta = {'video': rec.get('video'),
                            'video_sha256': rec.get('video_sha256'),
                            't_ms': rec.get('t_ms'),
                            'key': rec['key']}
                except (KeyError, TypeError, ValueError):
                    continue
                adds.setdefault(gkey, {}).setdefault(
                    shard_i, {})[row_j] = meta
            elif op == 'del':
                key = rec.get('key')
                for gkey, shards in adds.items():
                    for rows in shards.values():
                        for row_j, meta in list(rows.items()):
                            if meta is not None and meta['key'] == key:
                                rows[row_j] = None
            elif op == 'cursor':
                try:
                    self._cursors[str(rec['source'])] = int(rec['offset'])
                except (KeyError, TypeError, ValueError):
                    continue
        for gkey, shards in sorted(adds.items()):
            group = _Group(*gkey)
            for shard_i in sorted(shards):
                rows = shards[shard_i]
                n_rows = max(rows) + 1 if rows else 0
                try:
                    arr = load_numpy(self._shard_path(gkey, shard_i))
                    arr = np.asarray(arr, dtype=np.float32)
                    if arr.ndim != 2 or arr.shape[1] != gkey[1]:
                        raise CorruptOutputError(
                            f'shard shape {arr.shape} != (*, {gkey[1]})')
                except (OSError, CorruptOutputError, ValueError):
                    arr = np.zeros((0, gkey[1]), dtype=np.float32)
                if arr.shape[0] < n_rows:
                    # crashed mid-publish: manifest rows past the file's
                    # end never got their vectors — drop them
                    for row_j in list(rows):
                        if row_j >= arr.shape[0]:
                            rows[row_j] = None
                    n_rows = arr.shape[0]
                metas: List[Optional[Dict[str, Any]]] = [None] * n_rows
                for row_j, meta in rows.items():
                    if row_j < n_rows:
                        metas[row_j] = meta
                while len(group.shards) < shard_i:
                    # a gap (older shard fully compacted away under a
                    # manifest that still numbers later ones): keep
                    # indices aligned with an empty placeholder
                    group.shards.append(
                        np.zeros((0, gkey[1]), dtype=np.float32))
                    group.metas.append([])
                group.shards.append(arr[:n_rows] if n_rows else
                                    np.zeros((0, gkey[1]), dtype=np.float32))
                group.metas.append(metas)
            self._groups[gkey] = group
        self._reindex_keys_locked()

    def _reindex_keys_locked(self) -> None:
        self._rows_by_key = {}
        for gkey, group in self._groups.items():
            for shard_i, metas in enumerate(group.metas):
                for row_j, meta in enumerate(metas):
                    if meta is not None:
                        self._rows_by_key.setdefault(meta['key'], []).append(
                            (gkey, shard_i, row_j))

    def _append(self, recs: Iterable[Dict[str, Any]]) -> None:
        payload = ''.join(json.dumps(r, sort_keys=True) + '\n' for r in recs)
        if not payload:
            return
        with open(self.manifest_path, 'a', encoding='utf-8') as f:
            f.write(payload)
            f.flush()

    def _rewrite_manifest_locked(self) -> None:
        """Atomic one-line-per-live-row manifest (plus cursors)."""
        recs: List[Dict[str, Any]] = []
        for gkey, group in sorted(self._groups.items()):
            for shard_i, metas in enumerate(group.metas):
                for row_j, meta in enumerate(metas):
                    if meta is not None:
                        recs.append({'op': 'add', 'family': gkey[0],
                                     'dim': gkey[1], 'shard': shard_i,
                                     'row': row_j, **meta})
        for source, offset in sorted(self._cursors.items()):
            recs.append({'op': 'cursor', 'source': source, 'offset': offset})

        def _write(f):
            for r in recs:
                f.write((json.dumps(r, sort_keys=True) + '\n')
                        .encode('utf-8'))

        atomic_write(self.manifest_path, _write)

    def _write_shard_locked(self, gkey: _GroupKey, shard_i: int) -> None:
        os.makedirs(self._group_dir(gkey), exist_ok=True)
        arr = self._groups[gkey].shards[shard_i]
        atomic_write(self._shard_path(gkey, shard_i),
                     lambda f: np.save(f, arr, allow_pickle=False))

    # -- writes --------------------------------------------------------------

    def add_rows(self, family: str, vectors: np.ndarray,
                 metas: List[Dict[str, Any]]) -> int:
        """Fold ``vectors`` (one per meta; normalized here) into the
        (family, dim) group, appending to the tail shard until it hits
        ``shard_rows`` and opening a new one after. Each meta needs at
        least ``key`` (the backing cache key); ``video`` /
        ``video_sha256`` / ``t_ms`` ride along as the search result's
        identity. Returns rows added. Re-adding a cache key already
        live in the index is the ingest replay case: dropped here so
        cursor resets stay idempotent."""
        vectors = _l2_normalize(vectors)
        if len(metas) != vectors.shape[0]:
            raise ValueError(f'{vectors.shape[0]} vectors for '
                             f'{len(metas)} metas')
        if not len(metas):
            return 0
        dim = int(vectors.shape[1])
        gkey = (str(family), dim)
        with self._lock:
            keys = {m['key'] for m in metas}
            live = {k for k in keys if any(
                loc[0] == gkey for loc in self._rows_by_key.get(k, ()))}
            take = [i for i, m in enumerate(metas) if m['key'] not in live]
            if not take:
                return 0
            group = self._groups.get(gkey)
            if group is None:
                group = self._groups.setdefault(gkey, _Group(family, dim))
            recs: List[Dict[str, Any]] = []
            # rows gathered per touched shard, each shard grown by one
            # concatenation (the same array as one concatenation per row)
            pending: Dict[int, List[np.ndarray]] = {}
            for i in take:
                fill = group.shards[-1].shape[0] + len(
                    pending.get(len(group.shards) - 1, ())) \
                    if group.shards else 0
                if not group.shards or fill >= self.shard_rows:
                    group.shards.append(np.zeros((0, dim), dtype=np.float32))
                    group.metas.append([])
                    fill = 0
                shard_i = len(group.shards) - 1
                row_j = fill
                pending.setdefault(shard_i, []).append(vectors[i:i + 1])
                meta = {'video': metas[i].get('video'),
                        'video_sha256': metas[i].get('video_sha256'),
                        't_ms': metas[i].get('t_ms'),
                        'key': metas[i]['key']}
                group.metas[shard_i].append(meta)
                self._rows_by_key.setdefault(meta['key'], []).append(
                    (gkey, shard_i, row_j))
                recs.append({'op': 'add', 'family': family, 'dim': dim,
                             'shard': shard_i, 'row': row_j, **meta})
            touched = list(pending)
            for shard_i, rows in pending.items():
                group.shards[shard_i] = np.concatenate(
                    [group.shards[shard_i], *rows], axis=0)
            # vectors first, then identity: replay drops manifest rows
            # the shard file doesn't back, never the other way around
            for shard_i in touched:
                self._write_shard_locked(gkey, shard_i)
            self._append(recs)
            self.rows_added += len(take)
            return len(take)

    def drop_key(self, key: str) -> int:
        """Tombstone every row backed by ``key`` (the delete-on-evict
        hook). Idempotent; returns rows dropped."""
        with self._lock:
            locs = self._rows_by_key.pop(key, None)
            if not locs:
                return 0
            for gkey, shard_i, row_j in locs:
                self._groups[gkey].metas[shard_i][row_j] = None
            self._append([{'op': 'del', 'key': key}])
            self.rows_dropped += len(locs)
            return len(locs)

    def has_key(self, key: str) -> bool:
        with self._lock:
            return bool(self._rows_by_key.get(key))

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._rows_by_key)

    # -- cursors -------------------------------------------------------------

    def cursor(self, source: str) -> int:
        with self._lock:
            return self._cursors.get(source, 0)

    def set_cursor(self, source: str, offset: int) -> None:
        with self._lock:
            self._cursors[str(source)] = int(offset)
            self._append([{'op': 'cursor', 'source': str(source),
                           'offset': int(offset)}])

    # -- reads (query path) --------------------------------------------------

    def families(self) -> List[str]:
        with self._lock:
            return sorted({gkey[0] for gkey in self._groups})

    def group_for(self, family: str,
                  dim: Optional[int] = None) -> Optional[_GroupKey]:
        """Resolve (family, dim); with ``dim`` None the family must map
        to exactly one dim (the common case — one extractor geometry)."""
        with self._lock:
            dims = sorted(g[1] for g in self._groups if g[0] == family)
        if dim is not None:
            return (family, int(dim)) if (family, int(dim)) in self._groups \
                else None
        if len(dims) == 1:
            return (family, dims[0])
        return None

    def shard_views(self, gkey: _GroupKey) -> List[
            Tuple[np.ndarray, np.ndarray, List[Optional[Dict[str, Any]]]]]:
        """Per-shard (vectors, alive_mask float32, metas) snapshots for
        the query program; arrays are copies, safe outside the lock."""
        with self._lock:
            group = self._groups.get(gkey)
            if group is None:
                return []
            out = []
            for arr, metas in zip(group.shards, group.metas):
                mask = np.array([1.0 if m is not None else 0.0
                                 for m in metas], dtype=np.float32)
                out.append((arr.copy(), mask, list(metas)))
            return out

    def rows_for(self, family: str,
                 video_sha256: str) -> Tuple[np.ndarray,
                                             List[Dict[str, Any]]]:
        """Live (vectors, metas) for one video's rows in one family —
        the query-by-video path reads its query vectors straight from
        the index once ingest has folded the extraction in."""
        with self._lock:
            vecs: List[np.ndarray] = []
            metas: List[Dict[str, Any]] = []
            for gkey, group in self._groups.items():
                if gkey[0] != family:
                    continue
                for arr, rows in zip(group.shards, group.metas):
                    for row_j, meta in enumerate(rows):
                        if (meta is not None
                                and meta.get('video_sha256') == video_sha256):
                            vecs.append(arr[row_j])
                            metas.append(dict(meta))
        if not vecs:
            return np.zeros((0, 0), dtype=np.float32), []
        return np.stack(vecs).astype(np.float32), metas

    # -- maintenance ---------------------------------------------------------

    def compact(self) -> Dict[str, Any]:
        """Drop tombstoned rows from shard files, renumber, and rewrite
        the manifest to one line per live row. Safe to run against a
        live index: everything happens under the store lock with atomic
        file replacement."""
        with self._lock:
            rows_dropped = 0
            shards_before = shards_after = 0
            for gkey in sorted(self._groups):
                group = self._groups[gkey]
                shards_before += len(group.shards)
                pairs = [(arr[row_j], meta)
                         for arr, rows in zip(group.shards, group.metas)
                         for row_j, meta in enumerate(rows)]
                live = [(v, m) for v, m in pairs if m is not None]
                rows_dropped += len(pairs) - len(live)
                old_n = len(group.shards)
                group.shards, group.metas = [], []
                for i in range(0, len(live), self.shard_rows):
                    chunk = live[i:i + self.shard_rows]
                    group.shards.append(
                        np.stack([v for v, _ in chunk]).astype(np.float32))
                    group.metas.append([m for _, m in chunk])
                shards_after += len(group.shards)
                for shard_i in range(len(group.shards)):
                    self._write_shard_locked(gkey, shard_i)
                for shard_i in range(len(group.shards), old_n):
                    try:
                        os.remove(self._shard_path(gkey, shard_i))
                    except OSError:
                        pass
            for gkey in [g for g, grp in self._groups.items()
                         if not grp.shards]:
                del self._groups[gkey]
            self._reindex_keys_locked()
            self._rewrite_manifest_locked()
            return {'rows_dropped': int(rows_dropped),
                    'shards_before': int(shards_before),
                    'shards_after': int(shards_after),
                    'rows_live': self.stats()['rows_live']}

    def orphan_sweep(self, contains: Callable[[str], bool]) -> int:
        """Drop every row whose backing cache key ``contains`` denies —
        the offline repair for evictions that happened while no ingest
        worker (and so no ``on_evict`` subscriber) was alive. Returns
        rows dropped."""
        dropped = 0
        for key in self.keys():
            try:
                present = bool(contains(key))
            except Exception:
                # vft-lint: ok=swallowed-exception — a probe failure is
                # NOT evidence of eviction; keeping the row is the safe
                # side (the next sweep retries), dropping it loses data
                present = True
            if not present:
                dropped += self.drop_key(key)
        return dropped

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            rows_live = sum(g.rows_live() for g in self._groups.values())
            rows_dead = sum(g.rows_dead() for g in self._groups.values())
            shards = sum(len(g.shards) for g in self._groups.values())
            families = {}
            for (family, dim), group in sorted(self._groups.items()):
                fam = families.setdefault(family, {
                    'dims': [], 'rows_live': 0, 'shards': 0})
                fam['dims'].append(dim)
                fam['rows_live'] += group.rows_live()
                fam['shards'] += len(group.shards)
            return {'dir': self.index_dir,
                    'shard_rows': self.shard_rows,
                    'rows_live': int(rows_live),
                    'rows_dead': int(rows_dead),
                    'shards': int(shards),
                    'rows_added': int(self.rows_added),
                    'rows_dropped': int(self.rows_dropped),
                    'families': families}
