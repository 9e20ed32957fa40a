"""Exact top-k over the index shards (the port's counterpart of
``video_features_tpu/index/search.py``).

One function serves every query: ``topk(shard, queries, row_mask)`` — a
matmul of L2-normalized queries against one shard block, dead and
padding rows masked to ``-inf``, then the top ``k``. Exact search, by
construction: recall@k is 1.0.

The JAX package runs this as one jitted program (``queries @ shard.T``,
then ``lax.top_k``) reached through its executable store; no Pallas
kernel is involved, so the port runs the same three library calls
(``torch.matmul``, ``torch.where``, ``torch.sort``) on the service's
device. Two points keep its answers the JAX package's:

  * **ties**: ``lax.top_k`` returns the lower row first among equal
    scores, and ``torch.topk`` on CUDA promises no order, so the port
    takes the first ``k`` of a stable descending sort. Exact ties are
    real: one video extracted under two configs is two cache keys with
    identical rows;
  * **precision**: the scores are fp32. The matmul runs inside
    ``precision_scope('highest')``, so TF32 never decides a ranking.

Geometries are quantized as in the JAX package: every shard is padded to
``shard_rows`` rows (mask 0 on padding) and queries to ``query_block``,
each shard yields its top ``k_run = min(k_max, rows_pad)``, and the hits
merge on the host in shard order with a stable sort by score. The
queries reach no compiled code of the port's (``torch.topk`` and a
matmul, precompiled), so there is nothing for the executable store to
hold: ``programs_loaded`` and ``programs_compiled`` stay 0 and
:meth:`QueryEngine.prewarm` answers ``'jit'``, as the JAX package does
without a store, even with ``aot_enabled``.

torch is imported inside the functions that run a query: ``index.shards``,
the offline GC tool and the CLI's other actions import without it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# the canonical geometry: what ``serve_prewarm: [index]`` warms. 1024 x
# 512 is one full shard of clip-sized embeddings; 8 queries is the
# query_block default; K=10 feeds recall@10.
INDEX_ROWS = 1024
INDEX_DIM = 512
INDEX_QUERIES = 8
INDEX_K = 10


def topk(shard, queries, row_mask, k: int):
    """``(values, rows)`` of the ``k`` best scores of each query against
    one shard: ``queries @ shard.T`` in fp32, rows whose mask is 0 at
    ``-inf``, the lower row first among equal scores (``lax.top_k``'s
    order). Torch tensors on one device in, the same out."""
    import torch

    from video_features_torch.utils.device import precision_scope
    with precision_scope('highest'):
        scores = torch.matmul(queries, shard.T)
    scores = torch.where(row_mask[None, :] > 0, scores,
                         torch.full_like(scores, float('-inf')))
    values, rows = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], rows[:, :k]


class QueryEngine:
    """Runtime dispatch: pad to the quantized geometry, run :func:`topk`
    on ``device``, merge per-query hits across shards on the host."""

    def __init__(self, store, device='cuda',
                 query_block: int = INDEX_QUERIES,
                 k_max: int = INDEX_K) -> None:
        from video_features_torch.utils.device import resolve_device
        self.store = store                      # IndexStore
        self.device = resolve_device(device)
        self.query_block = max(1, int(query_block))
        self.k_max = max(1, int(k_max))
        self._lock = threading.Lock()
        self.programs_loaded = 0
        self.programs_compiled = 0
        self.queries_total = 0

    def prewarm(self, rows: int = INDEX_ROWS, dim: int = INDEX_DIM) -> str:
        """Run the canonical geometry once (the library's first-call
        set-up happens here, not in the first query); ``'jit'``: the port
        has no executable store."""
        self._run(np.zeros((rows, dim), np.float32),
                  np.zeros((self.query_block, dim), np.float32),
                  np.ones((rows,), np.float32), min(self.k_max, rows))
        return 'jit'

    def _run(self, shard: np.ndarray, queries: np.ndarray,
             mask: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        import torch
        dev = self.device
        with torch.inference_mode():
            values, rows = topk(torch.from_numpy(shard).to(dev),
                                torch.from_numpy(queries).to(dev),
                                torch.from_numpy(mask).to(dev), k)
            return values.cpu().numpy(), rows.cpu().numpy()

    def search(self, family: str, queries: np.ndarray, k: int,
               dim: Optional[int] = None,
               ) -> Tuple[List[List[Dict[str, Any]]], float]:
        """Exact top-k for each query vector against one family's
        shards. Returns (per-query hit lists, wall seconds); each hit
        is ``{score, video, video_sha256, t_ms, key, family}``. Raises
        ValueError when the family has no (unambiguous) shard group or
        the query dim doesn't match."""
        t0 = time.perf_counter()
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or not queries.shape[0]:
            raise ValueError(f'expected (n, dim) queries, '
                             f'got shape {queries.shape}')
        gkey = self.store.group_for(family, dim=dim)
        if gkey is None:
            dims = sorted(g[1] for g in getattr(self.store, '_groups', {})
                          if g[0] == family)
            raise ValueError(
                f'no indexed shards for family {family!r}'
                + (f' (ambiguous dims {dims}; pass dim=)' if len(dims) > 1
                   else ''))
        if queries.shape[1] != gkey[1]:
            raise ValueError(f'query dim {queries.shape[1]} != indexed '
                             f'dim {gkey[1]} for family {family!r}')
        k = max(1, min(int(k), self.k_max))
        rows_pad = max(self.store.shard_rows, 1)
        k_run = min(self.k_max, rows_pad)
        # normalize queries so scores are cosine similarities
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        queries = queries / np.maximum(norms, 1e-12)

        n_real = queries.shape[0]
        hits: List[List[Dict[str, Any]]] = [[] for _ in range(n_real)]
        views = self.store.shard_views(gkey)
        for q0 in range(0, n_real, self.query_block):
            qblock = queries[q0:q0 + self.query_block]
            q_pad = np.zeros((self.query_block, gkey[1]), dtype=np.float32)
            q_pad[:qblock.shape[0]] = qblock
            for arr, mask, metas in views:
                if arr.shape[0] == 0:
                    continue
                shard_pad = np.zeros((rows_pad, gkey[1]), dtype=np.float32)
                shard_pad[:arr.shape[0]] = arr
                mask_pad = np.zeros((rows_pad,), dtype=np.float32)
                mask_pad[:mask.shape[0]] = mask
                values, idx = self._run(shard_pad, q_pad, mask_pad, k_run)
                for qi in range(qblock.shape[0]):
                    for score, row_j in zip(values[qi], idx[qi]):
                        if not np.isfinite(score):
                            continue
                        meta = metas[row_j] if row_j < len(metas) else None
                        if meta is None:
                            continue
                        hits[q0 + qi].append(
                            {'score': float(score), 'family': family,
                             **meta})
        for lst in hits:
            lst.sort(key=lambda h: -h['score'])
            del lst[k:]
        with self._lock:
            self.queries_total += n_real
        return hits, time.perf_counter() - t0

    @staticmethod
    def merge_hits(per_query: List[List[Dict[str, Any]]],
                   k: int) -> List[Dict[str, Any]]:
        """Fold per-query hit lists into one ranking: max score per
        distinct (key, t_ms) row — the query-by-video response shape."""
        best: Dict[Tuple[Any, Any], Dict[str, Any]] = {}
        for lst in per_query:
            for h in lst:
                ident = (h.get('key'), h.get('t_ms'))
                if ident not in best or h['score'] > best[ident]['score']:
                    best[ident] = h
        out = sorted(best.values(), key=lambda h: -h['score'])
        return out[:max(1, int(k))]
