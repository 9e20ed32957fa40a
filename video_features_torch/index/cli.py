"""Offline feature-index surface: ``python -m video_features_torch index``
(the port's copy of ``video_features_tpu/index/cli.py``: the same flags
and the same single JSON report, plus ``--device``).

The serve-side ingest worker and ``POST /v1/search`` need a resident
daemon; this entry point needs only the directories. It folds the cache
manifest with the SAME record/cursor semantics (``service.fold_manifest``)
and runs the SAME exact top-k (``search.QueryEngine``), so an offline
query and a served query over one index answer identically.

``--device`` (default ``cuda``) is where a query runs: the JAX CLI runs
on JAX's default backend, but a port entry point never falls back to the
CPU, so a query on a host without a GPU raises naming ``device`` unless
``--device cpu`` is given. Ingest, compaction and status never touch a
device and never import torch.

Actions compose in one invocation (ingest → compact → query → status):

  python -m video_features_torch index --cache-dir C --ingest
  python -m video_features_torch index --cache-dir C \
      --query q.npy --family resnet --k 10
  python -m video_features_torch index --cache-dir C --status

One JSON report on stdout (machine-parseable, like the gc tools);
``--manifest-out`` additionally writes a run manifest whose ``index``
section carries the same numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from video_features_torch.index.shards import IndexStore


def index_main(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog='python -m video_features_torch index',
        description='offline feature-index maintenance and queries')
    p.add_argument('--cache-dir', required=True,
                   help='the content-addressed feature cache to index')
    p.add_argument('--index-dir', default=None,
                   help='index location (default: <cache-dir>/index)')
    p.add_argument('--shard-rows', type=int, default=1024,
                   help='rows per embedding shard (index_shard_rows)')
    p.add_argument('--ingest', action='store_true',
                   help='fold new cache-manifest records into the index')
    p.add_argument('--compact', action='store_true',
                   help='rewrite shards without tombstoned rows')
    p.add_argument('--query', default=None, metavar='VEC_NPY',
                   help='.npy query vector (or 2D batch) for exact top-k')
    p.add_argument('--family', default=None,
                   help='feature family to query (required with --query '
                        'when the index holds more than one)')
    p.add_argument('--k', type=int, default=10,
                   help='hits per query (default 10)')
    p.add_argument('--status', action='store_true',
                   help='report index stats (the default action)')
    p.add_argument('--manifest-out', default=None,
                   help='also write a run manifest with an index section')
    p.add_argument('--device', default='cuda',
                   help="where a query runs: 'cuda', 'cuda:N' or 'cpu' "
                        "(default cuda; no fallback to the CPU)")
    args = p.parse_args(argv)
    if args.query is not None:
        # before any action: a query that cannot run must not follow an
        # ingest or a compaction it would leave unreported
        from video_features_torch.utils.device import resolve_device
        resolve_device(args.device)

    store = IndexStore.get(
        _index_dir(args.cache_dir, args.index_dir),
        shard_rows=args.shard_rows)
    report: Dict[str, Any] = {'ok': True}

    if args.ingest:
        # a FRESH cache instance: an offline tool reads the disk state
        # as-is, never the (possibly stale) in-process singleton view
        from video_features_torch.cache.store import FeatureCache
        from video_features_torch.index.service import fold_manifest
        report['ingest'] = fold_manifest(
            store, FeatureCache(args.cache_dir))
    if args.compact:
        report['compact'] = store.compact()
    if args.query is not None:
        try:
            report['query'] = _run_query(store, args)
        except (OSError, ValueError) as e:
            report['ok'] = False
            report['error'] = str(e)
    report['index'] = store.stats()

    if args.manifest_out:
        from video_features_torch.obs.manifest import RunManifest
        man = RunManifest({'cache_dir': args.cache_dir})
        man.note_index(report['index'])
        man.write(args.manifest_out)
        report['manifest_out'] = args.manifest_out

    print(json.dumps(report, sort_keys=True), file=sys.stdout)
    return 0 if report['ok'] else 1


def _index_dir(cache_dir: str, index_dir: 'str | None') -> str:
    from video_features_torch.index.service import resolve_index_dir
    overrides: Dict[str, Any] = {'cache_dir': cache_dir}
    if index_dir:
        overrides['index_dir'] = index_dir
    return resolve_index_dir(overrides)


def _run_query(store: IndexStore, args) -> Dict[str, Any]:
    import numpy as np

    from video_features_torch.index.search import QueryEngine
    from video_features_torch.utils.output import load_numpy
    family = args.family
    if family is None:
        families = store.families()
        if len(families) != 1:
            raise ValueError(
                '--family is required: the index holds '
                f'{sorted(families) if families else "no"} families')
        family = next(iter(families))
    queries = np.asarray(load_numpy(args.query), dtype=np.float32)
    engine = QueryEngine(store, device=args.device)
    per_query, wall_s = engine.search(family, queries, args.k)
    merged = per_query[0] if len(per_query) == 1 \
        else QueryEngine.merge_hits(per_query, args.k)
    return {'family': family, 'k': args.k,
            'queries': int(np.atleast_2d(queries).shape[0]),
            'hits': merged, 'wall_s': round(wall_s, 6)}
