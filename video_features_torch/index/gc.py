"""Offline maintenance for the sharded feature index (the port's
counterpart of ``tools/index_gc.py``, with the same report and exit
codes).

The online path (``index/``) only tombstones rows inline — cache
eviction and ``del``-record replay mark rows dead in the manifest but
the shard files keep carrying them, and a row whose backing cache
object vanished WITHOUT a manifest record (foreign deletion, partial
restore) stays live. This tool is the periodic/cron surface beside
``python -m video_features_torch.cache.gc``:

  * ``--orphan-sweep`` drops every row whose cache key the cache no
    longer holds (delete-on-evict coherence for evictions the index
    never heard about);
  * compacts the shards — rewrites them without dead rows and rewrites
    the append-only manifest down to one line per live row.

Safe to run against a live index dir: compaction swaps the manifest
atomically and the store's lock serializes it against a serving
process in the same interpreter; a SEPARATE serving process should be
drained first (same caveat as the cache GC's manifest compaction).

Usage:
    python -m video_features_torch.index.gc --cache-dir \\
        ~/.cache/video_features_torch/features \\
        [--index-dir DIR] [--orphan-sweep] [--no-compact]

Prints one JSON report line on stdout. Exit codes:
    0  clean — no orphaned rows found
    1  orphaned rows were found (and dropped)
    2  usage error (missing/invalid --cache-dir)
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m video_features_torch.index.gc',
        description='Sweep orphaned rows from and compact a feature index.')
    ap.add_argument('--cache-dir', required=True,
                    help='the feature cache the index rows point into '
                         '(cache_dir config key)')
    ap.add_argument('--index-dir', default=None,
                    help='index location (default: <cache-dir>/index)')
    ap.add_argument('--orphan-sweep', action='store_true',
                    help='drop rows whose cache key the cache no longer '
                         'holds (evictions the index never heard about)')
    ap.add_argument('--no-compact', action='store_true',
                    help='skip the shard/manifest rewrite (report/sweep '
                         'only)')
    ns = ap.parse_args(argv)

    cache_dir = os.path.abspath(os.path.expanduser(ns.cache_dir))
    if not os.path.isdir(cache_dir):
        print(f'error: --cache-dir {ns.cache_dir!r} is not a directory',
              file=sys.stderr)
        return 2

    from video_features_torch.index.service import resolve_index_dir
    from video_features_torch.index.shards import IndexStore
    overrides = {'cache_dir': cache_dir}
    if ns.index_dir:
        overrides['index_dir'] = ns.index_dir
    # fresh instances, NOT .get(): the offline tool must read the
    # manifests as they are on disk, not this process's live view
    store = IndexStore(resolve_index_dir(overrides))
    report = {'index_dir': store.index_dir, 'orphans_dropped': 0}
    if ns.orphan_sweep:
        from video_features_torch.cache.store import FeatureCache
        cache = FeatureCache(cache_dir)
        report['orphans_dropped'] = store.orphan_sweep(cache.contains)
    if not ns.no_compact:
        report['compact'] = store.compact()
    report.update(store.stats())
    print(json.dumps(report, sort_keys=True))
    return 1 if report['orphans_dropped'] else 0


if __name__ == '__main__':
    raise SystemExit(main())
