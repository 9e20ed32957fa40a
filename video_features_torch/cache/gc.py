"""Offline maintenance of a feature cache directory (the port's
counterpart of ``tools/cache_gc.py``, with the same report and exit
codes).

The online path only evicts when a publish pushes the store over
``cache_max_bytes`` and only size-checks the entries it serves; this
does the rest:

  * compacts ``manifest.jsonl`` to one line per live entry;
  * evicts LRU entries down to ``--target-bytes``;
  * ``--verify`` re-hashes every stored file against its recorded
    SHA-256 and evicts corrupt entries;
  * removes orphaned object directories (crashed writers).

Safe on a live directory: every change goes through the store's atomic
operations, and a reader finds an evicted entry as a miss.

Usage:
    python -m video_features_torch.cache.gc --cache-dir \\
        ~/.cache/video_features_torch/features \\
        [--target-bytes 50000000000] [--verify] [--no-compact]

Prints one JSON report line on stdout. Exit codes:
    0  clean: no corrupt entries found
    1  corrupt or truncated entries were found (and evicted)
    2  usage error (missing or invalid --cache-dir, bad --target-bytes)
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m video_features_torch.cache.gc',
        description='Compact, verify and bound a feature cache directory.')
    ap.add_argument('--cache-dir', required=True,
                    help='the feature cache directory (cache_dir config key)')
    ap.add_argument('--target-bytes', type=int, default=None,
                    help='evict LRU entries until total stored bytes <= N '
                         '(default: no size pressure)')
    ap.add_argument('--verify', action='store_true',
                    help='re-hash every stored file against its recorded '
                         'SHA-256 (slower; catches bit rot the size check '
                         'cannot)')
    ap.add_argument('--no-compact', action='store_true',
                    help='skip the manifest rewrite (report/evict only)')
    ns = ap.parse_args(argv)

    cache_dir = os.path.abspath(os.path.expanduser(ns.cache_dir))
    if not os.path.isdir(cache_dir):
        print(f'error: --cache-dir {ns.cache_dir!r} is not a directory',
              file=sys.stderr)
        return 2
    if ns.target_bytes is not None and ns.target_bytes < 0:
        print('error: --target-bytes must be >= 0', file=sys.stderr)
        return 2

    # a fresh instance, not FeatureCache.get: the manifest as it is on
    # disk, not this process's live view
    from video_features_torch.cache.store import FeatureCache
    cache = FeatureCache(cache_dir)
    report = cache.gc(target_bytes=ns.target_bytes, verify=ns.verify,
                      compact=not ns.no_compact)
    report['cache_dir'] = cache_dir
    report['verified'] = bool(ns.verify)
    # vft-lint: ok=stdout-purity — the command's one JSON report
    # line (the JAX package's tools/cache_gc.py prints it alike)
    print(json.dumps(report, sort_keys=True))
    return 1 if report['corrupt_evicted'] else 0


if __name__ == '__main__':
    raise SystemExit(main())
