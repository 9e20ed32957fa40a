"""Offline maintenance for the executable store (the port's counterpart
of ``tools/aot_gc.py``, with the same report and exit codes).

The online path (``aot/store.py``) evicts inline only when a publish
pushes the store over ``aot_max_bytes``, and checks only the payloads it
is about to load; this tool is the periodic/cron surface for the rest:

  * compacts the append-only ``manifest.jsonl`` (put/touch/del op log)
    down to one line per live entry;
  * evicts LRU entries down to ``--target-bytes`` (oldest-loaded first:
    libraries of retired sources, toolkits or cards age out);
  * ``--verify`` re-hashes every stored payload against its recorded
    sha256 (not just the size check) and evicts mismatches;
  * removes orphaned object directories (crashed writers).

Safe to run against a live store dir: every change goes through the
store's own atomic operations, and a reader of an evicted entry builds
on the miss.

Usage:
    python -m video_features_torch aot-gc --aot-dir \\
        ~/.cache/video_features_torch/executables \\
        [--target-bytes N] [--verify] [--no-compact]

(or ``python -m video_features_torch.aot.gc ...``). Imports no torch.
Prints one JSON report line on stdout. Exit codes:
    0  clean: no corrupt entries found
    1  corrupt or truncated entries were found (and evicted)
    2  usage error (missing/invalid --aot-dir, bad --target-bytes)
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m video_features_torch aot-gc',
        description='Verify, bound and compact an executable store.')
    ap.add_argument('--aot-dir', required=True,
                    help='the executable store directory (aot_dir '
                         'config key)')
    ap.add_argument('--target-bytes', type=int, default=None,
                    help='evict LRU entries until total stored bytes <= N '
                         '(default: no size pressure)')
    ap.add_argument('--verify', action='store_true',
                    help='re-hash every stored payload against its '
                         'recorded sha256 (slower; catches silent bit '
                         'rot the size check cannot)')
    ap.add_argument('--no-compact', action='store_true',
                    help='skip the manifest rewrite (report/evict only)')
    ns = ap.parse_args(argv)

    aot_dir = os.path.abspath(os.path.expanduser(ns.aot_dir))
    if not os.path.isdir(aot_dir):
        print(f'error: --aot-dir {ns.aot_dir!r} is not a directory',
              file=sys.stderr)
        return 2
    if ns.target_bytes is not None and ns.target_bytes < 0:
        print('error: --target-bytes must be >= 0', file=sys.stderr)
        return 2

    # a fresh instance, NOT ExecStore.get: the offline tool must read
    # the manifest as it is on disk, not this process's live view
    from video_features_torch.aot.store import ExecStore
    store = ExecStore(aot_dir)
    report = store.gc(target_bytes=ns.target_bytes, verify=ns.verify,
                      compact=not ns.no_compact)
    report['aot_dir'] = aot_dir
    report['verified'] = bool(ns.verify)
    print(json.dumps(report, sort_keys=True))
    return 1 if report['corrupt_evicted'] else 0


if __name__ == '__main__':
    raise SystemExit(main())
