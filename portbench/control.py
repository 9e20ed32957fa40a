"""Readings for the correctness limits, on the card: the cell's checked
numbers on several seeds, with the program as configured and with the
control, the program's own lane one precision below the configured one
(``--lane tensorfloat32``: one TF32 pass where the cell states fp32 or
3xTF32). All seeds run in this one process, each a short window at the
cell's own load:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--lane tensorfloat32]

Prints one JSON line per seed: {"seed", "lane", "correct", "checks"}.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--lane', default=None,
                    help='a precision value in place of the cell\'s')
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('control: no CUDA device', file=sys.stderr)
        return 3
    from portbench.harness import drivers, spec
    cell = spec.Cell(spec.benchmark(), a.workload)
    overrides = {'precision': a.lane} if a.lane else None
    for seed in (int(s) for s in a.seeds.split(',')):
        run = drivers.execute(cell, seed, a.seconds, False,
                              program_overrides=overrides)
        print(json.dumps({'seed': seed, 'lane': a.lane or 'configured',
                          'correct': run.correct, 'checks': run.checks}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
