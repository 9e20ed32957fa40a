"""Run one cell of the benchmark of video_features_torch once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics come from
BENCHMARK.json and the files it names (README.md). With ``--trace 0``
the last line of standard output is the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics; both check the outputs against the
plain reference. Without a card, or where the program is missing, the
run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what nothing this process runs may load, by whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'video_features_tpu')


def forbidden_modules() -> list:
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'unknown'


def result_line(run, metrics: dict, chips: int) -> dict:
    import torch
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': chips, 'memory_peak_bytes': run.memory_peak_bytes}
    out = {'correct': bool(run.correct), 'attempted': run.attempted,
           'failed': run.failed, 'metrics': metrics, 'device': device}
    if run.traced:
        dt = run.device_trace
        device.update(busy_s=dt.busy_s, window_s=dt.window_s)
        out['breakdown'] = dt.breakdown(run.spans, run.offset_ns)
    out['checks'] = run.checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    from portbench.harness import spec
    cell = spec.Cell(spec.benchmark(), a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'portbench: {a.workload} needs {cell.chips} CUDA device(s); '
              f'this machine has {torch.cuda.device_count()}: no result',
              file=sys.stderr)
        return 3
    from portbench.harness import drivers
    run = drivers.execute(cell, a.seed, a.seconds, bool(a.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f'portbench: the run loaded {", ".join(loaded)}: no result',
              file=sys.stderr)
        return 4
    metrics = spec.read_metrics(cell.metrics(bool(a.trace)), run)
    print(json.dumps(result_line(run, metrics, cell.chips)), flush=True)
    print(f'card: {power_limit()}', file=sys.stderr)
    steps = list(run.setup_parts.items()) + [('warm-up', run.setup_s)]
    print('setup: ' + ', '.join(f'{k} {v - (steps[i - 1][1] if i else 0.0):.2f} s'
                                for i, (k, v) in enumerate(steps)),
          file=sys.stderr)
    if run.traced:
        dt = run.device_trace
        print(f'trace: window {dt.window_s!r} s, busy {dt.busy_s!r} s, '
              f'ranges {dict(dt.range_calls)} calls, '
              f'{ {k: round(v, 4) for k, v in dt.range_s.items()} } s',
              file=sys.stderr)
    for name, c in run.checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
