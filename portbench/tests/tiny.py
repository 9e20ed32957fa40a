"""A tree of tiny cells for the harness's CPU tests: the real
configurations' files with small depths, few frames and few iterations
(I3D needs 10-frame stacks and resizes to a 256 short side), in a
BENCHMARK.json of their own under a temporary root."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import spec

PORTBENCH = spec.PORTBENCH


def _edit(src: Path, dst: Path, program: dict) -> None:
    data = json.loads(src.read_text())
    data['program'].update(program)
    dst.write_text(json.dumps(data))


def make_tree(root: Path) -> Path:
    """Write the tiny tree under ``root``; returns ``root``."""
    pb = root / 'portbench'
    for sub in ('configs', 'traffic', 'limits'):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    _edit(PORTBENCH / 'configs' / 'i3d_raft.json', pb / 'configs' / 'i3d_raft.json',
          dict(stack_size=10, step_size=10, raft_iters=1, batch_size=2))
    _edit(PORTBENCH / 'configs' / 'raft_sintel.json',
          pb / 'configs' / 'raft_sintel.json', dict(raft_iters=2, batch_size=2))
    k400 = json.loads((PORTBENCH / 'traffic' / 'k400_mixed.json').read_text())
    k400['corpus'] = {'name': 'tiny_k400', 'seed': 1, 'fps': 25,
                      'clips': [[11, 256, 256]] * 3}
    k400['check'] = {'videos': 1}
    (pb / 'traffic' / 'k400_mixed.json').write_text(json.dumps(k400))
    sintel = json.loads((PORTBENCH / 'traffic' / 'sintel_mixed.json').read_text())
    sintel['corpus'] = {'name': 'tiny_sintel', 'seed': 2, 'fps': 24,
                        'clips': [[5, 136, 160], [4, 136, 160], [6, 136, 160]]}
    sintel['check'] = {'videos': 2, 'from_first': 3, 'pairs': 3}
    (pb / 'traffic' / 'sintel_mixed.json').write_text(json.dumps(sintel))
    bench = spec.benchmark()
    keep = ('i3d_raft.k400_mixed', 'raft_sintel.sintel_mixed')
    bench['workloads'] = [w for w in bench['workloads'] if w['name'] in keep]
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    for name in keep:
        shutil.copy(PORTBENCH / 'limits' / f'{name}.json', pb / 'limits')
    return root


def cell(root: Path, name: str) -> spec.Cell:
    return spec.Cell(spec.benchmark(root), name, root)
