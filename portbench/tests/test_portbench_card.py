"""On the card (``cuda``): cell 1 for a few seconds through the command
is correct, and the control (the program's one-pass TF32 lane in place
of the configured one) is not, at the cells' own sizes. Here they skip:
whether a card exists is decided inside each test."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import spec

pytestmark = pytest.mark.cuda


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run: pytest -m cuda portbench/tests on the card)')


def _last_json(cmd, timeout):
    out = subprocess.run([sys.executable] + cmd, cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def test_cell_one_runs_correct_on_the_card():
    _card()
    line = _last_json(['portbench/run.py', '--workload', 'i3d_raft.k400_mixed',
                       '--seed', '2147483659', '--seconds', '4', '--trace', '0'],
                      600)[-1]
    assert line['correct'] and line['failed'] == 0
    assert line['metrics']['windows_per_s']['value'] > 0
    assert line['device']['platform'] == 'gpu'


@pytest.mark.parametrize('cell', ['i3d_raft.k400_mixed', 'raft_sintel.sintel_mixed'])
def test_the_control_lane_is_not_correct(cell):
    _card()
    for row in _last_json(['portbench/control.py', '--workload', cell, '--seeds',
                           '17,18,19', '--seconds', '3', '--lane',
                           'tensorfloat32'], 900):
        assert not row['correct'], row
