"""The harness driven end to end on the CPU at a tiny size (tiny.py): a
clean run is correct; a run whose timed path is broken underneath is
not; and a run loads nothing of JAX or the JAX package."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import drivers
from portbench.tests import tiny


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp('portbench'))


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def alter_one_answer(ex):
    """One value of each item's answer changed where the step produces it
    (every item, so that the check's sample of videos holds one)."""
    step = ex.packed_step

    def broken(batch):
        out = step(batch)
        key = next(iter(out))
        out[key] = out[key].clone()
        out[key].reshape(out[key].shape[0], -1)[:, 0] += 1.0
        return out
    ex.packed_step = broken


def drop_half_the_batch(ex):
    """The step computes half its batch and repeats that half's answers
    for the rest."""
    step = ex.packed_step

    def broken(batch):
        out = step(batch)
        n = next(iter(out.values())).shape[0]
        return {k: v[:n // 2].repeat_interleave(2, dim=0)[:n].clone()
                if n > 1 else v for k, v in out.items()}
    ex.packed_step = broken


def test_a_clean_flow_run_is_correct(tree):
    run = drivers.execute(tiny.cell(tree, 'raft_sintel.sintel_mixed'),
                          2 ** 31 + 11, 8.0, False, device='cpu')
    assert run.correct and run.items > 0 and run.failed == 0
    assert run.checks['flow_rel_l2']['value'] < 1e-4


@pytest.mark.parametrize('fault', [alter_one_answer, drop_half_the_batch])
def test_a_broken_flow_step_is_not_correct(tree, fault):
    run = drivers.execute(tiny.cell(tree, 'raft_sintel.sintel_mixed'),
                          7, 8.0, False, device='cpu', step_patch=fault)
    assert not run.correct


@pytest.mark.parametrize('fault', [None, alter_one_answer])
def test_the_packed_i3d_path_is_judged(tree, fault):
    run = drivers.execute(tiny.cell(tree, 'i3d_raft.k400_mixed'), 2 ** 33 + 5,
                          20.0, False, device='cpu', step_patch=fault)
    assert run.correct is (fault is None)
    assert np.isfinite(run.checks['rgb_rel_l2']['value'])


REHEARSAL = '''
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench.harness import drivers
from portbench.tests import tiny
from portbench.run import forbidden_modules
run = drivers.execute(tiny.cell(Path({tree!r}), 'raft_sintel.sintel_mixed'),
                      3, 8.0, True, device='cpu')
print(json.dumps({{'correct': run.correct, 'loaded': forbidden_modules()}}))
'''


def test_a_run_loads_nothing_of_jax(tree):
    code = REHEARSAL.format(root=str(tiny.spec.ROOT), tree=str(tree))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {'correct': True, 'loaded': []}
