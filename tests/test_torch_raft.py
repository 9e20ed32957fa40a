"""The port's RAFT (video_features_torch/models/raft.py) against the JAX
package's, on the CPU, with the same seeded weights: the JAX
``init_state_dict`` → JAX ``transplant`` → ``params_from_jax``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import raft as jax_raft
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.models import raft
from video_features_torch.transplant import params_from_jax

# rtol 1e-4, atol 1e-4 of the flow's scale: random weights give flows of
# ~60 px, and float32 reassociation noise grows with that scale through
# the (non-contracting, random-weight) GRU iterations
TOL = 1e-4


def _assert_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max())


@pytest.fixture(scope='module')
def params():
    jp = transplant(jax_raft.init_state_dict(seed=0))
    return jp, params_from_jax(jp)


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize('impl', ['gather', 'dense'])
def test_forward_matches_jax(params, impl, monkeypatch):
    monkeypatch.setenv('VFT_RAFT_LOOKUP', impl)
    jp, tp = params
    im1, im2 = _frames(0, (1, 64, 80, 3)), _frames(1, (1, 64, 80, 3))
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_raft.forward(jp, jnp.asarray(im1), jnp.asarray(im2),
                                          iters=3, platform='cpu'))
    with torch.inference_mode():
        got = raft.forward(tp, torch.from_numpy(im1), torch.from_numpy(im2),
                           iters=3).numpy()
    assert got.shape == ref.shape == (1, 64, 80, 2)
    _assert_close(got, ref)


@pytest.mark.parametrize('impl', ['gather', 'dense'])
def test_forward_stack_pairs_matches_jax(params, impl, monkeypatch):
    monkeypatch.setenv('VFT_RAFT_LOOKUP', impl)
    jp, tp = params
    stacks = _frames(2, (1, 3, 64, 80, 3))
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_raft.forward_stack_pairs(
            jp, jnp.asarray(stacks), iters=3, platform='cpu'))
    with torch.inference_mode():
        got = raft.forward_stack_pairs(tp, torch.from_numpy(stacks),
                                       iters=3).numpy()
    assert got.shape == ref.shape == (1, 2, 64, 80, 2)
    _assert_close(got, ref)


@pytest.mark.parametrize('h,w', [(64, 80), (61, 83), (256, 341)])
def test_pad_amounts_match_jax(h, w):
    x = np.zeros((1, h, w, 3), np.uint8)
    ref, ref_pads = jax_raft.pad_to_multiple(x)
    got, pads = raft.pad_to_multiple(torch.from_numpy(x))
    assert pads == tuple(ref_pads)
    assert tuple(got.shape) == ref.shape


def test_edge_pad_matches_numpy_edge_mode():
    x = _frames(3, (1, 5, 7, 3))
    got, pads = raft.pad_to_multiple(torch.from_numpy(x))
    ref, _ = jax_raft.pad_to_multiple(x)
    np.testing.assert_array_equal(got.numpy(), ref)
    t, b, l, r = pads
    np.testing.assert_array_equal(
        got.numpy()[:, t:got.shape[1] - b, l:got.shape[2] - r], x)


@pytest.mark.parametrize('value,want', [(None, 20), (3, 3), ('7', 7)])
def test_resolve_iters(value, want):
    assert raft.resolve_iters(value) == want


def test_resolve_iters_rejects_zero():
    with pytest.raises(ValueError):
        raft.resolve_iters(0)
