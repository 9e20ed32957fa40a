"""The CUDA kernels' wrappers (video_features_torch/ops/corr_lookup.py,
ops/gru.py). This file imports no JAX, so its ``cuda``-marked tests run
on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from video_features_torch.models import raft
from video_features_torch.ops import corr_lookup, gru
from video_features_torch.utils.device import set_precision

ATOL = 1e-5   # fp reassociation of a 4-term blend of O(1) values
# fp32 reassociation of 1,280-term sums with O(1) pre-activations behind a
# sigmoid or tanh, outputs in (-1, 1)
GRU_ATOL = 1e-5


def _pyramid(rng, n, h, w, device='cpu'):
    return [torch.from_numpy(rng.randn(n, h >> i, w >> i).astype(np.float32)
                             ).to(device) for i in range(4)]


def _coords(rng, b, h, w, device='cpu', kind='mixed'):
    """(b, h, w, 2) coordinates of one kind: 'mixed' in-range, fractional
    and out-of-range centroids; 'far' ones at least 1000 px outside every
    level (every window all zeros); 'edges' integers, with each level's
    first and last row and column and the ones just outside them."""
    if kind == 'mixed':
        xy = rng.uniform(-9, max(h, w) + 9, size=(b, h, w, 2))
    elif kind == 'far':
        xy = (rng.uniform(1e3, 1e6, size=(b, h, w, 2))
              * rng.choice([-1, 1], (b, h, w, 2)))
    else:
        axes = []
        for extent in (w, h):
            picks = list(range(-6, extent + 6))
            for level in range(4):
                last = max(extent >> level, 1)
                picks += [s << level for s in (-1, 0, last - 1, last)]
            axes.append(rng.choice(picks, size=(b, h, w)))
        xy = np.stack(axes, -1)
    return torch.from_numpy(xy.astype(np.float32)).to(device)


# the kernels' edge cases: pixel counts that are not a multiple of the
# kernels' 8-pixel group (3·13·9 = 351, 31·41 = 1271), a 13×9 grid whose top
# level is 1×1, windows all outside the map, integer and edge coordinates
EDGE_CASES = [(3, 13, 9, 'mixed'), (1, 31, 41, 'mixed'), (2, 32, 43, 'far'),
              (2, 32, 43, 'edges'), (3, 13, 9, 'edges')]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    # the extractors' float32 policy: without it the plain versions' cuDNN
    # convolutions run in TF32 and drift ~1e-3 from the fp32 kernels
    set_precision('highest')
    return torch.device('cuda')


def test_cpu_wrappers_count_no_launches():
    rng = np.random.RandomState(4)
    pyr, coords = _pyramid(rng, 128, 8, 16), _coords(rng, 1, 8, 16)
    before = (corr_lookup.lookup_corr_lanes.launches,
              corr_lookup.lookup_corr.launches)
    corr_lookup.lookup_corr_lanes(pyr, coords)
    corr_lookup.lookup_corr(corr_lookup.pad_pyramid(pyr), coords)
    assert (corr_lookup.lookup_corr_lanes.launches,
            corr_lookup.lookup_corr.launches) == before


def test_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(5)
    pyr, coords = _pyramid(rng, 128, 8, 16), _coords(rng, 1, 8, 16)
    with pytest.raises(ValueError, match='coords'):
        corr_lookup.lookup_corr_lanes(pyr, coords.double())
    with pytest.raises(ValueError, match='coords'):
        corr_lookup.lookup_corr_lanes(pyr, coords.transpose(1, 2))
    with pytest.raises(ValueError, match='levels'):
        corr_lookup.lookup_corr_lanes(pyr[:3], coords)
    with pytest.raises(ValueError, match='level 0'):
        corr_lookup.lookup_corr(pyr, coords)      # not padded


@pytest.mark.parametrize('b,h,w,kind', EDGE_CASES)
def test_plain_versions_on_edge_cases_cpu(b, h, w, kind):
    """Each edge case exercises what it names, and the two plain versions,
    which the card test holds the kernels to, agree on it; windows all
    outside the map are exact zeros."""
    rng = np.random.RandomState(10)
    pyr = _pyramid(rng, b * h * w, h, w)
    coords = _coords(rng, b, h, w, kind=kind)
    if kind == 'mixed':
        assert (b * h * w) % 8                # ragged against 8-pixel groups
    if kind == 'edges':
        assert torch.equal(coords, coords.round())
        for level in range(4):
            last = max(w >> level, 1) - 1
            assert (coords[..., 0] == last << level).any()
    masked = corr_lookup.lookup_corr_lanes(pyr, coords)
    padded = corr_lookup.lookup_corr(corr_lookup.pad_pyramid(pyr), coords)
    assert masked.shape == (b, h, w, 324)
    torch.testing.assert_close(masked, padded, rtol=0, atol=ATOL)
    if kind == 'far':
        assert coords.abs().min() >= 1e3
        assert not masked.any() and not padded.any()


@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w,kind', [(2, 32, 43, 'mixed'), (1, 13, 9, 'mixed')]
                         + EDGE_CASES)
def test_kernels_match_plain_on_the_card(b, h, w, kind):
    dev = _cuda()
    rng = np.random.RandomState(6)
    pyr = _pyramid(rng, b * h * w, h, w, dev)
    coords = _coords(rng, b, h, w, dev, kind=kind)
    padded = corr_lookup.pad_pyramid(pyr)
    before = (corr_lookup.lookup_corr_lanes.launches,
              corr_lookup.lookup_corr.launches)
    masked = corr_lookup.lookup_corr_lanes(pyr, coords)
    unmasked = corr_lookup.lookup_corr(padded, coords)
    torch.cuda.synchronize()
    assert (corr_lookup.lookup_corr_lanes.launches,
            corr_lookup.lookup_corr.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        masked, corr_lookup.lookup_corr_lanes_plain(pyr, coords),
        rtol=0, atol=ATOL)
    torch.testing.assert_close(
        unmasked, corr_lookup.lookup_corr_plain(padded, coords),
        rtol=0, atol=ATOL)
    torch.testing.assert_close(masked, unmasked, rtol=0, atol=ATOL)
    if kind == 'far':
        assert not masked.any() and not unmasked.any()


def _gru_inputs(rng, b, h, w, device='cpu'):
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(device)
    w_zr, w_q = gru.pack_direction(t(256, 256, 1, 5, scale=0.05),
                                   t(128, 256, 1, 5, scale=0.05))
    return (torch.tanh(t(b, h, w, 128)), t(b, h, w, 128), w_zr, w_q,
            t(b, h, w, 256, scale=0.1), t(b, h, w, 128, scale=0.1))


# a full grid, a ragged one, one smaller than the taps' halo, so that taps
# leave both edges of every row and column, and one too wide for the
# kernel's 128-pixel tiles on axis 'h' (64-pixel tiles, tap windows staged
# apart)
@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w', [(2, 32, 43), (3, 13, 9), (2, 3, 4),
                                   (1, 6, 100)])
@pytest.mark.parametrize('axis', ['w', 'h'])
def test_gru_kernel_matches_plain_on_the_card(b, h, w, axis):
    dev = _cuda()
    x = _gru_inputs(np.random.RandomState(8), b, h, w, dev)
    before = gru.gru_direction.launches
    got = gru.gru_direction(*x, axis)
    torch.cuda.synchronize()
    assert gru.gru_direction.launches == before + 1
    torch.testing.assert_close(got, gru.gru_direction_plain(*x, axis),
                               rtol=0, atol=GRU_ATOL)


# the one-pass instantiation (the one-pass precision lanes) against its
# plain version, the fp32 convolution of the TF32-rounded operands: the
# products agree exactly, but r·h, the q GEMM's input, is rounded to TF32
# after a sigmoid whose last bit may differ between the two, and a rounding
# that falls the other way moves that input by one TF32 ulp; so up to a few
# 1e-4 at rare outputs (a sigmoid in another fp32 form moves the plain
# version itself by 4.8e-5 at the (8, 32, 43) grid, on the CPU), the mean
# at fp32 reassociation's level
GRU1_ATOL, GRU1_MEAN_ATOL = 5e-4, 1e-6


# the grids above but the one smaller than the taps' halo, plus the
# cluster kernel's edges: 300 pixels in 3 tiles of 128 (the last partial;
# the last cluster holds a CTA with no rows), a grid smaller than one
# cluster, and the RAFT family's main-path grid at batch 8
@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w', [(2, 32, 43), (3, 13, 9), (1, 6, 100),
                                   (1, 5, 60), (2, 3, 4), (8, 32, 43)])
@pytest.mark.parametrize('axis', ['w', 'h'])
def test_gru_one_pass_kernel_matches_plain_on_the_card(b, h, w, axis):
    dev = _cuda()
    x = _gru_inputs(np.random.RandomState(8), b, h, w, dev)
    before = dict(gru.gru_direction.launches_by_passes)
    got = gru.gru_direction(*x, axis, passes=1)
    torch.cuda.synchronize()
    assert gru.gru_direction.launches_by_passes == {1: before[1] + 1,
                                                    3: before[3]}
    diff = (got - gru.gru_direction_plain(*x, axis, passes=1)).abs()
    assert diff.max() <= GRU1_ATOL and diff.mean() <= GRU1_MEAN_ATOL
    assert (got - gru.gru_direction(*x, axis)).abs().max() > 0


def _params(dev):
    from video_features_torch.transplant import params_from_torch, to_device
    return to_device(params_from_torch(raft.init_state_dict(seed=0)), dev)


@pytest.mark.cuda
def test_raft_runs_the_kernel_every_iteration():
    dev = _cuda()
    params = _params(dev)
    rng = np.random.RandomState(7)
    frames = torch.from_numpy(rng.randint(0, 256, (1, 3, 64, 80, 3)).astype(
        np.uint8)).to(dev)
    before = (corr_lookup.lookup_corr_lanes.launches, gru.gru_direction.launches)
    with torch.inference_mode():
        flow = raft.forward_stack_pairs(params, frames, iters=4)
        plain = raft.forward_stack_pairs(params, frames, iters=4,
                                         plain_kernels=True)
    assert (corr_lookup.lookup_corr_lanes.launches,
            gru.gru_direction.launches) == (before[0] + 4, before[1] + 8)
    assert flow.shape == (1, 2, 64, 80, 2)
    rel = ((flow - plain).norm() / plain.norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
def test_forward_consecutive_runs_the_kernels_every_iteration():
    dev = _cuda()
    params = _params(dev)
    rng = np.random.RandomState(9)
    frames = torch.from_numpy(rng.randint(0, 256, (3, 64, 88, 3)).astype(
        np.uint8)).to(dev)
    before = (corr_lookup.lookup_corr_lanes.launches, gru.gru_direction.launches)
    with torch.inference_mode():
        flow = raft.forward_consecutive(params, frames, iters=3)
        plain = raft.forward_consecutive(params, frames, iters=3,
                                         plain_kernels=True)
    assert (corr_lookup.lookup_corr_lanes.launches,
            gru.gru_direction.launches) == (before[0] + 3, before[1] + 6)
    assert flow.shape == (2, 64, 88, 2)
    rel = ((flow - plain).norm() / plain.norm()).item()
    assert rel <= 1e-3
