"""The CUDA lookup kernels' wrappers (video_features_torch/ops/
corr_lookup.py). This file imports no JAX, so its ``cuda``-marked tests
run on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from video_features_torch.models import raft
from video_features_torch.ops import corr_lookup

ATOL = 1e-5   # fp reassociation of a 4-term blend of O(1) values


def _pyramid(rng, n, h, w, device='cpu'):
    return [torch.from_numpy(rng.randn(n, h >> i, w >> i).astype(np.float32)
                             ).to(device) for i in range(4)]


def _coords(rng, b, h, w, device='cpu'):
    # in-range, fractional, and far out-of-range centroids
    xy = rng.uniform(-9, max(h, w) + 9, size=(b, h, w, 2)).astype(np.float32)
    return torch.from_numpy(xy).to(device)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
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


@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w', [(2, 32, 43), (1, 13, 9)])
def test_kernels_match_plain_on_the_card(b, h, w):
    dev = _cuda()
    rng = np.random.RandomState(6)
    pyr = _pyramid(rng, b * h * w, h, w, dev)
    coords = _coords(rng, b, h, w, dev)
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


@pytest.mark.cuda
def test_raft_runs_the_kernel_every_iteration():
    dev = _cuda()
    sd = raft.init_state_dict(seed=0)
    from video_features_torch.transplant import params_from_torch, to_device
    params = to_device(params_from_torch(sd), dev)
    rng = np.random.RandomState(7)
    frames = torch.from_numpy(rng.randint(0, 256, (1, 3, 64, 80, 3)).astype(
        np.uint8)).to(dev)
    before = corr_lookup.lookup_corr_lanes.launches
    with torch.inference_mode():
        flow = raft.forward_stack_pairs(params, frames, iters=4)
        plain = raft.forward_stack_pairs(params, frames, iters=4,
                                         plain_lookup=True)
    assert corr_lookup.lookup_corr_lanes.launches == before + 4
    assert flow.shape == (1, 2, 64, 80, 2)
    rel = ((flow - plain).norm() / plain.norm()).item()
    assert rel <= 1e-3
