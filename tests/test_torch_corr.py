"""The port's RAFT correlation lookup (video_features_torch/ops/
corr_lookup.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests hold the plain versions (and the pyramid prep and dispatch
around them) to the TPU kernels. The CUDA kernels themselves run only
on the card: tests/test_torch_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.models import raft as jax_raft
from video_features_tpu.ops import pallas_corr
from video_features_torch.ops import corr_lookup

ATOL = 1e-5   # fp reassociation of a 4-term blend of O(1) values


def _random_pyramid(rng, n, h, w, levels=4):
    return [rng.randn(n, max(h >> i, 1), max(w >> i, 1)).astype(np.float32)
            for i in range(levels)]


def _coords(rng, b, h, w):
    # centroids spanning in-range, fractional, and far out-of-range values
    return rng.uniform(-9, max(h, w) + 9, size=(b, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize('h,w', [(8, 12), (13, 9)])
def test_lanes_plain_matches_pallas_lanes(h, w):
    rng = np.random.RandomState(0)
    b = 2
    pyr = _random_pyramid(rng, b * h * w, h, w)
    coords = _coords(rng, b, h, w)
    ref = pallas_corr.lookup_corr_lanes(
        pallas_corr.prep_pyramid_lanes([jnp.asarray(p[..., None]) for p in pyr]),
        jnp.asarray(coords), interpret=True)
    got = corr_lookup.lookup_corr_lanes([torch.from_numpy(p) for p in pyr],
                                        torch.from_numpy(coords))
    assert got.shape == ref.shape == (b, h, w, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize('h,w', [(8, 12), (13, 9)])
def test_padded_plain_matches_pallas_window_slice(h, w):
    rng = np.random.RandomState(1)
    b = 2
    pyr = _random_pyramid(rng, b * h * w, h, w)
    coords = _coords(rng, b, h, w)
    ref = pallas_corr.lookup_corr(
        pallas_corr.prep_pyramid([jnp.asarray(p[..., None]) for p in pyr], 4),
        jnp.asarray(coords), interpret=True)
    padded = corr_lookup.pad_pyramid([torch.from_numpy(p) for p in pyr])
    got = corr_lookup.lookup_corr(padded, torch.from_numpy(coords))
    assert got.shape == ref.shape == (b, h, w, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    # the two formulations agree with each other as well
    masked = corr_lookup.lookup_corr_lanes([torch.from_numpy(p) for p in pyr],
                                           torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), masked.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize('padded', [False, True], ids=['lanes', 'padded'])
def test_integer_coords_hit_the_map_exactly(padded):
    """Integer coords have zero bilinear weight: the window is the map's
    own values, dy-major, zeros outside."""
    rng = np.random.RandomState(2)
    h, w = 8, 8
    corr = rng.randn(h * w, h, w).astype(np.float32)
    pyr = [torch.from_numpy(corr)] + [
        torch.from_numpy(p) for p in _random_pyramid(rng, h * w, h, w)[1:]]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    coords = torch.from_numpy(np.stack([xx, yy], -1)[None].astype(np.float32))
    if padded:
        got = corr_lookup.lookup_corr(corr_lookup.pad_pyramid(pyr), coords)
    else:
        got = corr_lookup.lookup_corr_lanes(pyr, coords)
    got = got.numpy().reshape(h * w, 324)[:, :81].reshape(h * w, 9, 9)
    for n in range(h * w):
        y, x = divmod(n, w)
        for i in range(9):
            for j in range(9):
                xi, yj = x + i - 4, y + j - 4
                want = corr[n, yj, xi] if 0 <= xi < w and 0 <= yj < h else 0.0
                assert got[n, i, j] == want


def test_pyramid_matches_prep_pyramid_lanes_fused():
    rng = np.random.RandomState(3)
    b, h, w, d = 2, 9, 11, 16
    f1 = rng.randn(b, h, w, d).astype(np.float32)
    f2 = rng.randn(b, h, w, d).astype(np.float32)
    ref = pallas_corr.prep_pyramid_lanes_fused(jnp.asarray(f1), jnp.asarray(f2))
    got = corr_lookup.build_corr_pyramid(torch.from_numpy(f1),
                                         torch.from_numpy(f2))
    n = b * h * w
    for level_ref, level in zip(ref, got):
        # (h, w, N') lane layout → the port's natural (N, h, w)
        want = np.asarray(level_ref)[..., :n].transpose(2, 0, 1)
        assert level.shape == want.shape and level.is_contiguous()
        np.testing.assert_allclose(level.numpy(), want, rtol=0, atol=1e-6)
    # the unfused JAX pyramid too
    ref2 = jax_raft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    for level_ref, level in zip(ref2, got):
        np.testing.assert_allclose(level.numpy(), np.asarray(level_ref)[..., 0],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('impl', ['dense', 'gather'])
def test_plain_impls_refused_on_cuda(impl):
    """Plain lookups never run on the card's main path: dispatch refuses
    them for a CUDA device (decided from the device, no GPU needed)."""
    with pytest.raises(ValueError, match='plain lookup'):
        corr_lookup.select_lookup(impl, torch.device('cuda'))


@pytest.mark.parametrize('impl,kernel', [
    ('auto', 'lookup_corr_lanes'), ('lanes', 'lookup_corr_lanes'),
    ('pallas', 'lookup_corr'),
])
def test_cuda_dispatch_selects_the_kernels(impl, kernel):
    _, lookup = corr_lookup.select_lookup(impl, torch.device('cuda'))
    assert lookup is getattr(corr_lookup, kernel)
    _, plain = corr_lookup.select_lookup(impl, torch.device('cuda'), plain=True)
    assert plain is getattr(corr_lookup, kernel + '_plain')


@pytest.mark.parametrize('env,want', [
    ({}, 'auto'), ({'VFT_RAFT_LOOKUP': 'dense'}, 'dense'),
    ({'VFT_RAFT_PALLAS': '1'}, 'pallas'),
    ({'VFT_RAFT_LOOKUP': 'gather'}, 'gather'),
])
def test_env_values_read_like_the_jax_package(env, want):
    assert corr_lookup.lookup_impl_from_env(env) == want


def test_env_rejects_unknown_value():
    with pytest.raises(ValueError):
        corr_lookup.lookup_impl_from_env({'VFT_RAFT_LOOKUP': 'triton'})
