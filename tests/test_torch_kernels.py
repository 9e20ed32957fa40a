"""The CUDA kernels' wrappers (video_features_torch/ops/corr_lookup.py,
ops/gru.py, ops/conv_tf32x3.py, ops/gemm_tf32x3.py, ops/dwconv.py). This file imports no JAX, so its ``cuda``-marked tests run
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


# -- the 3xTF32 convolution (ops/conv_tf32x3.py) -------------------------------

# conv geometries of the i3d and raft paths, several blocks of 128 output
# pixels each, ragged tails included: (x shape, weight shape, stride,
# padding); I3D's TF-SAME pads for a 7x7x7 stride 2 are (2, 3) per axis
CONV_GEOMETRIES = [
    ((2, 8, 30, 30, 3), (64, 3, 7, 7, 7), 2, [(2, 3)] * 3),      # rgb conv1
    ((2, 8, 30, 30, 2), (64, 2, 7, 7, 7), 2, [(2, 3)] * 3),      # flow conv1
    ((1, 4, 14, 14, 96), (128, 96, 3, 3, 3), 1, [(1, 1)] * 3),   # 3x3x3
    ((1, 2, 7, 7, 832), (384, 832, 1, 1, 1), 1, 0),              # 1x1x1
    ((2, 64, 88, 3), (64, 3, 7, 7), 2, 3),                       # encoder conv1
    ((1, 32, 44, 64), (96, 64, 3, 3), 2, 1),                     # stride 2
    ((2, 16, 22, 324), (256, 324, 1, 1), 1, 0),                  # convc1
    ((2, 16, 22, 2), (128, 2, 7, 7), 1, 3),                      # convf1
    ((2, 16, 22, 256), (126, 256, 3, 3), 1, 1),                  # encoder conv
    ((2, 16, 22, 256), (2, 256, 3, 3), 1, 1),                    # flow head
    ((2, 16, 22, 256), (576, 256, 1, 1), 1, 0),                  # mask head
    ((2, 16, 22, 128), (256, 128, 1, 5), 1, [(0, 0), (2, 2)]),   # GRU term
    # I3D's narrow inputs: K spans taps (channels padded to 4, not 32)
    ((1, 4, 14, 14, 16), (32, 16, 3, 3, 3), 1, [(1, 1)] * 3),    # 16 -> 32
    ((1, 4, 14, 14, 24), (64, 24, 3, 3, 3), 1, [(1, 1)] * 3),    # 24 -> 64
    ((1, 2, 7, 7, 48), (128, 48, 3, 3, 3), 1, [(1, 1)] * 3),     # 48 -> 128
    # output tiles of 96: O = 192 (convc2, two), 96, 576 (six)
    ((2, 16, 22, 256), (192, 256, 3, 3), 1, 1),                  # convc2
    ((1, 4, 14, 14, 192), (96, 192, 1, 1, 1), 1, 0),             # 1x1x1 -> 96
    ((1, 16, 22, 256), (576, 256, 1, 1), 1, 0),                  # mask head
    # the RAFT family at 8 pairs (M = 10,752): 64-pixel tiles
    ((8, 32, 42, 2), (128, 2, 7, 7), 1, 3),                      # convf1
    ((8, 32, 42, 256), (2, 256, 3, 3), 1, 1),                    # flow head
    # 128-pixel blocks (two warpgroups): images of 10.75 blocks, the 1x5
    # taps, images smaller than a block
    ((16, 32, 43, 256), (192, 256, 3, 3), 1, 1),                 # convc2
    ((16, 32, 43, 128), (2, 128, 3, 3), 1, 1),                   # flow head
    ((16, 32, 43, 128), (256, 128, 1, 5), 1, [(0, 0), (2, 2)]),  # GRU term
    ((300, 7, 9, 64), (64, 64, 3, 3), 1, 1),                     # tiny images
    # a path geometry or two of each family the lane took on next:
    # resnet's stem and 1x1 stride-2 downsample, r21d's (1, 7, 7) stem on 3
    # channels (O = 45) and a temporal stride-2 conv on 230 (padded to
    # 232), s3d's spatial (1, 3, 3) and its bias-carrying fc, vggish's
    # 1-channel first conv and its 512 -> 512
    ((2, 56, 56, 3), (64, 3, 7, 7), 2, 3),                       # resnet stem
    ((2, 28, 28, 256), (512, 256, 1, 1), 2, 0),                  # downsample
    ((1, 4, 28, 28, 3), (45, 3, 1, 7, 7), (1, 2, 2), [(0, 0), (3, 3), (3, 3)]),
    ((1, 8, 14, 14, 230), (128, 230, 3, 1, 1), (2, 1, 1), [(1, 1), (0, 0), (0, 0)]),
    ((1, 4, 14, 14, 96), (128, 96, 1, 3, 3), 1, [(0, 0), (1, 1), (1, 1)]),
    ((1, 3, 1, 1, 1024), (400, 1024, 1, 1, 1), 1, 0),            # s3d fc
    ((4, 96, 64, 1), (64, 1, 3, 3), 1, 1),                       # vggish conv1
    ((4, 12, 8, 512), (512, 512, 3, 3), 1, 1),                   # vggish conv6
]
CONV_REL_L2 = 1e-5      # 3xTF32 against cuDNN's fp32 (TF32 off)

# ResNeXt's grouped 3x3 at each width (resnext50_32x4d's 128..1024 in
# groups of 4..32 channels, resnext101_32x8d's 2048 in groups of 64,
# resnext101_64x4d's 256 in 64 groups of 4), one strided: (x shape, weight
# shape, groups, stride)
GROUPED_CONV_GEOMETRIES = [
    ((2, 28, 28, 128), (128, 4, 3, 3), 32, 1),
    ((2, 28, 28, 256), (256, 8, 3, 3), 32, 2),
    ((2, 14, 14, 512), (512, 16, 3, 3), 32, 1),
    ((2, 7, 7, 1024), (1024, 32, 3, 3), 32, 1),
    ((2, 7, 7, 2048), (2048, 64, 3, 3), 32, 1),
    ((2, 28, 28, 256), (256, 4, 3, 3), 64, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize('xs,ws,stride,padding', CONV_GEOMETRIES)
def test_conv_kernel_matches_plain_on_the_card(xs, ws, stride, padding):
    from video_features_torch.ops import conv_tf32x3 as k
    dev = _cuda()
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(*ws) * 0.05).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32)).to(dev)
    before = k.conv_tf32x3.launches
    got = k.conv_tf32x3(x, w, stride, padding, b)
    want = k.conv_tf32x3_plain(x, w, stride, padding, b)
    torch.cuda.synchronize()
    assert k.conv_tf32x3.launches == before + 1
    assert got.shape == want.shape
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= CONV_REL_L2
    # and the bias-free form
    got = k.conv_tf32x3(x, w, stride, padding)
    want = k.conv_tf32x3_plain(x, w, stride, padding)
    assert ((got - want).norm() / want.norm()).item() <= CONV_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize('xs,ws,groups,stride', GROUPED_CONV_GEOMETRIES)
def test_grouped_conv_kernel_matches_plain_on_the_card(xs, ws, groups,
                                                       stride):
    """A grouped convolution in one launch, each tile reading only its
    groups' channels, against cuDNN's fp32 grouped convolution; two
    launches byte-equal, and a weight packed ahead byte-equal too."""
    from video_features_torch.ops import conv_tf32x3 as k
    dev = _cuda()
    rng = np.random.RandomState(15)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(*ws) * 0.05).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32)).to(dev)
    before = k.conv_tf32x3.launches
    got = k.conv_tf32x3(x, w, stride, 1, b, groups)
    want = k.conv_tf32x3_plain(x, w, stride, 1, b, groups)
    again = k.conv_tf32x3(x, w, stride, 1, b, groups)
    packed = k.conv_tf32x3(x, k.PackedWeight(w, k.pack_weight(w, groups)),
                           stride, 1, b, groups)
    torch.cuda.synchronize()
    assert k.conv_tf32x3.launches == before + 3
    assert got.shape == want.shape
    assert ((got - want).norm() / want.norm()).item() <= CONV_REL_L2
    assert torch.equal(got, again) and torch.equal(got, packed)


@pytest.mark.cuda
@pytest.mark.parametrize('xs,ws,stride,padding', CONV_GEOMETRIES[::4])
def test_conv_kernel_is_deterministic_and_takes_a_packed_weight(
        xs, ws, stride, padding):
    """Two launches give the same bytes (no split-K, no atomics), and a
    weight packed ahead (``prepack``) gives the same bytes as a bare one."""
    from video_features_torch.ops import conv_tf32x3 as k
    dev = _cuda()
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(*ws) * 0.05).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32)).to(dev)
    first = k.conv_tf32x3(x, w, stride, padding, b)
    again = k.conv_tf32x3(x, w, stride, padding, b)
    packed = k.conv_tf32x3(x, k.prepack(w), stride, padding, b)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, packed)


@pytest.mark.cuda
@pytest.mark.parametrize('xs,ws,stride,padding',
                         [CONV_GEOMETRIES[0], CONV_GEOMETRIES[2]])
def test_the_mma_yardstick_still_matches_plain(xs, ws, stride, padding):
    """The earlier mma.sync design, kept beside the kernel as a yardstick,
    still holds the plain version (gather mode on the 3-channel stem,
    vector mode on the 3x3x3)."""
    from video_features_torch.ops import conv_tf32x3 as k
    dev = _cuda()
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(*ws) * 0.05).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32)).to(dev)
    before = k.conv_tf32x3.launches
    got = k.conv_tf32x3_mma(x, w, stride, padding, b)
    want = k.conv_tf32x3_plain(x, w, stride, padding, b)
    torch.cuda.synchronize()
    assert k.conv_tf32x3.launches == before       # not the path's kernel
    assert ((got - want).norm() / want.norm()).item() <= CONV_REL_L2


@pytest.mark.cuda
def test_raft_three_pass_runs_the_conv_kernel_per_convolution():
    from video_features_torch.ops import conv_tf32x3 as k
    dev = _cuda()
    params = _params(dev)
    rng = np.random.RandomState(12)
    frames = torch.from_numpy(rng.randint(0, 256, (1, 3, 64, 80, 3)).astype(
        np.uint8)).to(dev)
    before = k.conv_tf32x3.launches
    with torch.inference_mode():
        flow = raft.forward_stack_pairs(params, frames, iters=2,
                                        three_pass_convs=True)
        torch.cuda.synchronize()
        launched = k.conv_tf32x3.launches - before
        plain = raft.forward_stack_pairs(params, frames, iters=2,
                                         plain_kernels=True,
                                         three_pass_convs=True)
    # 16 per encoder call (two), 4 context terms, 7 per iteration, 2
    assert launched == 32 + 4 + 7 * 2 + 2
    assert k.conv_tf32x3.launches - before == launched
    rel = ((flow - plain).norm() / plain.norm()).item()
    assert rel <= 1e-3


# -- the 3xTF32 GEMM and the fp32 depthwise convolution (clip and timm) --------

# the GEMM's path geometries, narrowed in batch: (name, A shape, B shape,
# B is (K, N), alpha, bias); 'qkv' operands are the head views of a
# (B, N, 3, H, D) projection, as the attention code reads them
GEMM_GEOMETRIES = [
    ('vit_b16 qkv', (394, 768), (2304, 768), False, 1.0, True),
    ('vit_b16 proj', (394, 768), (768, 768), False, 1.0, True),
    ('vit_b16 fc1', (394, 768), (3072, 768), False, 1.0, True),
    ('vit_b16 fc2', (394, 3072), (768, 3072), False, 1.0, True),
    ('vit_b16 qk', 'qkv', (2, 197, 12, 64), False, 0.125, False),
    ('vit_b16 pv', 'pv', (2, 197, 12, 64), True, 1.0, False),
    ('clip_b32 qk', 'qkv', (4, 50, 12, 64), False, 0.125, False),
    ('clip_b32 pv', 'pv', (4, 50, 12, 64), True, 1.0, False),
    ('clip proj', (4, 768), (768, 512), True, 1.0, False),
    ('clip rn50 attnpool q', (4, 1, 2048), (2048, 2048), False, 1.0, True),
    ('swin_t window qk', (96, 3, 49, 32), (96, 3, 49, 32), False, 1.0, False),
    ('swin_t window pv', (96, 3, 49, 49), (96, 3, 49, 32), True, 1.0, False),
    ('mixer token fc1', (1536, 196), (384, 196), False, 1.0, True),
    ('vit 768px blockwise pv', (1, 12, 2305, 512), (1, 12, 512, 64), True,
     1.0, False),
    ('vit_l16 fc2', (394, 4096), (1024, 4096), False, 1.0, True),
    ('head', (8, 768), (1000, 768), False, 1.0, True),
    ('ragged', (3, 37, 13), (3, 29, 13), False, 0.5, True),
    # P's rows of 257 floats (ViT-B/32 at 288 px), not 16-byte aligned
    ('vit_b32 288px pv', 'pv', (2, 257, 12, 64), True, 1.0, False),
    # ragged M under both consumer warpgroups, a weight and an activation B
    ('ragged m weight', (300, 256), (192, 256), False, 1.0, True),
    ('ragged m activation', (2, 300, 96), (2, 200, 96), False, 1.0, False),
]
GEMM_REL_L2 = 1e-6      # 3xTF32 against fp32 (TF32 off): ~2.5e-7 and fp32's own

# the depthwise convolutions of the timm CNNs, narrowed in batch: (x
# shape, kernel, stride, padding)
DWCONV_GEOMETRIES = [
    ((2, 56, 56, 96), 7, 1, 3), ((2, 28, 28, 192), 7, 1, 3),     # convnext_tiny
    ((2, 14, 14, 384), 7, 1, 3), ((2, 7, 7, 768), 7, 1, 3),
    ((2, 112, 112, 32), 3, 1, 1), ((2, 112, 112, 96), 3, 2, 1),  # efficientnet_b0
    ((2, 56, 56, 144), 5, 2, 2), ((2, 28, 28, 240), 3, 2, 1),
    ((2, 14, 14, 672), 5, 2, 2), ((2, 7, 7, 1152), 3, 1, 1),
    ((2, 112, 112, 16), 3, 1, 1), ((2, 56, 56, 72), 5, 2, 2),    # mobilenetv3
    ((2, 14, 14, 184), 3, 1, 1), ((2, 7, 7, 960), 5, 1, 2),
    ((2, 13, 11, 6), 3, 2, [(1, 0), (0, 2)]),                    # C % 4 != 0
    ((3, 7, 7, 36), 7, 1, 3), ((2, 14, 14, 20), 5, 2, 2),       # C % 32 != 0
    ((2, 9, 23, 10), 7, 2, 3),                                   # C % 4, ragged strips
]
DWCONV_REL_L2 = 1e-6    # fp32 FMAs against cuDNN's fp32


def _gemm_operands(dev, a_shape, b_shape, seed):
    rng = np.random.RandomState(seed)

    def t(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    if a_shape == 'qkv':                # q and k views of one projection
        b, n, h, d = b_shape
        qkv = t((b, n, 3, h, d))
        return qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2)
    if a_shape == 'pv':
        b, n, h, d = b_shape
        p = torch.softmax(t((b, h, n, n)), -1)
        return p, t((b, n, 3, h, d))[:, :, 2].transpose(1, 2)
    return t(a_shape), t(b_shape)


@pytest.mark.cuda
@pytest.mark.parametrize('name,a_shape,b_shape,kn,alpha,bias',
                         GEMM_GEOMETRIES, ids=[g[0] for g in GEMM_GEOMETRIES])
def test_gemm_kernel_matches_plain_on_the_card(name, a_shape, b_shape, kn,
                                               alpha, bias):
    """One launch per call against ``torch.matmul`` in fp32 at rel L2 <=
    1e-6 (and float64 beside it), the head views read in place; two
    launches byte-equal."""
    from video_features_torch.ops import gemm_tf32x3 as g
    dev = _cuda()
    a, b = _gemm_operands(dev, a_shape, b_shape, 21)
    n = b.shape[-1] if kn else b.shape[-2]
    c = (torch.from_numpy(np.random.RandomState(22).randn(n).astype(
        np.float32)).to(dev) if bias else None)
    before = g.gemm_tf32x3.launches
    got = g.gemm_tf32x3(a, b, kn, alpha, c)
    again = g.gemm_tf32x3(a, b, kn, alpha, c)
    want = g.gemm_tf32x3_plain(a, b, kn, alpha, c)
    exact = g.gemm_tf32x3_plain(a.double(), b.double(), kn, alpha,
                                None if c is None else c.double())
    torch.cuda.synchronize()
    assert g.gemm_tf32x3.launches == before + 2
    assert got.shape == want.shape and got.is_contiguous()
    assert ((got - want).norm() / want.norm()).item() <= GEMM_REL_L2
    assert ((got.double() - exact).norm() / exact.norm()).item() <= GEMM_REL_L2
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize('name,a_shape,b_shape,kn,alpha,bias',
                         GEMM_GEOMETRIES, ids=[g[0] for g in GEMM_GEOMETRIES])
def test_gemm_kernel_is_byte_equal_to_the_lockstep_design(name, a_shape,
                                                          b_shape, kn, alpha,
                                                          bias):
    """The warp-specialised kernel (a weight pre-split on the host, an
    activation split in the kernel) and the lockstep yardstick (every B
    split by its consumers) do the same products in the same order: the
    same bytes, so cached outputs of either answer for both."""
    from video_features_torch.ops import gemm_tf32x3 as g
    dev = _cuda()
    a, b = _gemm_operands(dev, a_shape, b_shape, 24)
    n = b.shape[-1] if kn else b.shape[-2]
    c = (torch.from_numpy(np.random.RandomState(25).randn(n).astype(
        np.float32)).to(dev) if bias else None)
    before = g.gemm_tf32x3_lockstep.launches
    got = g.gemm_tf32x3(a, b, kn, alpha, c)
    old = g.gemm_tf32x3_lockstep(a, b, kn, alpha, c)
    torch.cuda.synchronize()
    assert g.gemm_tf32x3_lockstep.launches == before + 1
    assert torch.equal(got, old)


@pytest.mark.cuda
def test_gemm_takes_aligned_rows_by_tma_and_unaligned_ones_as_supersets():
    """Every linear's rows and the (B, H, S, D) head views go by the
    tensor map; P's rows of 50, 197 and 257 floats as 16-byte-aligned
    supersets, with nothing past the tensor read: the last row of a
    tensor that ends at its allocation's end, at every offset."""
    from video_features_torch.ops import gemm_tf32x3 as g
    dev = _cuda()
    q, _ = _gemm_operands(dev, 'qkv', (2, 197, 12, 64), 26)
    assert g.a_by_tma(q) and g.a_by_tma(torch.randn(394, 768, device=dev))
    for tokens in (50, 197, 257):
        p, v = _gemm_operands(dev, 'pv', (2, tokens, 12, 64), 27)
        assert not g.a_by_tma(p)
        # P at each float offset from a 16-byte boundary, its last row the
        # allocation's last floats
        for offset in range(4):
            store = torch.empty(offset + p.numel(), device=dev)
            shifted = store[offset:].view(p.shape).copy_(p)
            got = g.gemm_tf32x3(shifted, v, True)
            want = g.gemm_tf32x3_plain(p, v, True)
            torch.cuda.synchronize()
            assert ((got - want).norm() / want.norm()).item() <= GEMM_REL_L2


@pytest.mark.cuda
def test_gemm_weight_packs_live_as_long_as_their_weight():
    """A shared B is packed once (``gemm_tf32x3.packs``): a second call
    reuses it, an in-place update packs anew (and the result follows the
    update), a ``(K, N)`` weight is packed transposed, and the pack dies
    with its weight."""
    import gc
    from video_features_torch.ops import gemm_tf32x3 as g, weight_packs
    dev = _cuda()
    rng = np.random.RandomState(28)
    a = torch.from_numpy(rng.randn(3, 70, 96).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(40, 96).astype(np.float32)).to(dev)
    proj = torch.from_numpy(rng.randn(96, 24).astype(np.float32)).to(dev)
    packs, held = g.gemm_tf32x3.packs, weight_packs.device_bytes()
    first = g.gemm_tf32x3(a, w)
    second = g.gemm_tf32x3(a, w)
    assert g.gemm_tf32x3.packs == packs + 1 and torch.equal(first, second)
    assert weight_packs.device_bytes() > held
    w.mul_(2.0)
    third = g.gemm_tf32x3(a, w)
    assert g.gemm_tf32x3.packs == packs + 2
    torch.cuda.synchronize()
    assert torch.equal(third, 2.0 * first)          # exact: a power of two
    got = g.gemm_tf32x3(a, proj, True)
    want = g.gemm_tf32x3_plain(a, proj, True)
    assert g.gemm_tf32x3.packs == packs + 3
    torch.cuda.synchronize()
    assert ((got - want).norm() / want.norm()).item() <= GEMM_REL_L2
    live = weight_packs.live()
    del w, proj
    gc.collect()
    assert weight_packs.live() == live - 2


@pytest.mark.cuda
def test_gemm_kernel_raises_on_what_it_does_not_take():
    from video_features_torch.ops import gemm_tf32x3 as g
    dev = _cuda()
    a = torch.randn(4, 8, 16, device=dev)
    with pytest.raises(ValueError, match='contiguous along its last axis'):
        g.gemm_tf32x3(a.transpose(-1, -2), torch.randn(8, 8, device=dev))
    with pytest.raises(ValueError, match='float32'):
        g.gemm_tf32x3(a.half(), torch.randn(8, 16, device=dev).half())
    with pytest.raises(ValueError, match='agree on K'):
        g.gemm_tf32x3(a, torch.randn(8, 15, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize('xs,k,stride,padding', DWCONV_GEOMETRIES)
def test_dwconv_kernel_matches_plain_on_the_card(xs, k, stride, padding):
    """One launch per call against cuDNN's fp32 depthwise convolution at
    rel L2 <= 1e-6, with and without a bias."""
    from video_features_torch.ops import dwconv
    dev = _cuda()
    rng = np.random.RandomState(23)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(xs[-1], 1, k, k) * 0.1).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(xs[-1]).astype(np.float32)).to(dev)
    before = dwconv.dwconv_f32.launches
    for bias in (b, None):
        got = dwconv.dwconv_f32(x, w, stride, padding, bias)
        want = dwconv.dwconv_f32_plain(x, w, stride, padding, bias)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert ((got - want).norm() / want.norm()).item() <= DWCONV_REL_L2
    assert dwconv.dwconv_f32.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize('xs,k,stride,padding', DWCONV_GEOMETRIES)
def test_dwconv_kernel_is_byte_equal_to_the_staged_design(xs, k, stride,
                                                          padding):
    """The register-blocked kernel sums each output's taps in the staged
    design's order (``fmaf`` from 0, row-major), so its bytes are the
    staged yardstick's, with and without a bias, on every map size,
    stride and channel count."""
    from video_features_torch.ops import dwconv
    dev = _cuda()
    rng = np.random.RandomState(29)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(xs[-1], 1, k, k).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.randn(xs[-1]).astype(np.float32)).to(dev)
    before = dwconv.dwconv_f32_staged.launches
    for bias in (b, None):
        got = dwconv.dwconv_f32(x, w, stride, padding, bias)
        old = dwconv.dwconv_f32_staged(x, w, stride, padding, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, old)
    assert dwconv.dwconv_f32_staged.launches == before + 2
