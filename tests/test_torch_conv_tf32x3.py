"""The three-pass lane of the i3d and raft families on the CPU: the 3xTF32
convolution's wrapper, plain version and weight pack
(video_features_torch/ops/conv_tf32x3.py), the route of every
convolution (ops/nn.py::conv_route), the lane's flags per extractor and
thread (utils/device.py), ``precision=mixed`` and ``high`` against the
JAX package's lanes, the run fingerprint, and the two repairs that came
with it: the profiler's precision scope (tools/profile_torch_i3d.py) and
the manifest's ``note_ingress`` and ``note_slo``."""
import contextlib
import hashlib
import threading
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.extract import i3d as jax_i3d_extract
from video_features_tpu.models import i3d as jax_i3d
from video_features_tpu.models import raft as jax_raft
from video_features_tpu.obs.manifest import RunManifest as JaxRunManifest
from video_features_tpu.registry import create_extractor as jax_create
from video_features_torch import registry
from video_features_torch.cache import key
from video_features_torch.config import load_config
from video_features_torch.extract import i3d as i3d_extract
from video_features_torch.models import i3d as i3d_model
from video_features_torch.models import raft as raft_model
from video_features_torch.models.i3d import tf_same_pads
from video_features_torch.obs.manifest import RunManifest
from video_features_torch.ops import conv_tf32x3 as k
from video_features_torch.ops import nn
from video_features_torch.ops.gru import K_ORDER, tf32_split
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import params_from_jax, params_from_torch
from video_features_torch.utils import device

JAX_REL_L2 = 1e-5       # float32 on both sides, different sum orders
EMULATED_REL_L2 = 1e-6  # 3xTF32 against fp32: the dropped lo·lo, ~2^-22
# the i3d flow feature crosses RAFT's uint8 quantization (a level that
# flips moves a feature by far more than RAFT's drift): the BASELINE bar,
# with the stream's two halves held to JAX_REL_L2 apart
FLOW_FEATURE_REL_L2 = 1e-3

# every conv geometry on the two paths, narrowed: (x shape, weight shape,
# stride, padding)
GEOMETRIES = {
    'i3d_rgb_conv1': ((1, 8, 20, 20, 3), (8, 3, 7, 7, 7), 2,
                      tf_same_pads((7, 7, 7), (2, 2, 2))),
    'i3d_flow_conv1': ((1, 8, 20, 20, 2), (8, 2, 7, 7, 7), 2,
                       tf_same_pads((7, 7, 7), (2, 2, 2))),
    'i3d_3x3x3': ((1, 4, 6, 6, 16), (24, 16, 3, 3, 3), 1,
                  tf_same_pads((3, 3, 3), (1, 1, 1))),
    'i3d_1x1x1': ((1, 2, 3, 3, 36), (20, 36, 1, 1, 1), 1, 0),
    'raft_conv1': ((2, 16, 20, 3), (16, 3, 7, 7), 2, 3),
    'raft_stride2_3x3': ((1, 10, 12, 64), (96, 64, 3, 3), 2, 1),
    'raft_downsample': ((1, 10, 12, 64), (96, 64, 1, 1), 2, 0),
    'convc1': ((1, 4, 6, 324), (40, 324, 1, 1), 1, 0),
    'convf1': ((1, 8, 9, 2), (24, 2, 7, 7), 1, 3),
    'flow_head_conv2': ((1, 8, 9, 40), (2, 40, 3, 3), 1, 1),
    'gru_inp_1x5': ((1, 5, 7, 24), (20, 24, 1, 5), 1, [(0, 0), (2, 2)]),
    'mask_head_1x1': ((1, 3, 4, 32), (136, 32, 1, 1), 1, 0),
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: convolutions held to 1e-5 and below, and the
    tier-1 run has several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _inputs(name, seed=0):
    xs, ws, stride, padding = GEOMETRIES[name]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32))
    w = torch.from_numpy((rng.randn(*ws) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32))
    return x, w, b, stride, padding


def kernel_gemm(x, weight, stride, padding, bias):
    """The kernel's implicit GEMM written out on the CPU, in float64: rows
    are output pixels, K the kernel's order (taps row-major, each tap's
    channels padded to 4, a 2- or 3-channel input padded to 4 as the
    wrapper pads it, the whole K padded to the chunks' 32, so a chunk may
    span taps), times the matrix the packed operand holds
    (:func:`unpack_matrix`, which :func:`unpack_weight` reads): the
    contract between the pack and the kernel's K order."""
    n = weight.ndim - 2
    x5 = x if n == 3 else x[:, None]
    w5 = weight if n == 3 else weight[:, :, None]
    strides = (1,) * (3 - n) + k._tuple(stride, n)
    pairs = [(0, 0)] * (3 - n) + nn._pad_pairs(padding, n)
    N, T, H, W, C = x5.shape
    O, _, KT, KH, KW = w5.shape
    c4 = -(-C // k.C_GROUP) * k.C_GROUP
    out = [(s + lo + hi - kk) // st + 1 for s, (lo, hi), kk, st in
           zip((T, H, W), pairs, (KT, KH, KW), strides)]
    xp = torch.nn.functional.pad(nn.pad_spatial(x5.double(), pairs),
                                 (0, c4 - C))
    packed = k.pack_weight(weight)
    cols = []
    for dt in range(KT):
        for dh in range(KH):
            for dw in range(KW):
                patch = xp[:, dt:dt + strides[0] * (out[0] - 1) + 1:strides[0],
                           dh:dh + strides[1] * (out[1] - 1) + 1:strides[1],
                           dw:dw + strides[2] * (out[2] - 1) + 1:strides[2]]
                cols.append(patch.reshape(-1, c4))
    a = torch.cat(cols, dim=1)
    b = k.unpack_matrix(packed).double()
    assert b.shape[0] == packed.shape[1] * k.K_CHUNK >= a.shape[1]
    a = torch.nn.functional.pad(a, (0, b.shape[0] - a.shape[1]))
    y = a @ b[:, :O] + bias.double()
    return y.reshape(N, *out[3 - n:], O)


# -- the wrapper, its plain version and the pack ------------------------------


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_plain_is_the_fp32_library_conv(name):
    """The plain version is ``ops/nn.py::conv`` in fp32 (outside any
    route), and a CPU tensor takes it, with no launch."""
    x, w, b, stride, padding = _inputs(name)
    want = nn.conv(x, w, stride, padding, b)
    launches = k.conv_tf32x3.launches
    assert torch.equal(k.conv_tf32x3_plain(x, w, stride, padding, b), want)
    assert torch.equal(k.conv_tf32x3(x, w, stride, padding, b), want)
    assert k.conv_tf32x3.launches == launches


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_three_pass_arithmetic_holds_fp32(name):
    """The kernel's arithmetic emulated: the ``tf32_split`` operands in
    three fp32 convolutions, lo·hi + hi·lo + hi·hi, against the plain
    version; and the pack's K order through the kernel's implicit GEMM
    written out in float64."""
    x, w, b, stride, padding = _inputs(name, seed=1)
    plain = k.conv_tf32x3_plain(x, w, stride, padding, b)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    emulated = (nn.library_conv(xl, wh, stride, padding)
                + nn.library_conv(xh, wl, stride, padding)
                + nn.library_conv(xh, wh, stride, padding, b))
    assert rel_l2(emulated, plain) <= EMULATED_REL_L2
    gemm = kernel_gemm(x, w, stride, padding, b)
    assert gemm.shape == plain.shape
    assert rel_l2(gemm, plain) <= EMULATED_REL_L2


def _packed_at(packed, n, k_index):
    """The packed operand's (hi, lo) for output channel n at K index
    k_index: the channel's tile and row, the K chunk, the row's position
    in the fragment order (``ops/gru.py::K_ORDER``) and the 128-byte
    swizzle (16-byte chunk j of row r at j ^ (r % 8))."""
    tile, row = divmod(n, packed.shape[3])
    chunk, r = divmod(k_index, k.K_CHUNK)
    pos = K_ORDER.index(r)
    col = ((pos // 4) ^ (row % 8)) * 4 + pos % 4
    return packed[tile, chunk, 0, row, col], packed[tile, chunk, 1, row, col]


def test_pack_weight_layout():
    """(O, I, *k) → (tiles, chunks, 2, bn, 32): K over the taps, each
    tap's channels padded to 4 (a chunk spans taps), O in equal tiles,
    TF32 hi and lo parts in the fragment order and the swizzle; zeros in
    every pad."""
    w = torch.randn(192, 6, 3, 3)           # 8 channels a tap: 72 K
    packed = k.pack_weight(w)
    assert packed.shape == (2, 3, 2, 96, 32)
    hi, lo = tf32_split(w.reshape(192, 6, 9))
    for n, tap, c in ((0, 0, 0), (101, 4, 5), (191, 8, 3), (57, 3, 2),
                      (95, 7, 0), (96, 5, 1)):
        # tap 3's channels 0..5 are K 24..29, chunk 0; tap 4's are chunk 1
        got = _packed_at(packed, n, tap * 8 + c)
        assert (got[0].item(), got[1].item()) == (hi[n, c, tap].item(),
                                                  lo[n, c, tap].item())
    m = k.unpack_matrix(packed)
    assert m.shape == (96, 192)
    for tap in range(9):
        assert not m[tap * 8 + 6:tap * 8 + 8].any()     # channels 6, 7
    assert not m[72:].any()                             # past K
    assert torch.equal(m[:6], (hi + lo)[:, :, 0].T)
    # the flow head: one tile of 8 for 2 output channels
    w = torch.randn(2, 256, 3, 3)
    packed = k.pack_weight(w)
    assert packed.shape == (1, 72, 2, 8, 32)
    assert not k.unpack_matrix(packed)[:, 2:].any()
    # a 3-channel stem: 4 K per tap, 8 taps a chunk, 343 taps in 43 chunks
    w = torch.randn(8, 3, 7, 7, 7)
    packed = k.pack_weight(w)
    assert packed.shape == (1, 43, 2, 8, 32)
    m = k.unpack_matrix(packed)
    assert not m[3:1372:4].any() and not m[1372:].any()
    hi, lo = tf32_split(w.reshape(8, 3, 343))
    assert torch.equal(m[4 * 100:4 * 100 + 3, :8], (hi + lo)[:, :, 100].T)


# the path's weight shapes (I3D, RAFT): O = 2, 126, 192, 576 among them
PATH_WEIGHTS = [(64, 3, 7, 7, 7), (64, 2, 7, 7, 7), (192, 64, 3, 3, 3),
                (32, 16, 3, 3, 3), (64, 24, 3, 3, 3), (128, 48, 3, 3, 3),
                (288, 144, 3, 3, 3), (320, 160, 3, 3, 3), (24, 512, 1, 1, 1),
                (64, 3, 7, 7), (96, 64, 3, 3), (256, 324, 1, 1),
                (192, 256, 3, 3), (128, 2, 7, 7), (126, 256, 3, 3),
                (2, 256, 3, 3), (576, 256, 1, 1), (256, 128, 1, 5)]


@pytest.mark.parametrize('shape', PATH_WEIGHTS)
def test_pack_round_trip(shape):
    """``unpack_weight(pack_weight(w))`` is w's TF32 parts summed, hi +
    lo, exactly; the packed shape is ``packed_shape``'s."""
    w = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(
        np.float32))
    packed = k.pack_weight(w)
    assert tuple(packed.shape) == k.packed_shape(shape)
    hi, lo = tf32_split(w)
    assert torch.equal(k.unpack_weight(packed, shape), hi + lo)


def test_conv_plan():
    """Equal output tiles of a template width with the least padding,
    128-pixel blocks unless that leaves SMs without one."""
    assert k.channel_tiles(2) == (8, 1)
    assert k.channel_tiles(192) == (96, 2)
    assert k.channel_tiles(576) == (96, 6)
    assert k.channel_tiles(126) == (128, 1)
    assert k.channel_tiles(320) == (80, 4)
    # the RAFT family's per-iteration convolutions (M = 8 x 32 x 42)
    assert k.conv_plan(10752, 128) == k.Plan(64, 128, 1)
    assert k.conv_plan(10752, 2) == k.Plan(64, 8, 1)
    assert k.conv_plan(10752, 256) == k.Plan(128, 128, 2)
    assert k.conv_plan(176128, 192) == k.Plan(128, 96, 2)
    for o in range(1, 1025):
        bn, tiles = k.channel_tiles(o)
        assert bn in k.TILE_WIDTHS and bn % 8 == 0 and bn <= 128
        assert (tiles - 1) * bn < o <= tiles * bn
        assert tiles in (-(-o // 128), -(-o // 128) + 1)
    with pytest.raises(ValueError, match='output channels'):
        k.channel_tiles(0)


@pytest.mark.parametrize('iters', [3, 20])
def test_a_raft_forward_packs_each_per_iteration_weight_once(monkeypatch,
                                                             iters):
    """On the kernel's route a RAFT forward packs each of its seven
    per-iteration weights (the motion encoder's five, the flow head's two)
    once, whatever the iterations, and gives the plain route's flow."""
    params = params_from_torch(raft_model.init_state_dict(2))
    packs = []
    pack = k.pack_weight
    monkeypatch.setattr(k, 'pack_weight',
                        lambda w: packs.append(w) or pack(w))
    frames = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8))
    with torch.inference_mode():
        flow = raft_model.forward_consecutive(params, frames, iters=iters,
                                              three_pass_convs=True)
        plain = raft_model.forward_consecutive(params, frames, iters=iters,
                                               plain_kernels=True,
                                               three_pass_convs=True)
    up = params['update_block']
    weights = ([up['encoder'][n]['weight']
                for n in ('convc1', 'convc2', 'convf1', 'convf2', 'conv')]
               + [up['flow_head'][n]['weight'] for n in ('conv1', 'conv2')])
    assert [sum(p is w for p in packs) for w in weights] == [1] * 7
    assert len(packs) == 7      # the CPU packs nothing else: plain versions
    assert torch.equal(flow, plain)


@pytest.mark.parametrize('case,match', [
    ('groups', 'groups=1'), ('bf16', 'float32'), ('strided', 'contiguous'),
    ('bias', 'bias must be'), ('pad', 'pads >= 0'), ('stride', 'strides >= 1'),
    ('1d', '2-D'), ('empty', 'empty output'), ('meta', 'unsupported device'),
    ('pairs', 'one per spatial axis')])
def test_check_refuses_what_the_kernel_does_not_take(case, match):
    x, w, b, stride, padding = _inputs('raft_stride2_3x3')
    args = dict(x=x, weight=w, stride=stride, padding=padding, bias=b)
    if case == 'groups':
        args['weight'] = w[:, :32].contiguous()
    elif case == 'bf16':
        args['x'] = x.bfloat16()
    elif case == 'strided':
        args['x'] = x.transpose(1, 2)
    elif case == 'bias':
        args['bias'] = b[:3]
    elif case == 'pad':
        args['padding'] = [(1, -1), (1, 1)]
    elif case == 'stride':
        args['stride'] = 0
    elif case == '1d':
        args['x'], args['weight'] = x[0], w[:, :, 0]
    elif case == 'empty':
        args['x'], args['padding'] = x[:, :2, :2].contiguous(), 0
    elif case == 'meta':
        args = {n: (t.to('meta') if isinstance(t, torch.Tensor) else t)
                for n, t in args.items()}
    elif case == 'pairs':
        args['padding'] = [(1, 1)] * 3
    with pytest.raises(ValueError, match=match):
        k.conv_tf32x3(**args)


def test_conv_route_values_and_restore():
    x, w, b, stride, padding = _inputs('convf1')
    seen = []
    with pytest.raises(ValueError, match='route must be'):
        with nn.conv_route('fast'):
            pass
    assert nn._CONV_ROUTE.get() is None
    with nn.conv_route('plain'):
        with nn.three_pass_route(False):
            seen.append(nn._CONV_ROUTE.get())
        with nn.three_pass_route(True):
            seen.append(nn._CONV_ROUTE.get())
        seen.append(nn._CONV_ROUTE.get())
        # a grouped convolution takes the route too (the plain version
        # here); one the kernel cannot tile raises on the kernel's route
        # rather than falling back to the library
        assert torch.equal(nn.conv(x, w[:, :1], stride, padding, b, groups=2),
                           nn.library_conv(x, w[:, :1], stride, padding, b, 2))
        with nn.conv_route('kernel'), pytest.raises(ValueError,
                                                    match='no tile'):
            nn.conv(x, w[:, :1], stride, padding, b, groups=2)
    assert seen == ['plain', 'kernel', 'plain'] and nn._CONV_ROUTE.get() is None


# -- the route: every convolution of the two steps, under high and mixed ------


def _args(tmp_path, ft, precision, **kw):
    return dict({'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
                 'allow_random_weights': True, 'precision': precision,
                 'output_path': str(tmp_path / 'out')}, **kw)


@pytest.fixture
def spies(monkeypatch):
    """Calls of the kernel's wrapper, its plain version and the library
    convolution, each with the TF32 flags in force."""
    calls = {'kernel': [], 'plain': [], 'library': []}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls[name].append((torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32,
                                threading.current_thread().name))
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(k, 'conv_tf32x3', spy('kernel', k.conv_tf32x3))
    monkeypatch.setattr(k, 'conv_tf32x3_plain',
                        spy('plain', k.conv_tf32x3_plain))
    monkeypatch.setattr(nn, 'library_conv', spy('library', nn.library_conv))
    return calls


def raft_convs(iters: int, encoder_calls: int = 2) -> int:
    """The code's count of convolutions in a RAFT forward: 16 per
    encoder call (fnet once over the unique frames, cnet once), the 4
    context terms, 7 per iteration (motion encoder 5, flow head 2) and
    the mask head's 2."""
    return 16 * encoder_calls + 4 + 7 * iters + 2


I3D_TOWER_CONVS = 57        # 3 stem units and 9 Mixed blocks of 6


def test_the_code_counts_match_the_issue_reckoning():
    """178 per RAFT forward at 20 iterations, 292 per fused step."""
    assert raft_convs(20) == 178
    assert raft_convs(20) + 2 * I3D_TOWER_CONVS == 292


@pytest.mark.parametrize('precision', ['high', 'mixed', 'highest',
                                       'tensorfloat32'])
@pytest.mark.parametrize('iters', [1, 2])
def test_raft_step_routes_every_conv(tmp_path, spies, precision, iters):
    ex = create_extractor(load_config('raft', _args(
        tmp_path, 'raft', precision, batch_size=1, raft_iters=iters)))
    frames = np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    ex.run_step(frames)
    three = precision in ('high', 'mixed')
    assert ex.three_pass_convs == three
    assert len(spies['kernel']) == (raft_convs(iters) if three else 0)
    # on the CPU the wrapper takes its plain version
    assert len(spies['plain']) == len(spies['kernel'])
    assert len(spies['library']) == (0 if three else raft_convs(iters))
    assert ex.kernel_libraries() == ()          # the CPU builds nothing


@pytest.mark.parametrize('precision', ['high', 'mixed', 'highest',
                                       'tensorfloat32'])
def test_fused_i3d_step_routes_every_conv(tmp_path, spies, precision):
    ex = create_extractor(load_config('i3d', _args(
        tmp_path, 'i3d', precision, stack_size=10, step_size=10,
        batch_size=1, raft_iters=1)))
    stacks = np.random.RandomState(3).randint(
        0, 256, (1, 11, 64, 64, 3)).astype(np.uint8)
    ex.run_step(stacks)
    three = precision in ('high', 'mixed')
    want = raft_convs(1) + 2 * I3D_TOWER_CONVS
    assert len(spies['kernel']) == (want if three else 0)
    # inside the step the libraries keep TF32 off on this lane
    assert {c[:2] for c in spies['kernel']} <= {(False, False)}
    assert len(spies['library']) == (0 if three else want)


def test_plain_kernels_take_the_plain_convolution(spies):
    """``plain_kernels`` sends every convolution of the lane to the plain
    version, as it does the lookup and the GRU direction."""
    p = {'rgb': params_from_torch(i3d_model.init_state_dict(0, 'rgb')),
         'flow': params_from_torch(i3d_model.init_state_dict(1, 'flow')),
         'raft': params_from_torch(raft_model.init_state_dict(2))}
    stacks = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (1, 11, 64, 64, 3)).astype(np.uint8))
    with torch.inference_mode():
        i3d_extract.fused_two_stream_step(
            p, stacks, (0, 0, 0, 0), ('rgb', 'flow'), crop_size=64,
            raft_iters=1, plain_kernels=True, three_pass_convs=True)
    assert not spies['kernel']
    assert len(spies['plain']) == raft_convs(1) + 2 * I3D_TOWER_CONVS


def test_kernel_libraries_name_the_conv_only_on_the_lane(monkeypatch,
                                                         tmp_path):
    """On the card i3d and raft list ``conv_tf32x3`` under high and mixed
    only, so a highest run neither builds nor fetches it."""
    for ft, base in (('raft', ('corr_lookup', 'gru_direction')),
                     ('i3d', ('corr_lookup', 'gru_direction'))):
        for precision in ('highest', 'high', 'mixed', 'tensorfloat32'):
            ex = create_extractor(load_config(ft, _args(
                tmp_path, ft, precision, batch_size=1, raft_iters=1)))
            monkeypatch.setattr(ex, 'device', torch.device('cuda'))
            three = precision in ('high', 'mixed')
            assert ex.kernel_libraries() == base + (
                ('conv_tf32x3',) if three else ()), (ft, precision)
    ex = create_extractor(load_config('i3d', _args(
        tmp_path, 'i3d', 'mixed', streams='rgb')))
    monkeypatch.setattr(ex, 'device', torch.device('cuda'))
    assert ex.kernel_libraries() == ('conv_tf32x3',)


def test_the_mixed_raft_program_has_one_conv_node_per_convolution():
    """Traced for the card on fake CUDA tensors (``analysis/programs.py``),
    the RAFT family's step under mixed holds one ``vft::conv_tf32x3`` node
    per convolution beside the lock's 20 lookups and 40 GRU directions."""
    from video_features_torch.analysis import programs
    ex = programs.build_family('raft', overrides={'precision': 'mixed'})
    sig, _ = programs.program_signature(ex.program_specs()[0])
    vft = {name: n for name, n in sig['ops'].items()
           if name.startswith('vft.')}
    assert vft == {'vft.conv_tf32x3.default': raft_convs(20),
                   'vft.corr_lookup_lanes.default': 20,
                   'vft.gru_direction.default': 40}
    assert sig['kernels'] == sum(vft.values())


# -- the lane's flags ---------------------------------------------------------


THREE_PASS_FAMILIES = ('i3d', 'raft', 'r21d', 's3d', 'resnet', 'vggish',
                       'clip', 'timm')


def test_lane_table():
    for ft in registry.EXTRACTORS:
        for precision in device.PRECISIONS:
            three = ft in THREE_PASS_FAMILIES and precision in ('high', 'mixed')
            assert device.three_pass_convs(precision, ft) == three
            assert device.library_tf32(precision, ft) == (
                device.LANES[precision][0] and not three)
    assert not device.three_pass_convs('high', None)
    with pytest.raises(ValueError, match='precision must be one of'):
        device.three_pass_convs('bogus', 'i3d')


def test_i3d_and_clip_mixed_on_two_threads_see_their_own_flags(
        tmp_path, spies, monkeypatch):
    """An i3d-mixed extractor (every conv through the 3xTF32 op, TF32 off,
    its products left to the libraries) and a clip-mixed one (its patch
    conv through the 3xTF32 op and every linear and product through the
    3xTF32 GEMM, TF32 off) stepping at once on two threads: each sees its
    own flags and route, and the flags found are restored."""
    from video_features_torch.ops import gemm_tf32x3
    gemms = []
    gemm = gemm_tf32x3.gemm_tf32x3
    monkeypatch.setattr(gemm_tf32x3, 'gemm_tf32x3', lambda *a: gemms.append((
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
        threading.current_thread().name)) or gemm(*a))
    i3d_ex = create_extractor(load_config('i3d', _args(
        tmp_path, 'i3d', 'mixed', streams='rgb', stack_size=10,
        step_size=10, batch_size=1)))
    clip_ex = create_extractor(load_config('clip', _args(
        tmp_path, 'clip', 'mixed')))
    stacks = np.random.RandomState(5).randint(
        0, 256, (1, 11, 64, 64, 3)).astype(np.uint8)
    frames = np.random.RandomState(6).randint(      # ViT-B/32's own size
        0, 256, (1, 224, 224, 3)).astype(np.uint8)
    outside = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
    start = threading.Barrier(2)
    errors = []

    def run(ex, batch):
        try:
            start.wait()
            for _ in range(2):
                ex.run_step(batch)
        except BaseException as e:          # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=a, name=n) for n, a in
               (('i3d', (i3d_ex, stacks)), ('clip', (clip_ex, frames)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert {c for c in spies['kernel']} == {(False, False, 'i3d'),
                                             (False, False, 'clip')}
    assert [c[2] for c in spies['kernel']].count('i3d') == 2 * I3D_TOWER_CONVS
    assert [c[2] for c in spies['kernel']].count('clip') == 2    # the patch conv
    assert set(gemms) == {(False, False, 'clip')}
    assert len(gemms) == 2 * (12 * 6 + 1)     # 12 blocks of 6, the projection
    assert not spies['library']
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == outside


# -- mixed loads, and holds the JAX package's mixed -------------------------------


@pytest.mark.parametrize('ft', ['i3d', 'raft'])
def test_mixed_loads_for_i3d_and_raft(tmp_path, ft):
    assert registry.MIXED_REFUSALS == {}
    assert ft in registry.MIXED_FEATURES
    assert load_config(ft, _args(tmp_path, ft, 'mixed'))['precision'] == 'mixed'


@pytest.fixture(scope='module')
def jax_i3d_mixed(tmp_path_factory):
    """The JAX package's mixed lane (its extractor's scope) on seeded
    weights at the existing small size: one stack of 11 64×64 frames,
    RAFT at 2 iterations; the fused step, RAFT's raw flow and the flow
    tower on the JAX quantized flow input, each jitted."""
    tmp = tmp_path_factory.mktemp('jax_i3d_mixed')
    jex = jax_create(jax_load_config('i3d', overrides={
        'video_paths': str(tmp / 'v.mp4'), 'device': 'cpu',
        'precision': 'mixed', 'allow_random_weights': True,
        'output_path': str(tmp / 'out'), 'tmp_path': str(tmp / 'tmp')}))
    stacks = np.random.RandomState(7).randint(
        0, 256, (1, 11, 64, 64, 3)).astype(np.uint8)
    pads = (0, 0, 0, 0)
    with jex.precision_scope():
        step = jax.jit(partial(
            jax_i3d_extract.fused_two_stream_step, pads=pads,
            streams=('rgb', 'flow'), crop_size=64, platform='cpu',
            raft_iters=2))
        out = step(jex.params, jnp.asarray(stacks))
        raw = jax.jit(partial(jax_raft.forward_stack_pairs, iters=2,
                              platform='cpu'))(jex.params['raft'],
                                               jnp.asarray(stacks))
        flow_in = jax.jit(partial(
            jax_i3d_extract.flow_stream_input, pads=pads, crop_size=64,
            platform='cpu', raft_iters=2))(jex.params['raft'],
                                           jnp.asarray(stacks))
        tower = jax.jit(partial(jax_i3d.forward, features=True))(
            jex.params['flow'], flow_in)
    params = {s: params_from_jax(jex.params[s]) for s in ('rgb', 'flow', 'raft')}
    return {'params': params, 'stacks': stacks, 'pads': pads,
            'out': {s: np.asarray(v) for s, v in out.items()},
            'raw': np.asarray(raw), 'flow_in': np.asarray(flow_in),
            'tower': np.asarray(tower)}


def test_i3d_mixed_holds_the_jax_mixed_step(jax_i3d_mixed, tmp_path):
    """The port's fused step under mixed (its extractor's lane) against the
    JAX package's: the rgb stream, RAFT's raw flow and the flow tower on
    one input at JAX_REL_L2; the flow feature, across the uint8
    quantization, at the BASELINE bar."""
    j = jax_i3d_mixed
    ex = create_extractor(load_config('i3d', _args(
        tmp_path, 'i3d', 'mixed', stack_size=10, step_size=10,
        batch_size=1, raft_iters=2)))
    assert ex.three_pass_convs
    x = torch.from_numpy(j['stacks'])
    with torch.inference_mode(), ex.precision_scope():
        got = i3d_extract.fused_two_stream_step(
            j['params'], x, j['pads'], ('rgb', 'flow'), crop_size=64,
            raft_iters=2, three_pass_convs=ex.three_pass_convs)
        raw = raft_model.forward_stack_pairs(
            j['params']['raft'], x, iters=2, three_pass_convs=True)
        tower = i3d_model.forward(j['params']['flow'],
                                  torch.from_numpy(j['flow_in']),
                                  three_pass_convs=True)
    assert rel_l2(got['rgb'], j['out']['rgb']) <= JAX_REL_L2
    assert rel_l2(raw, j['raw']) <= JAX_REL_L2
    assert rel_l2(tower, j['tower']) <= JAX_REL_L2
    assert rel_l2(got['flow'], j['out']['flow']) <= FLOW_FEATURE_REL_L2


@pytest.fixture(scope='module')
def jax_raft_mixed(tmp_path_factory):
    """The JAX package's RAFT extractor under mixed (batch 2, 2
    iterations): its jitted step on 3 seeded 64×88 frames (already /8)."""
    tmp = tmp_path_factory.mktemp('jax_raft_mixed')
    jex = jax_create(jax_load_config('raft', overrides={
        'video_paths': str(tmp / 'v.mp4'), 'device': 'cpu',
        'precision': 'mixed', 'batch_size': 2, 'raft_iters': 2,
        'allow_random_weights': True, 'output_path': str(tmp / 'out'),
        'tmp_path': str(tmp / 'tmp')}))
    frames = np.random.RandomState(8).randint(
        0, 256, (3, 64, 88, 3)).astype(np.uint8)
    with jex.precision_scope():
        flow = np.asarray(jex._step(jex.params, jnp.asarray(frames)))
    return jex, frames, flow


def test_raft_mixed_holds_the_jax_mixed_step(jax_raft_mixed, tmp_path):
    jex, frames, want = jax_raft_mixed
    ex = create_extractor(load_config('raft', _args(
        tmp_path, 'raft', 'mixed', batch_size=2, raft_iters=2)))
    ex.params = params_from_jax(jex.params)
    got = ex.run_step(frames)['raft']
    assert got.shape == want.shape == (2, 64, 88, 2)
    for a, b in zip(got, want):                    # per flow field
        assert rel_l2(a, b) <= JAX_REL_L2


# -- the fingerprint -----------------------------------------------------------


def _old_fingerprint(args):
    """``config_fingerprint`` as it was before the three-pass lane."""
    relevant = {kk: v for kk, v in args.items()
                if kk not in key.CONFIG_KEY_EXCLUDE
                and not key.is_file_key(kk)}
    if relevant.get('compute_dtype') is None:
        relevant['compute_dtype'] = 'float32'
    return hashlib.sha256(key._canonical(relevant).encode()).hexdigest()


@pytest.mark.parametrize('ft', sorted(registry.EXTRACTORS))
def test_the_fingerprint_separates_the_three_pass_lane(tmp_path, ft):
    """Every family under high and mixed keys apart from every key it had
    before (a cached or resumed high output of the TF32 lane, or of the
    three-pass lane's earlier mma.sync kernel, never answers), clip and
    timm on the token that names their GEMM and depthwise kernel too;
    every other lane keeps its key."""
    assert key.THREE_PASS_TOKEN == 'conv_tf32x3.wgmma'
    for precision in device.PRECISIONS:
        overrides = _args(tmp_path, ft, precision)
        if ft == 'timm':
            overrides['model_name'] = 'vit_tiny_patch16_224'
        args = load_config(ft, overrides)
        new, old = key.config_fingerprint(args), _old_fingerprint(args)
        if ft in THREE_PASS_FAMILIES and precision in ('high', 'mixed'):
            assert new != old
            token = (key.THREE_PASS_PRODUCTS_TOKEN if ft in ('clip', 'timm')
                     else key.THREE_PASS_TOKEN)
            assert new == _old_fingerprint(dict(args, lane_arithmetic=token))
            # nor does an output of the mma.sync kernel, whose bytes differ
            assert new != _old_fingerprint(dict(
                args, lane_arithmetic='conv_tf32x3'))
        else:
            assert new == old, (ft, precision)


# -- the repairs ---------------------------------------------------------------


def test_profiler_layer_ms_runs_in_the_extractors_scope(tmp_path, spies,
                                                       monkeypatch):
    """``tools/profile_torch_i3d.py::layer_ms`` times each part inside the
    extractor's precision scope, with its lane's convolutions."""
    from tools import profile_torch_i3d
    ex = create_extractor(load_config('i3d', _args(
        tmp_path, 'i3d', 'high', stack_size=10, step_size=10,
        batch_size=1, raft_iters=1)))
    entered = []

    @contextlib.contextmanager
    def scope():
        entered.append(True)
        with device.precision_scope(ex.precision, ex.feature_type):
            yield
        entered.append(False)
    monkeypatch.setattr(ex, 'precision_scope', scope)
    timed = []

    def timer(torch_, fn, reps):
        timed.append(entered[-1])
        fn()
        return 0.0
    stacks = np.random.RandomState(9).randint(
        0, 256, (1, 11, 64, 64, 3)).astype(np.uint8)
    out = profile_torch_i3d.layer_ms(torch, ex, stacks, 1, timer=timer)
    assert set(out) == {'i3d_rgb', 'raft_flow_input', 'i3d_flow'}
    assert timed == [True] * 3 and entered == [True, False]
    # the flow input once, then each part once, all through the lane
    assert len(spies['kernel']) == 2 * raft_convs(1) + 2 * I3D_TOWER_CONVS
    for name in ('void (anonymous namespace)::conv_tf32x3_wgmma<2, 96>'
                 '((anonymous namespace)::Conv)',
                 'void (anonymous namespace)::mma::conv_tf32x3_mma<128, true>'
                 '((anonymous namespace)::mma::Geometry)'):
        assert profile_torch_i3d.group_of(name) == 'conv_tf32x3'


def test_manifest_notes_ingress_and_slo_as_the_jax_manifest():
    ingress = {'tenants': {'acme': {'requests': 3, 'shed': 1}},
               'live_sessions': 2, 'ratio': np.float32(0.5)}
    slo = {'objectives': {'latency_p99_s': 60.0},
           'burn': {'1h': np.float64(0.25)}, 'alerting': False}
    docs = []
    for cls in (RunManifest, JaxRunManifest):
        m = cls({'feature_type': 'resnet'})
        assert m.document()['ingress'] == {} and m.document()['slo'] == {}
        m.note_ingress(ingress)
        m.note_slo(slo)
        m.note_ingress({'live_sessions': 3})
        docs.append(m.document())
    ours, theirs = docs
    assert ours['ingress'] == theirs['ingress']
    assert ours['slo'] == theirs['slo']
    assert ours['ingress']['live_sessions'] == 3
