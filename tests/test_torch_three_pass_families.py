"""The three-pass lane of the r21d, s3d, resnet and vggish families on
the CPU: the 3xTF32 convolution's grouped mode (ops/conv_tf32x3.py: the
tile plan, the block-diagonal pack, the kernel's per-tile K written out,
the refusals), the route of every convolution of each family's step under
each ``precision`` value with the libraries' TF32 flags, the kernel
libraries the lane names, and ``precision=mixed`` and ``high`` against
the JAX package's ``mixed`` on seeded weights (resnet18, a narrowed
ResNeXt, r2plus1d_18, S3D, VGGish)."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.extract.resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.models import resnet as jax_resnet
from video_features_tpu.models import vggish as jax_vggish
from video_features_tpu.registry import create_extractor as jax_create
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch import registry
from video_features_torch.config import load_config
from video_features_torch.extract import resnet as resnet_extract
from video_features_torch.models import r21d as r21d_model
from video_features_torch.models import resnet as resnet_model
from video_features_torch.models import s3d as s3d_model
from video_features_torch.models import vggish as vggish_model
from video_features_torch.ops import conv_tf32x3 as k
from video_features_torch.ops import nn
from video_features_torch.ops.gru import tf32_split
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import flatten, params_from_jax
from video_features_torch.utils import device

JAX_REL_L2 = 1e-5       # float32 on both sides, different sum orders
EMULATED_REL_L2 = 1e-6  # 3xTF32 against fp32: the dropped lo·lo, ~2^-22
FAMILIES = ('resnet', 'r21d', 's3d', 'vggish')
THREE = ('high', 'mixed')

# a narrowed ResNeXt added to both packages' ARCHS: one bottleneck per
# layer, 4 groups of 2, 4, 8 and 16 channels (tiles of 8 over 4 and 2
# groups, then tiles inside one group)
NARROW = 'resnext_narrow_4x2d'
NARROW_ARCH = dict(block='bottleneck', layers=[1, 1, 1, 1], feat_dim=2048,
                   groups=4, base_width=2)
NARROW_CONVS = 1 + 3 * 4 + 4   # stem, 4 bottlenecks of 3 (4 grouped), 4 downsamples

# grouped geometries: (x shape, weight shape, groups, stride, padding);
# ResNeXt's widths narrowed in space
GROUPED = {
    'resnext50_layer1': ((1, 6, 7, 128), (128, 4, 3, 3), 32, 1, 1),
    'resnext50_layer2_s2': ((1, 9, 8, 256), (256, 8, 3, 3), 32, 2, 1),
    'resnext101_64x4d_layer3': ((1, 5, 6, 1024), (1024, 16, 3, 3), 64, 1, 1),
    'resnext101_32x8d_layer4': ((1, 3, 4, 2048), (2048, 64, 3, 3), 32, 1, 1),
    'narrow_2_per_group': ((2, 5, 5, 8), (8, 2, 3, 3), 4, 1, 1),
    'two_wide_groups': ((1, 4, 5, 64), (512, 32, 3, 3), 2, 1, 1),
    'grouped_3d': ((1, 3, 5, 5, 48), (96, 4, 3, 3, 3), 12, (1, 2, 2), 1),
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: convolutions held to 1e-5 and below, and the
    tier-1 run has several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module', autouse=True)
def seeded_inits():
    """Each model's seeded random init computed once for the module (an
    extractor per family and precision value loads one)."""
    import functools
    mods = (resnet_model, r21d_model, s3d_model, vggish_model)
    saved = [m.init_state_dict for m in mods]
    for m, init in zip(mods, saved):
        cached = functools.lru_cache(maxsize=None)(init)
        m.init_state_dict = functools.wraps(init)(
            lambda *a, _c=cached, **kw: dict(_c(*a, **kw)))
    yield
    for m, init in zip(mods, saved):
        m.init_state_dict = init


@pytest.fixture(scope='module')
def narrow_arch():
    """The narrowed ResNeXt in both packages' ARCHS for this module."""
    resnet_model.ARCHS[NARROW] = dict(NARROW_ARCH)
    jax_resnet.ARCHS[NARROW] = dict(NARROW_ARCH)
    yield NARROW
    del resnet_model.ARCHS[NARROW], jax_resnet.ARCHS[NARROW]


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _inputs(name, seed=0):
    xs, ws, groups, stride, padding = GROUPED[name]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32))
    w = torch.from_numpy((rng.randn(*ws) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(ws[0]).astype(np.float32))
    return x, w, b, groups, stride, padding


def grouped_kernel_gemm(x, weight, groups, stride, padding, bias):
    """The kernel's implicit GEMM written out per output tile, in float64:
    the tile's rows gather the input channels of the groups it covers
    (from channel (tile · bn / (O/G)) · I/G on, ``tile_inputs`` of them
    per tap, as ``csrc/conv_tf32x3.cu``'s ``cbase`` reads them), K in the
    kernel's order, times the tile's columns of the packed operand."""
    n = weight.ndim - 2
    x5 = x if n == 3 else x[:, None]
    strides = (1,) * (3 - n) + k._tuple(stride, n)
    pairs = [(0, 0)] * (3 - n) + nn._pad_pairs(padding, n)
    N, T, H, W, C = x5.shape
    O, ig = weight.shape[:2]
    kt, kh, kw = (1,) * (3 - n) + tuple(weight.shape[2:])
    out = [(s + lo + hi - kk) // st + 1 for s, (lo, hi), kk, st in
           zip((T, H, W), pairs, (kt, kh, kw), strides)]
    xp = nn.pad_spatial(x5.double(), pairs)
    packed = k.pack_weight(weight, groups)
    tiles, _, _, bn, _ = packed.shape
    cin = k.tile_inputs(ig, O, groups, bn)
    b = k.unpack_matrix(packed).double()
    cols = []
    for tile in range(tiles):
        base = (tile * bn // (O // groups)) * ig
        taps = []
        for dt in range(kt):
            for dh in range(kh):
                for dw in range(kw):
                    patch = xp[:, dt:dt + strides[0] * (out[0] - 1) + 1:strides[0],
                               dh:dh + strides[1] * (out[1] - 1) + 1:strides[1],
                               dw:dw + strides[2] * (out[2] - 1) + 1:strides[2],
                               base:base + cin]
                    taps.append(patch.reshape(-1, cin))
        a = torch.cat(taps, dim=1)
        a = torch.nn.functional.pad(a, (0, b.shape[0] - a.shape[1]))
        cols.append(a @ b[:, tile * bn:(tile + 1) * bn])
    y = torch.cat(cols, dim=1)[:, :O] + bias.double()
    return y.reshape(N, *out[3 - n:], O)


# -- the grouped mode ------------------------------------------------------------


@pytest.mark.parametrize('name', sorted(GROUPED))
def test_grouped_plain_is_the_library_conv(name):
    """The plain version is ``library_conv(groups=G)`` in fp32, and a CPU
    tensor takes it through the wrapper, with no launch."""
    x, w, b, groups, stride, padding = _inputs(name)
    want = nn.library_conv(x, w, stride, padding, b, groups)
    launches = k.conv_tf32x3.launches
    assert torch.equal(k.conv_tf32x3_plain(x, w, stride, padding, b, groups),
                       want)
    assert torch.equal(k.conv_tf32x3(x, w, stride, padding, b, groups), want)
    with nn.conv_route('kernel'):
        assert torch.equal(nn.conv(x, w, stride, padding, b, groups), want)
    assert k.conv_tf32x3.launches == launches


@pytest.mark.parametrize('name', sorted(GROUPED))
def test_grouped_arithmetic_and_tile_bases_hold_fp32(name):
    """The kernel's arithmetic emulated (lo·hi + hi·lo + hi·hi of the
    ``tf32_split`` operands in three grouped convolutions), and each
    tile's K read from its own groups' channels against the block-diagonal
    pack, both against the plain version."""
    x, w, b, groups, stride, padding = _inputs(name, seed=1)
    plain = k.conv_tf32x3_plain(x, w, stride, padding, b, groups)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    emulated = (nn.library_conv(xl, wh, stride, padding, None, groups)
                + nn.library_conv(xh, wl, stride, padding, None, groups)
                + nn.library_conv(xh, wh, stride, padding, b, groups))
    assert rel_l2(emulated, plain) <= EMULATED_REL_L2
    gemm = grouped_kernel_gemm(x, w, groups, stride, padding, b)
    assert gemm.shape == plain.shape
    assert rel_l2(gemm, plain) <= EMULATED_REL_L2


@pytest.mark.parametrize('name', sorted(GROUPED))
def test_grouped_pack_round_trip_and_zero_blocks(name):
    """``unpack_weight(pack_weight(w, G), shape, G)`` is w's TF32 parts
    summed, exactly; the packed shape is ``packed_shape``'s; every entry
    of a tile's matrix outside its output channel's group block is 0."""
    _, w, _, groups, _, _ = _inputs(name, seed=2)
    O, ig = w.shape[:2]
    packed = k.pack_weight(w, groups)
    assert tuple(packed.shape) == k.packed_shape(w.shape, groups)
    hi, lo = tf32_split(w)
    assert torch.equal(k.unpack_weight(packed, w.shape, groups), hi + lo)
    bn = packed.shape[3]
    cin = k.tile_inputs(ig, O, groups, bn)
    span = cin // ig
    taps = int(np.prod(w.shape[2:]))
    m = k.unpack_matrix(packed)
    assert not m[taps * cin:].any()                      # past K
    blocks = m[:taps * cin, :O].reshape(taps, span, ig, O)
    own = (torch.arange(O) // (O // groups)) % span
    off = torch.arange(span)[:, None] != own[None, :]    # (span, O)
    assert not blocks.permute(1, 3, 0, 2)[off].any()
    assert blocks.permute(1, 3, 0, 2)[~off].ne(0).any()


def test_grouped_tiles_cover_whole_groups():
    """A grouped tile covers whole groups (or lies inside one), with no
    pad column, the fewest wasted products, then the widest: ResNeXt's
    4 channels per group in tiles of 8 (2 groups, 2x the products), 8 to
    64 in tiles of one group, none wider than 128."""
    # (O, groups, channels per group in) → (bn, tiles)
    for (o, g, ig), want in {
            (128, 32, 4): (8, 16), (256, 32, 8): (8, 32),
            (512, 32, 16): (16, 32), (1024, 32, 32): (32, 32),
            (2048, 32, 64): (64, 32), (256, 64, 4): (8, 32),
            (2048, 64, 32): (32, 64), (512, 2, 256): (128, 4),
            (8, 4, 2): (8, 1)}.items():
        assert k.channel_tiles(o, g, ig) == want, (o, g, ig)
        bn, tiles = want
        og = o // g
        assert tiles * bn == o and (bn % og == 0 or og % bn == 0)
        cin = k.tile_inputs(ig, o, g, bn)
        assert cin == ig * max(1, bn // og) and cin % k.C_GROUP == 0
        plan = k.conv_plan(100_000, o, groups=g, ig=ig)
        assert (plan.bn, plan.tiles) == want and plan.bm == 128
    # one group keeps its plan: pad columns allowed, every channel read
    assert k.channel_tiles(45) == (48, 1) and k.channel_tiles(921) == (104, 9)
    assert k.tile_inputs(45, 64, 1, 64) == 48
    with pytest.raises(ValueError, match='no tile'):
        k.channel_tiles(24, 2, 1)       # 12 out, 1 in per group: 2-channel reads


@pytest.mark.parametrize('case,match', [
    ('o', 'groups=3 must divide'), ('i', 'groups=2 must divide'),
    ('zero', 'groups=0 must divide'), ('no_tile', 'no tile'),
    ('packed', 'packed weight must be')])
def test_check_refuses_groups_the_kernel_does_not_take(case, match):
    x, w, b, groups, stride, padding = _inputs('resnext50_layer1')
    args = dict(x=x, weight=w, stride=stride, padding=padding, bias=b,
                groups=groups)
    if case == 'o':                 # 3 does not divide O = 128 (nor I)
        args['groups'] = 3
    elif case == 'i':               # 2 divides O, but I != 2 x 4
        args['groups'] = 2
    elif case == 'zero':
        args['groups'] = 0
    elif case == 'no_tile':         # 12 outputs of 1 input a group
        args.update(x=x[..., :2].contiguous(), weight=w[:24, :1].contiguous(),
                    bias=b[:24], groups=2)
    elif case == 'packed':          # a pack made for groups=1
        args['weight'] = k.PackedWeight(w, k.pack_weight(w))
    with pytest.raises(ValueError, match=match):
        k.conv_tf32x3(**args)
    with pytest.raises(ValueError, match=match), nn.conv_route('kernel'):
        nn.conv(args['x'], args['weight'], stride, padding, args['bias'],
                args['groups'])


# -- the route: every convolution of each family's step, per precision ---------


def _args(tmp_path, ft, precision, **kw):
    base = {'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
            'allow_random_weights': True, 'precision': precision,
            'output_path': str(tmp_path / 'out')}
    base.update({'resnet': {'model_name': 'resnet18'},
                 's3d': {'stack_size': 16, 'step_size': 16},
                 'vggish': {'batch_size': 2}}.get(ft, {}))
    base.update(kw)
    return base


def _batch(ft, seed=0):
    rng = np.random.RandomState(seed)
    if ft == 'vggish':
        return (rng.rand(2, 1, 96, 64) * 7 - 4.6).astype(np.float32)
    shape = {'resnet': (1, 32, 32, 3), 'r21d': (1, 8, 32, 40, 3),
             's3d': (1, 16, 24, 32, 3)}[ft]
    return rng.randint(0, 256, shape).astype(np.uint8)


# each family's convolutions per step, reckoned from its arch
CONVS = {'resnet': 1 + 2 * 8 + 3,                # resnet18: stem, 8 blocks, 3 downsamples
         'r21d': 2 + 4 * 8 + 3,                  # r2plus1d_18: stem pair, 8 blocks, 3
         's3d': 2 * 2 + 1 + 8 * 9,               # two separable units, one 1x1x1, 9 Mixed
         'vggish': 6}


@pytest.fixture
def spies(monkeypatch):
    """Calls of the kernel's wrapper, its plain version and the library
    convolution (``ops/nn.py::library_conv``, or ``F.conv2d`` from an
    ``nn.Conv2d``: VGGish's module off the lane), each with the TF32 flags
    in force."""
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
    # library_conv calls the F.conv2d it bound at import: no double count
    monkeypatch.setattr(torch.nn.functional, 'conv2d',
                        spy('library', torch.nn.functional.conv2d))
    return calls


@pytest.mark.parametrize('precision', device.PRECISIONS)
@pytest.mark.parametrize('ft', FAMILIES)
def test_each_step_routes_every_conv_on_the_lane(tmp_path, spies, ft,
                                                 precision):
    """The dispatched step (``run_step``: the packed step, as the
    per-video, packed, serve and live loops run it) and, on the lane, the
    step program that ``program_specs`` hands the exporter: every
    convolution on the kernel's route under high and mixed, with TF32 off
    in the libraries, none under the other five values."""
    ex = create_extractor(load_config(ft, _args(tmp_path, ft, precision)))
    three = precision in THREE
    assert ex.three_pass_convs == three
    batch = _batch(ft)
    ex.run_step(batch)
    steps = 1
    spec = ex.program_specs()[0]
    assert spec.kwargs['three_pass_convs'] == three
    if three:
        params = (dict(ex.model.state_dict()) if ft == 'vggish'
                  else ex.params)
        with torch.inference_mode(), ex.precision_scope():
            spec.fn(params, torch.from_numpy(batch), **spec.kwargs)
        steps = 2
    want = CONVS[ft] * steps
    assert len(spies['kernel']) == (want if three else 0)
    assert len(spies['plain']) == len(spies['kernel'])   # the CPU's version
    assert len(spies['library']) == (0 if three else want)
    if three:
        assert {c[:2] for c in spies['kernel']} == {(False, False)}
    else:
        tf32 = device.LANES[precision][0]
        assert {c[:2] for c in spies['library']} == {(tf32, tf32)}


def test_grouped_resnext_step_routes_every_conv(tmp_path, spies, narrow_arch):
    """The narrowed ResNeXt's step under mixed: its grouped 3×3s on the
    kernel's route like every other convolution, none in the libraries."""
    ex = create_extractor(load_config('resnet', _args(
        tmp_path, 'resnet', 'mixed', model_name=narrow_arch)))
    ex.run_step(_batch('resnet', 1))
    assert len(spies['kernel']) == NARROW_CONVS
    assert not spies['library']


def test_the_lane_names_the_conv_library_on_the_card(monkeypatch, tmp_path):
    """On the card the four families list ``conv_tf32x3`` under high and
    mixed only (so ``aot_warm`` and the executable store reach it), and
    nothing on the CPU or on the other lanes."""
    for ft in FAMILIES:
        ex = create_extractor(load_config(ft, _args(tmp_path, ft, 'mixed')))
        assert ex.kernel_libraries() == ()
        monkeypatch.setattr(ex, 'device', torch.device('cuda'))
        for precision in device.PRECISIONS:
            # the lane as an extractor built under this value holds it
            monkeypatch.setattr(ex, 'three_pass_convs',
                                device.three_pass_convs(precision, ft))
            assert ex.kernel_libraries() == (
                ('conv_tf32x3',) if precision in THREE else ()), (ft, precision)


def test_the_bf16_lane_keeps_its_convolutions_in_the_libraries(tmp_path,
                                                              spies):
    """``compute_dtype=bfloat16`` under high: bf16 operands have no low
    part, so the convolutions stay in the libraries with the value's TF32
    flags, as before the lane, and the key keeps its arithmetic."""
    ex = create_extractor(load_config('resnet', _args(
        tmp_path, 'resnet', 'high', compute_dtype='bfloat16')))
    assert not ex.three_pass_convs
    assert not device.three_pass_convs('mixed', 'resnet', 'bfloat16')
    assert device.library_tf32('high', 'resnet', 'bfloat16')
    ex.run_step(_batch('resnet'))
    assert not spies['kernel'] and len(spies['library']) == CONVS['resnet']
    assert {c[:2] for c in spies['library']} == {(True, True)}


# -- mixed and high against the JAX package's mixed -------------------------------


def _jax_extractor(tmp, ft, **kw):
    overrides = {'video_paths': str(tmp / 'v.mp4'), 'device': 'cpu',
                 'precision': 'mixed', 'allow_random_weights': True,
                 'output_path': str(tmp / 'out'), 'tmp_path': str(tmp / 'tmp')}
    overrides.update(kw)
    return jax_create(jax_load_config(ft, overrides=overrides))


@pytest.fixture(scope='module')
def jax_mixed(tmp_path_factory, narrow_arch):
    """Each JAX extractor's jitted step under mixed, in its own
    ``precision_scope``, on seeded inputs, with its seeded weights:
    resnet18 and the narrowed ResNeXt (2 frames of 64×64), r2plus1d_18 (one
    8-frame stack of 48×64), S3D (one 16-frame stack of 32×40) and VGGish
    (2 examples, with a seeded PCA for the uint8 embedding)."""
    tmp = tmp_path_factory.mktemp('jax_three_pass')
    rng = np.random.RandomState(11)
    frames = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    r21d_stacks = rng.randint(0, 256, (1, 8, 48, 64, 3)).astype(np.uint8)
    s3d_stacks = rng.randint(0, 256, (1, 16, 32, 40, 3)).astype(np.uint8)
    examples = (rng.rand(2, 1, 96, 64) * 7 - 4.6).astype(np.float32)
    eig = (rng.randn(128, 128) * 0.3).astype(np.float32)
    means = (rng.rand(128) * 0.5).astype(np.float32)
    out = {}
    jex = _jax_extractor(tmp, 'resnet', model_name='resnet18')
    narrow = transplant(jax_resnet.init_state_dict(seed=4, arch=narrow_arch))
    with jex.precision_scope():
        out['resnet'] = (params_from_jax(jex.params), frames,
                         np.asarray(jex._step(jex.params, jnp.asarray(frames))))
        step = jax.jit(lambda p, x: JaxExtractResNet._forward(p, x,
                                                              arch=narrow_arch))
        out[narrow_arch] = (params_from_jax(narrow), frames,
                            np.asarray(step(narrow, jnp.asarray(frames))))
    jex = _jax_extractor(tmp, 'r21d')
    with jex.precision_scope():
        out['r21d'] = (params_from_jax(jex.params), r21d_stacks, np.asarray(
            jex._step(jex.params, jnp.asarray(r21d_stacks))))
    jex = _jax_extractor(tmp, 's3d', stack_size=16, step_size=16)
    with jex.precision_scope():
        step = jex._geometry_step(*s3d_stacks.shape[2:4])[0]
        out['s3d'] = (params_from_jax(jex.params), s3d_stacks,
                      np.asarray(step(jex.params, jnp.asarray(s3d_stacks))))
    jex = _jax_extractor(tmp, 'vggish')
    with jex.precision_scope():
        emb = jex._step(jex.params, jnp.asarray(examples[:, 0, :, :, None]))
        quant = jax_vggish.postprocess(jnp.asarray(eig), jnp.asarray(means),
                                       emb)
    out['vggish'] = (params_from_jax(jex.params), examples, np.asarray(emb))
    out['vggish_uint8'] = (eig, means, np.asarray(quant).astype(np.uint8))
    return out


def _port_step(ex, params, batch):
    """The port extractor's dispatched step on the JAX package's weights."""
    if ex.feature_type == 'vggish':
        ex.model = vggish_model.build(flatten(params), 'cpu')
    else:
        ex.params = params
    return ex.run_step(batch)[ex.feature_type]


@pytest.mark.parametrize('precision', THREE)
@pytest.mark.parametrize('ft', FAMILIES)
def test_the_lane_holds_the_jax_mixed_step(jax_mixed, tmp_path, ft,
                                           precision):
    params, batch, want = jax_mixed[ft]
    ex = create_extractor(load_config(ft, _args(tmp_path, ft, precision)))
    assert ex.three_pass_convs
    got = _port_step(ex, params, batch)
    assert got.shape == want.shape
    assert rel_l2(got, want) <= JAX_REL_L2
    if ft == 'vggish':
        eig, means, quant = jax_mixed['vggish_uint8']
        with torch.inference_mode(), ex.precision_scope():
            mine = vggish_model.postprocess(
                torch.from_numpy(eig), torch.from_numpy(means),
                torch.from_numpy(got)).numpy().astype(np.uint8)
        assert np.abs(mine.astype(int) - quant.astype(int)).max() <= 1


@pytest.mark.parametrize('precision', THREE)
def test_the_grouped_resnext_holds_the_jax_mixed_step(jax_mixed, narrow_arch,
                                                      precision):
    """The narrowed ResNeXt (4 groups of 2 to 16 channels) through the
    port's step on the lane's route against the JAX package's mixed."""
    params, frames, want = jax_mixed[narrow_arch]
    with torch.inference_mode(), device.precision_scope(precision, 'resnet'):
        got = resnet_extract.resnet_step(
            params, torch.from_numpy(frames), narrow_arch,
            three_pass_convs=device.three_pass_convs(precision, 'resnet'))
    assert got.shape == want.shape == (2, 2048)
    assert rel_l2(got, want) <= JAX_REL_L2


def test_the_four_families_are_on_the_lane():
    assert set(FAMILIES) <= registry.THREE_PASS_FEATURES
    assert not set(FAMILIES) & registry.THREE_PASS_PRODUCT_FEATURES
    assert set(FAMILIES) <= registry.MIXED_FEATURES


@pytest.mark.parametrize('ft', ['resnet', 'vggish'])
def test_the_mixed_program_has_one_conv_node_per_convolution(narrow_arch, ft):
    """Traced for the card on fake CUDA tensors (``analysis/programs.py``),
    the step under mixed holds one ``vft::conv_tf32x3`` node per
    convolution, the narrowed ResNeXt's four grouped ones among them, and
    no other kernel."""
    from video_features_torch.analysis import programs
    overrides = {'precision': 'mixed'}
    if ft == 'resnet':
        overrides['model_name'] = narrow_arch
    ex = programs.build_family(ft, overrides=overrides)
    sig, _ = programs.program_signature(ex.program_specs()[0])
    vft = {name: n for name, n in sig['ops'].items() if name.startswith('vft.')}
    want = NARROW_CONVS if ft == 'resnet' else CONVS['vggish']
    assert vft == {'vft.conv_tf32x3.default': want}
    assert sig['kernels'] == want
