"""The port's precision lanes on the CPU: every JAX ``precision`` value
(video_features_torch/utils/device.py, config.py), its TF32 flags scoped
per dispatch, the GRU direction's one-pass plain version (ops/gru.py),
the ``compute_dtype=bfloat16`` lane of the six families the JAX package
admits (ops/precision.py, the fp32 islands of ops/nn.py) against the
port's fp32 lane and the JAX package's bf16 lane, and the lane in the
resume fingerprint. The value lists come from the JAX package."""
from functools import partial
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu import registry as jax_registry
from video_features_tpu.extract.clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.extract.r21d import ExtractR21D as JaxExtractR21D
from video_features_tpu.extract.resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.extract.s3d import ExtractS3D as JaxExtractS3D
from video_features_tpu.extract.timm import ExtractTIMM as JaxExtractTIMM
from video_features_tpu.models import clip as jax_clip
from video_features_tpu.models import r21d as jax_r21d
from video_features_tpu.models import resnet as jax_resnet
from video_features_tpu.models import s3d as jax_s3d
from video_features_tpu.models import vggish as jax_vggish
from video_features_tpu.models import vit as jax_vit
from video_features_tpu.ops import precision as jax_precision
from video_features_tpu.transplant.torch2jax import transplant
from video_features_tpu.utils.device import MATMUL_PRECISIONS
from video_features_torch import registry
from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import knob_exclude, load_config, load_fused_configs
from video_features_torch.extract import clip as clip_ex
from video_features_torch.extract import r21d as r21d_ex
from video_features_torch.extract import resnet as resnet_ex
from video_features_torch.extract import s3d as s3d_ex
from video_features_torch.extract import timm as timm_ex
from video_features_torch.models import raft, vggish, vit
from video_features_torch.ops import attention, gru, nn
from video_features_torch.ops import precision as lanes
from video_features_torch.parallel.packing import run_packed_fused
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import flatten, params_from_torch, to_lane
from video_features_torch.utils import device

BF16_FAMILIES = sorted(jax_registry.BF16_FEATURES)
VIT_TEST = dict(width=64, layers=2, heads=2, patch=16)
# the GRU's one-pass plain version against the float64 convolution of the
# same TF32-rounded operands: fp32 sums of 1,280 products (pre-activations
# of ~2) in oneDNN's order, 1.8e-6 here (the card's 3xTF32 plain version
# sits 3.4e-6 from float64, chip_smoke.py's kernel phase)
GRU_F64_ATOL = 5e-6


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _base(tmp_path, **kw):
    return {'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
            'allow_random_weights': True, 'output_path': str(tmp_path / 'out'),
            **kw}


# -- the value lists, from the JAX package ------------------------------------


def test_value_lists_are_the_jax_packages():
    assert device.PRECISIONS == MATMUL_PRECISIONS
    assert set(device.LANES) == set(MATMUL_PRECISIONS)
    assert lanes.COMPUTE_DTYPES == jax_precision.COMPUTE_DTYPES
    assert registry.BF16_FEATURES == jax_registry.BF16_FEATURES
    assert registry.INT8_FEATURES == jax_registry.INT8_FEATURES
    assert lanes.BF16_REL_L2_BOUNDS == jax_precision.BF16_REL_L2_BOUNDS
    assert lanes.INT8_REL_L2_BOUNDS == jax_precision.INT8_REL_L2_BOUNDS
    assert set(lanes.BF16_REFUSALS) == set(jax_precision.BF16_REFUSALS)
    assert set(lanes.INT8_REFUSALS) == set(jax_precision.INT8_REFUSALS)
    assert registry.MIXED_FEATURES <= set(registry.EXTRACTORS)
    assert set(registry.MIXED_REFUSALS) == set(registry.EXTRACTORS) - registry.MIXED_FEATURES


@pytest.mark.parametrize('precision', MATMUL_PRECISIONS)
def test_every_precision_value_is_accepted_or_refused_by_name(tmp_path, precision):
    """Each family takes each JAX value, but mixed outside
    ``registry.MIXED_FEATURES``, which raises NotImplementedError naming
    ``precision`` with the card's figure."""
    for ft in registry.EXTRACTORS:
        overrides = _base(tmp_path, precision=precision)
        if ft == 'timm':
            overrides['model_name'] = 'vit_tiny_patch16_224'
        if precision == 'mixed' and ft not in registry.MIXED_FEATURES:
            with pytest.raises(NotImplementedError, match='precision=mixed'):
                load_config(ft, overrides)
        else:
            assert load_config(ft, overrides)['precision'] == precision


@pytest.mark.parametrize('precision', ['bogus', 'HIGHEST', None])
def test_unknown_precision_is_a_value_error(tmp_path, precision):
    with pytest.raises(ValueError, match='precision must be one of'):
        load_config('resnet', _base(tmp_path, precision=precision))


def test_float32_gives_the_bytes_of_highest(tmp_path):
    """float32 is the JAX package's name for highest: the same lane, the
    same bytes (resnet18, and RAFT, whose GRU takes the pass count)."""
    assert device.LANES['float32'] == device.LANES['highest']
    frames = _frames(0, (2, 64, 64, 3))
    outs = {}
    for prec in ('highest', 'float32'):
        ex = create_extractor(load_config('resnet', _base(
            tmp_path, precision=prec, model_name='resnet18')))
        rex = create_extractor(load_config('raft', _base(
            tmp_path, precision=prec, batch_size=1, raft_iters=1)))
        outs[prec] = (ex.run_step(frames)['resnet'], rex.run_step(frames)['raft'])
    for a, b in zip(*outs.values()):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('precision', MATMUL_PRECISIONS)
def test_the_lane_reaches_the_gru_direction(tmp_path, monkeypatch, precision):
    """The RAFT family's step runs every GRU direction at its lane's pass
    count: 1 for default, tensorfloat32 and bfloat16, 3 otherwise."""
    seen = []
    plain = gru.gru_direction_plain

    def spy(*args):
        seen.append(args[7])          # h, motion, w_zr, w_q, terms, axis, passes
        return plain(*args)
    monkeypatch.setattr(gru, 'gru_direction_plain', spy)
    if precision == 'mixed' and 'raft' not in registry.MIXED_FEATURES:
        precision = 'high'                  # mixed's arithmetic
    rex = create_extractor(load_config('raft', _base(
        tmp_path, precision=precision, batch_size=1, raft_iters=2)))
    rex.run_step(_frames(1, (2, 64, 64, 3)))
    want = 1 if precision in ('default', 'tensorfloat32', 'bfloat16') else 3
    assert seen == [want] * 4 and rex.gru_passes == want


# -- precision_scope ------------------------------------------------------------


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize('precision', MATMUL_PRECISIONS)
def test_precision_scope_sets_the_flags_and_restores_them(precision):
    tf32 = precision not in ('highest', 'float32')
    for outer in ((False, True), (True, False)):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = outer
        with device.precision_scope(precision):
            assert _flags() == (tf32, tf32)
        assert _flags() == outer
        with pytest.raises(RuntimeError, match='boom'):
            with device.precision_scope(precision):
                raise RuntimeError('boom')
        assert _flags() == outer
    with pytest.raises(ValueError, match='precision must be one of'):
        with device.precision_scope('bogus'):
            pass


@pytest.mark.parametrize('order', [('highest', 'tensorfloat32'),
                                   ('tensorfloat32', 'highest')])
def test_extractors_on_two_lanes_see_their_own_flags(tmp_path, order):
    """Built in either order in one process, each extractor's dispatched
    step sees its own lane's flags, and the flags are restored after."""
    seen = {}
    exs = {}
    for prec in order:
        ex = create_extractor(load_config('resnet', _base(
            tmp_path, precision=prec, model_name='resnet18')))
        step = ex.packed_step

        def probe(x, step=step, prec=prec):
            seen.setdefault(prec, []).append(_flags())
            return step(x)
        ex.packed_step = probe
        exs[prec] = ex
    outside = _flags()
    frames = _frames(2, (1, 64, 64, 3))
    for prec in (*order, *order):
        exs[prec].run_step(frames)
        assert _flags() == outside
    assert seen == {'highest': [(False, False)] * 2,
                    'tensorfloat32': [(True, True)] * 2}


# -- the fp32 islands of the bf16 lane --------------------------------------------


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).to(torch.bfloat16)


def _norm_params(c, seed=1):
    rng = np.random.RandomState(seed)
    return {'weight': torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5),
            'bias': torch.from_numpy(rng.randn(c).astype(np.float32)),
            'running_mean': torch.from_numpy(rng.randn(c).astype(np.float32)),
            'running_var': torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)}


ISLANDS = {
    'batch_norm': (lambda x, p: nn.batch_norm(x, p), (2, 5, 6, 8)),
    'instance_norm': (lambda x, p: nn.instance_norm(x, p), (2, 5, 6, 8)),
    'layer_norm': (lambda x, p: nn.layer_norm(x, p, 1e-6), (2, 7, 8)),
    'softmax': (lambda x, p: nn.softmax(x, dim=-1), (2, 3, 64)),
    'avg_pool': (lambda x, p: nn.avg_pool(x, (2, 3, 3), stride=1), (2, 4, 6, 6, 8)),
    'adaptive_avg_pool': (lambda x, p: nn.adaptive_avg_pool(x), (2, 4, 6, 6, 8)),
}


@pytest.mark.parametrize('op', sorted(ISLANDS))
def test_island_is_the_fp32_op_cast_to_bf16(op):
    """A bf16 input (and bf16 params) computes in float32 and returns bf16:
    exactly the float32 op on the same values, cast down."""
    fn, shape = ISLANDS[op]
    x = _bf16(*shape)
    p = {k: v.to(torch.bfloat16) for k, v in _norm_params(shape[-1]).items()}
    got = fn(x, p)
    want = fn(x.float(), {k: v.float() for k, v in p.items()}).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind', ['dense', 'blockwise'])
def test_attention_keeps_the_bf16_lane(kind):
    """Attention on bf16 q, k, v returns bf16, its softmax in float32."""
    q, k, v = (_bf16(1, 40, 2, 16, seed=s) for s in (1, 2, 3))
    fn = (attention.dense_attention if kind == 'dense'
          else partial(attention.blockwise_attention, block_size=16))
    got = fn(q, k, v)
    ref = attention.dense_attention(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert lanes.rel_l2(ref.numpy(), got.float().numpy()) < 2e-2


# -- the GRU direction's pass count -------------------------------------------------


def _gru_inputs(seed=8, shape=(2, 6, 9)):
    rng = np.random.RandomState(seed)

    def t(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    w_zr, w_q = gru.pack_direction(t(256, 256, 1, 5, scale=0.05),
                                   t(128, 256, 1, 5, scale=0.05))
    return (torch.tanh(t(*shape, 128)), t(*shape, 128), w_zr, w_q,
            t(*shape, 256, scale=0.1), t(*shape, 128, scale=0.1))


@pytest.mark.parametrize('axis', gru.AXES)
def test_one_pass_plain_is_the_float64_conv_of_rounded_operands(axis):
    """``passes=1``: the convolutions of the TF32-rounded inputs and of the
    weights' hi parts, the epilogues as in 3xTF32; it differs from
    ``passes=3``. The q convolution's operand is r·h as the plain version
    rounds it: an r recomputed in float64 would, now and then, round r·h
    to the other side of a TF32 tie (one TF32 ulp, ~5e-5 at the output)."""
    x = _gru_inputs()
    got = gru.gru_direction_plain(*x, axis, passes=1)
    hi = [gru._conv_weight(gru.unpack_parts(w)[0], axis) for w in x[2:4]]
    h, motion, _, _, zr_term, q_term = x
    pad = gru.PADS[axis]
    a = gru.tf32_round(torch.cat([h, motion], -1))
    z, _ = torch.chunk(torch.sigmoid(nn.conv(a.double(), hi[0].double(),
                                             padding=pad) + zr_term.double()),
                       2, dim=-1)
    _, r32 = torch.chunk(torch.sigmoid(nn.conv(a, hi[0], padding=pad) + zr_term),
                         2, dim=-1)
    b = gru.tf32_round(torch.cat([r32 * h, motion], -1))
    q = torch.tanh(nn.conv(b.double(), hi[1].double(), padding=pad)
                   + q_term.double())
    want = (1 - z) * h.double() + z * q
    assert (got.double() - want).abs().max() <= GRU_F64_ATOL
    assert (got - gru.gru_direction_plain(*x, axis)).abs().max() > 1e-5
    # the wrapper takes the plain version for a CPU tensor, counting nothing
    before = dict(gru.gru_direction.launches_by_passes)
    assert torch.equal(gru.gru_direction(*x, axis, passes=1), got)
    assert gru.gru_direction.launches_by_passes == before


@pytest.mark.parametrize('axis', gru.AXES)
def test_three_pass_plain_is_unchanged(axis):
    """``passes=3`` (the default) is the convolution of the unrounded
    inputs with hi + lo weights, bit for bit."""
    x = _gru_inputs(seed=9)
    convs = [gru._conv_weight(gru.unpack_direction(w), axis) for w in x[2:4]]
    pad = gru.PADS[axis]
    h, motion, _, _, zr_term, q_term = x
    zr = torch.sigmoid(nn.conv(torch.cat([h, motion], -1), convs[0], padding=pad)
                       + zr_term)
    z, r = torch.chunk(zr, 2, dim=-1)
    q = torch.tanh(nn.conv(torch.cat([r * h, motion], -1), convs[1], padding=pad)
                   + q_term)
    want = (1 - z) * h + z * q
    assert torch.equal(gru.gru_direction_plain(*x, axis), want)
    assert torch.equal(gru.gru_direction_plain(*x, axis, passes=3), want)


@pytest.mark.parametrize('passes', [0, 2, 4])
def test_a_bad_pass_count_is_refused(passes):
    x = _gru_inputs()
    with pytest.raises(ValueError, match='passes must be one of'):
        gru.gru_direction(*x, 'w', passes=passes)
    with pytest.raises(ValueError, match='passes must be one of'):
        gru.gru_direction_plain(*x, 'w', passes=passes)


def test_raft_forward_takes_the_pass_count():
    params = params_from_torch(raft.init_state_dict(seed=0))
    frames = torch.from_numpy(_frames(3, (2, 64, 64, 3)))
    with torch.inference_mode():
        one, three = (raft.forward_consecutive(params, frames, iters=2,
                                               gru_passes=p) for p in (1, 3))
        default = raft.forward_consecutive(params, frames, iters=2)
    assert torch.equal(three, default)
    assert 0 < (one - three).abs().max() < 1e-1


# -- the bf16 lane of the six families ------------------------------------------------


def _jit(fn, **static):
    return jax.jit(partial(fn, **static), static_argnames='dtype')


def _bf16_cases():
    """{family: (state_dict, no_transpose, port step(params, x, dtype),
    JAX step(params, x, dtype), input)} at narrow sizes: resnet18 at 64
    px, CLIP ViT-B/32 cut to two blocks, a narrow ViT, r2plus1d_18 and
    S3D through their steps' resizes, VGGish on four examples."""
    clip_sd = {k: v for k, v in jax_clip.init_state_dict(seed=0).items()
               if not (k.startswith('visual.transformer.resblocks.')
                       and int(k.split('.')[3]) >= 2)}
    mean, std = vit.MEAN, vit.STD
    size, scale = s3d_ex.resize_geometry(64, 86)

    def port_vggish(p, x, dt):
        model = vggish.build(flatten(p), 'cpu')
        return model(x.permute(0, 3, 1, 2).to(dt)).float()

    def jax_vggish_step(p, x, dtype):
        return jax_precision.features_to_f32(jax_vggish.forward(p, x.astype(dtype)))
    return {
        'resnet': (jax_resnet.init_state_dict(seed=1, arch='resnet18'), (),
                   lambda p, x, dt: resnet_ex.resnet_step(p, x, 'resnet18', dt),
                   _jit(JaxExtractResNet._forward, arch='resnet18'),
                   _frames(10, (2, 64, 64, 3))),
        'clip': (clip_sd, tuple(jax_clip.NO_TRANSPOSE),
                 lambda p, x, dt: clip_ex.clip_step(p, x, 'ViT-B/32', dt),
                 _jit(JaxExtractCLIP._forward, arch='ViT-B/32'),
                 _frames(11, (2, 224, 224, 3))),
        'timm': (jax_vit.init_state_dict(arch='vit_test'), (),
                 lambda p, x, dt: timm_ex.timm_step(p, x, 'vit', 'vit_test',
                                                    mean, std, dt),
                 _jit(JaxExtractTIMM._forward, family='vit', arch='vit_test',
                      mean=mean, std=std),
                 _frames(12, (2, 64, 64, 3))),
        'r21d': (jax_r21d.init_state_dict(seed=1), (),
                 lambda p, x, dt: r21d_ex.r21d_step(p, x, 'r2plus1d_18', dt),
                 _jit(JaxExtractR21D._forward_batch, arch='r2plus1d_18'),
                 _frames(13, (1, 8, 32, 32, 3))),
        's3d': (jax_s3d.init_state_dict(seed=1), (),
                lambda p, x, dt: s3d_ex.s3d_step(p, x, dtype=dt),
                _jit(JaxExtractS3D._forward, resize_hw=size, resize_scale=scale),
                _frames(14, (1, 16, 64, 86, 3))),
        'vggish': (jax_vggish.init_state_dict(seed=3), (), port_vggish,
                   _jit(jax_vggish_step),
                   (np.random.RandomState(15).rand(4, 96, 64, 1) * 7 - 4.6
                    ).astype(np.float32)),
    }


@pytest.fixture(scope='module')
def bf16_lanes():
    """{family: (port fp32 features, port bf16 features, JAX bf16
    features, the port's bf16 params)} on the same seeded inputs."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit.ARCHS, 'vit_test', VIT_TEST)
        mp.setitem(jax_vit.ARCHS, 'vit_test', VIT_TEST)
        for ft, (sd, no_t, step, jax_step, x) in _bf16_cases().items():
            jp = transplant(sd, no_transpose=set(no_t), dtype=ml_dtypes.bfloat16)
            ref = np.asarray(jax_step(jp, jnp.asarray(x), dtype=jnp.bfloat16))
            fp32 = params_from_torch(sd)
            bf16 = to_lane(fp32, 'bfloat16')
            with torch.inference_mode():
                a = step(fp32, torch.from_numpy(x), torch.float32).numpy()
                b = step(bf16, torch.from_numpy(x), torch.bfloat16)
            out[ft] = (a, b.numpy(), ref, bf16, b.dtype)
    return out


@pytest.mark.parametrize('ft', BF16_FAMILIES)
def test_bf16_lane_differs_from_fp32_within_the_bound(bf16_lanes, ft):
    fp32, bf16 = bf16_lanes[ft][:2]
    assert 0 < lanes.rel_l2(fp32, bf16) <= lanes.BF16_REL_L2_BOUNDS[ft]


@pytest.mark.parametrize('ft', BF16_FAMILIES)
def test_bf16_lane_is_within_the_bound_of_the_jax_bf16_lane(bf16_lanes, ft):
    _, bf16, ref = bf16_lanes[ft][:3]
    assert bf16.shape == ref.shape
    assert lanes.rel_l2(ref, bf16) <= lanes.BF16_REL_L2_BOUNDS[ft]


@pytest.mark.parametrize('ft', BF16_FAMILIES)
def test_bf16_lane_emits_float32_and_holds_bf16_params(bf16_lanes, ft):
    params, dtype = bf16_lanes[ft][3:]
    assert dtype == torch.float32
    leaves = flatten(params).values()
    assert {t.dtype for t in leaves if t.is_floating_point()} == {torch.bfloat16}


def test_bf16_extractors_run_the_lane(tmp_path):
    """Through ``load_config`` and ``create_extractor``: resnet's params
    load bf16 and ``run_step`` gives the bf16 step's float32 bytes;
    vggish narrows its examples to bf16 on the host."""
    ex = create_extractor(load_config('resnet', _base(
        tmp_path, model_name='resnet18', compute_dtype='bfloat16')))
    assert ex.params['conv1']['weight'].dtype == torch.bfloat16
    frames = _frames(4, (2, 64, 64, 3))
    out = ex.run_step(frames)['resnet']
    with torch.inference_mode():
        want = resnet_ex.resnet_step(ex.params, torch.from_numpy(frames),
                                     'resnet18', torch.bfloat16).numpy()
    assert out.dtype == np.float32 and np.array_equal(out, want)
    vex = create_extractor(load_config('vggish', _base(tmp_path,
                                                       compute_dtype='bfloat16')))
    assert {p.dtype for p in vex.model.parameters()} == {torch.bfloat16}
    examples = np.random.RandomState(5).rand(3, 1, 96, 64).astype(np.float32)
    got = vex._run_batched(examples)
    with torch.inference_mode():
        want = vex.model(torch.from_numpy(examples).to(torch.bfloat16)).float()
    assert got.dtype == np.float32 and np.array_equal(got, want.numpy())


def test_s3d_resize_yields_the_lanes_dtype():
    x = torch.rand(1, 2, 10, 12, 3).to(torch.bfloat16)
    from video_features_torch.ops import transforms
    assert transforms.resize_bilinear_scale(x, (20, 24), 2.0).dtype == torch.bfloat16
    assert transforms.resize_bilinear(x, (5, 7)).dtype == torch.bfloat16
    assert transforms.to_float_zero_one(torch.zeros(2, dtype=torch.uint8),
                                        torch.bfloat16).dtype == torch.bfloat16


# -- the lane in the resume fingerprint ----------------------------------------------


@pytest.mark.parametrize('ft', BF16_FAMILIES)
def test_compute_dtype_enters_the_fingerprint(ft):
    assert 'compute_dtype' not in knob_exclude('fingerprint')

    def fp(**kw):
        return run_fingerprint({'feature_type': ft, **kw})
    assert fp(compute_dtype='float32') != fp(compute_dtype='bfloat16')
    assert fp(compute_dtype='float32') == fp() == fp(compute_dtype=None)


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp('lanevids')
    return [str(write_noise_clip(d / f'v{i}.mp4', n, w=64, h=48, seed=40 + i))
            for i, n in enumerate((5, 3))]


def test_a_bf16_run_recomputes_an_fp32_output(clips, tmp_path):
    """The same video, output path and model on the bf16 lane: the fp32
    files are not resumed but recomputed, and the bytes change."""
    def run(dtype):
        ex = create_extractor(load_config('resnet', {
            'video_paths': clips[0], 'device': 'cpu', 'model_name': 'resnet18',
            'allow_random_weights': True, 'on_extraction': 'save_numpy',
            'output_path': str(tmp_path / 'out'), 'tmp_path': str(tmp_path / 'tmp'),
            'compute_dtype': dtype}))
        ex._extract(clips[0])
        return ex
    ex = run('float32')
    path = next(Path(ex.output_path).glob('*_resnet.npy'))
    fp32 = path.read_bytes()
    with pytest.warns(UserWarning, match='different config'):
        run('bfloat16')
    assert path.read_bytes() != fp32
    assert run('bfloat16').is_already_exist(clips[0])


def test_a_fused_worklist_gives_each_lane_its_solo_bytes(clips, tmp_path):
    """resnet on the bf16 lane and CLIP at fp32 over one decode: each
    family writes the bytes of its solo packed run."""
    def configs(root):
        return load_fused_configs(['resnet', 'clip'], {
            'video_paths': clips, 'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(root),
            'tmp_path': str(root) + '_tmp', 'batch_size': 4,
            'resnet.model_name': 'resnet18', 'clip.model_name': 'ViT-B/32',
            'resnet.compute_dtype': 'bfloat16'})

    def npys(root):
        return {str(f.relative_to(root)): f.read_bytes()
                for f in sorted(Path(root).rglob('*.npy'))}
    solo = configs(tmp_path / 'solo')
    assert solo['resnet']['compute_dtype'] == 'bfloat16'
    assert solo['clip'].get('compute_dtype') in (None, 'float32')
    for args in solo.values():
        create_extractor(args).extract_packed(list(clips))
    exs = {fam: create_extractor(args)
           for fam, args in configs(tmp_path / 'fused').items()}
    stats = run_packed_fused(exs, list(clips))
    assert stats == {'videos': 2, 'decode_passes': 2}
    got, want = npys(tmp_path / 'fused'), npys(tmp_path / 'solo')
    assert got == want and len(got) == 2 * 3 * len(clips)
