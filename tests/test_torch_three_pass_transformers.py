"""The three-pass lane of the clip and timm families on the CPU: every
convolution, linear and product of each step routed per ``precision``
value (convolutions to ``ops/conv_tf32x3.py``, depthwise ones to
``ops/dwconv.py``, linears and attention products to
``ops/gemm_tf32x3.py``) with the libraries' TF32 flags; the port's
``high`` and ``mixed`` against the JAX package's ``mixed`` on seeded
weights (narrow CLIP ViT and RN50 towers, a narrow two-block arch of
every timm family, ViT past the blockwise threshold); the fingerprint;
every registered arch's grouped convolutions fit a kernel; the ``mixed``
program's kernel nodes."""
import threading
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_clip import rn50_state_dict
from tests.test_torch_timm import MODULES, TINY, _init
from video_features_tpu.extract.clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.extract.timm import ExtractTIMM as JaxExtractTIMM
from video_features_tpu.models import clip as jax_clip
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch import registry
from video_features_torch.cache import key
from video_features_torch.config import load_config
from video_features_torch.extract import clip as clip_extract
from video_features_torch.extract import timm as timm_ex
from video_features_torch.models import clip as clip_model
from video_features_torch.models import (
    convnext, efficientnet, mobilenetv3, regnet, resnet, vit,
)
from video_features_torch.ops import conv_tf32x3, dwconv, nn
from video_features_torch.ops import gemm_tf32x3 as gemm
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import params_from_jax, params_from_torch
from video_features_torch.utils import device

JAX_REL_L2 = 1e-5       # float32 on both sides, different sum orders
THREE = ('high', 'mixed')
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)

# a narrow CLIP ViT added to both packages' VISUAL_CFGS
CLIP_VIT = 'ViT-test/32'
CLIP_VIT_CFG = dict(kind='vit', width=64, layers=2, heads=2, patch=32,
                    input_resolution=64, embed_dim=32)
# the frames each timm family steps on (BEiT and Mixer are tied to 224)
SIZES = {'vit': 224, 'deit': 224, 'beit': 224, 'mixer': 224, 'swin': 224,
         'convnext': 64, 'efficientnet': 64, 'mobilenetv3': 64,
         'regnet': 64, 'regnetx': 64, 'resnet': 64}
HEADS = ('head', 'head_dist', 'classifier', 'fc')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: convolutions held to 1e-5, and the tier-1 run has
    several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _frames(seed, size, batch=2):
    return np.random.RandomState(seed).randint(
        0, 256, (batch, size, size, 3)).astype(np.uint8)


@pytest.fixture(scope='module')
def archs():
    """The narrow archs in both packages' tables, and each TINY timm arch
    in the port's registry under its own name, for the module."""
    with pytest.MonkeyPatch.context() as mp:
        for family, (name, cfg) in TINY.items():
            mine, theirs = MODULES[family.replace('regnetx', 'regnet')]
            mp.setitem(mine.ARCHS, name, cfg)
            mp.setitem(theirs.ARCHS, name, cfg)
            fam = family.replace('regnetx', 'regnet')
            mp.setitem(timm_ex.REGISTRY, name,
                       dict(family=fam, arch=name, feat_dim=0))
        mp.setitem(timm_ex.REGISTRY, 'deit_test',
                   dict(family='deit', arch='vit_test', feat_dim=0,
                        init=dict(distilled=True)))
        mp.setitem(clip_model.VISUAL_CFGS, CLIP_VIT, dict(CLIP_VIT_CFG))
        mp.setitem(jax_clip.VISUAL_CFGS, CLIP_VIT, dict(CLIP_VIT_CFG))
        yield


@pytest.fixture(scope='module')
def nets(archs):
    """{key: (family, arch, JAX params, port params, state_dict)}: one
    seeded model per timm family (the x branch of RegNet, distilled DeiT
    and timm's ResNet among them), the narrow CLIP ViT and RN50."""
    out = {}
    for family, (arch, _) in TINY.items():
        fam = family.replace('regnetx', 'regnet')
        sd = _init(fam, arch)
        if fam == 'convnext':      # a layer scale of 1e-6 would hide the blocks
            sd = {k: (np.full_like(v, 0.5) if k.endswith('gamma') else v)
                  for k, v in sd.items()}
        out[family] = (fam, arch, sd)
    out['deit'] = ('vit', 'vit_test', _init('vit', 'vit_test', distilled=True))
    out['resnet'] = ('resnet', 'resnet18', _init('resnet', 'resnet18'))
    nets = {k: (fam, arch, transplant(sd), params_from_jax(transplant(sd)), sd)
            for k, (fam, arch, sd) in out.items()}
    no_t = set(jax_clip.NO_TRANSPOSE)
    for name, sd, arch in (
            ('clip_vit', clip_model.init_state_dict(seed=0, model_name=CLIP_VIT),
             CLIP_VIT),
            ('clip_rn', rn50_state_dict(seed=1, grid=2), 'RN50')):
        nets[name] = ('clip', arch, transplant(sd, no_transpose=no_t),
                      params_from_torch(sd), sd)
    return nets


def _size(key):
    return 64 if key.startswith('clip') else SIZES[key]


def _port_step(nets, key, frames, precision, plain=False):
    """The port's step under ``precision``: its scope, and the hand
    kernels' route where the lane has one (their plain versions with
    ``plain``; on the CPU the kernels' wrappers take them anyway)."""
    fam, arch, _, tp, _ = nets[key]
    ft = 'clip' if fam == 'clip' else 'timm'
    three = device.three_pass_convs(precision, ft)
    x = torch.from_numpy(frames)
    with torch.inference_mode(), device.precision_scope(precision, ft), \
            nn.three_pass_route(three and plain, plain=True, products=True):
        if fam == 'clip':
            return clip_extract.clip_step(tp, x, arch, three_pass_convs=three)
        return timm_ex.timm_step(tp, x, fam, arch, MEAN, STD,
                                 three_pass_convs=three)


@pytest.fixture(scope='module')
def jax_mixed(nets):
    """Each key's JAX step (the extractors' ``_forward``, jitted) under the
    JAX package's mixed: ambient ``high``; ViT also at 768 px (2305
    tokens: blockwise attention)."""
    refs = {}
    with jax.default_matmul_precision('high'):
        for k, (fam, arch, jp, _, _) in nets.items():
            frames = _frames(sorted(nets).index(k), _size(k))
            if fam == 'clip':
                fn = jax.jit(partial(JaxExtractCLIP._forward, arch=arch))
            else:
                fn = jax.jit(partial(JaxExtractTIMM._forward, family=fam,
                                     arch=arch, mean=MEAN, std=STD))
            refs[k] = (frames, np.asarray(fn(jp, jnp.asarray(frames))))
        fam, arch, jp, _, _ = nets['vit']
        frames = _frames(31, 768, batch=1)
        fn = jax.jit(partial(JaxExtractTIMM._forward, family=fam, arch=arch,
                             mean=MEAN, std=STD))
        refs['vit_768'] = (frames, np.asarray(fn(jp, jnp.asarray(frames))))
    return refs


KEYS = ('clip_vit', 'clip_rn', 'vit', 'deit', 'beit', 'swin', 'mixer',
        'convnext', 'efficientnet', 'mobilenetv3', 'regnet', 'regnetx',
        'resnet')


@pytest.mark.parametrize('precision', THREE)
@pytest.mark.parametrize('key', KEYS)
def test_high_and_mixed_hold_the_jax_packages_mixed(nets, jax_mixed, key,
                                                    precision):
    """The port's step under high and mixed (every convolution, linear and
    product through the hand kernels' wrappers, their plain versions on
    the CPU) against the JAX package's mixed step at rel L2 <= 1e-5."""
    frames, want = jax_mixed[key]
    got = _port_step(nets, key, frames, precision).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_l2(got, want) <= JAX_REL_L2


@pytest.mark.parametrize('precision', THREE)
def test_vit_past_the_blockwise_threshold_holds_the_jax_packages_mixed(
        nets, jax_mixed, precision):
    """768 px at patch 16 (2305 tokens): blockwise attention's products,
    512 keys a block with the last ragged, on the route."""
    frames, want = jax_mixed['vit_768']
    assert 48 * 48 + 1 >= vit.BLOCKWISE_THRESHOLD
    got = _port_step(nets, 'vit', frames, precision).numpy()
    assert rel_l2(got, want) <= JAX_REL_L2


def test_the_plain_route_gives_the_kernels_wrappers_bytes_on_the_cpu(
        nets, jax_mixed):
    """``plain=True`` (the plain versions named) and the kernels' route
    (their wrappers, which take the plain versions for a CPU tensor) give
    the same bytes."""
    for k in ('clip_vit', 'convnext', 'swin'):
        frames, _ = jax_mixed[k]
        assert torch.equal(_port_step(nets, k, frames, 'mixed'),
                           _port_step(nets, k, frames, 'mixed', plain=True))


# -- the route: every product of each step, per precision ---------------------------


@pytest.fixture
def spies(monkeypatch):
    """Calls of the hand kernels' wrappers and their plain versions, the
    library convolution and ``F.linear``, each with the TF32 flags in
    force; the grouped convolutions' group counts."""
    calls = {name: [] for name in ('conv', 'conv_plain', 'dw', 'dw_plain',
                                   'gemm', 'gemm_plain', 'library_conv',
                                   'library_linear', 'grouped')}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls[name].append((torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32,
                                threading.current_thread().name))
            if name == 'conv' and len(args) > 5 and args[5] > 1:
                calls['grouped'].append(args[5])
            return fn(*args, **kwargs)
        return call
    for mod, attr, name in (
            (conv_tf32x3, 'conv_tf32x3', 'conv'),
            (conv_tf32x3, 'conv_tf32x3_plain', 'conv_plain'),
            (dwconv, 'dwconv_f32', 'dw'), (dwconv, 'dwconv_f32_plain', 'dw_plain'),
            (gemm, 'gemm_tf32x3', 'gemm'), (gemm, 'gemm_tf32x3_plain', 'gemm_plain'),
            (nn, 'library_conv', 'library_conv'),
            (torch.nn.functional, 'linear', 'library_linear')):
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    return calls


def reckon(fam, sd):
    """The kernels' launches per step as reckoned from the state_dict:
    every 4-D weight is a convolution (a depthwise one where it has one
    input channel), every other 2-D weight a linear, and each attention
    block two products (QKᵀ, PV); the heads are not on the feature path.
    Returns (convolutions in conv_tf32x3, depthwise, GEMMs)."""
    used = {k: v for k, v in sd.items() if k.split('.')[0] not in HEADS}
    convs = [k for k, v in used.items() if v.ndim == 4 and k.endswith('weight')]
    dw = [k for k in convs if used[k].shape[1] == 1 and 'dw' in k]
    linears = [k for k, v in used.items() if v.ndim == 2 and k.endswith('weight')
               and 'embedding' not in k]
    if fam == 'clip':
        blocks = 1 if 'visual.attnpool.q_proj.weight' in sd else len(
            {k.split('.')[3] for k in sd if k.startswith('visual.transformer.')})
        # the text tower and its projection are not on the image path
        linears = [k for k in linears if k.startswith('visual.')]
        linears += ['visual.proj'] if 'visual.proj' in sd else []
        convs = [k for k in convs if k.startswith('visual.')]
    else:
        blocks = len({k.split('.')[1] for k in sd if k.startswith('blocks.')
                      and '.attn.' in k})
        blocks += len({k.rsplit('.attn.', 1)[0] for k in sd
                       if k.startswith('layers.') and '.attn.' in k})
    return len(convs) - len(dw), len(dw), len(linears) + 2 * blocks


def _extractor(tmp_path, key, precision, compute_dtype='float32'):
    overrides = {'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
                 'allow_random_weights': True, 'precision': precision,
                 'compute_dtype': compute_dtype,
                 'output_path': str(tmp_path / 'out')}
    if key == 'clip_vit':
        return create_extractor(load_config('clip', dict(
            overrides, model_name=CLIP_VIT)))
    name = {'deit': 'deit_test', 'resnet': 'resnet18'}.get(key, TINY.get(
        key, (None,))[0])
    return create_extractor(load_config('timm', dict(overrides,
                                                     model_name=name)))


@pytest.mark.parametrize('lane', [('highest', 'float32'), ('high', 'float32'),
                                  ('mixed', 'float32'),
                                  ('tensorfloat32', 'float32'),
                                  ('bfloat16', 'float32'),
                                  ('mixed', 'bfloat16')])
@pytest.mark.parametrize('key', KEYS[:1] + KEYS[2:])
def test_each_step_routes_every_product_on_the_lane(tmp_path, nets, spies,
                                                    key, lane):
    """The extractor's dispatched step (``run_step``): under high and mixed
    every convolution to the 3xTF32 convolution's wrapper (RegNet's
    grouped 3×3s among them), every depthwise one to the fp32 kernel's,
    every linear and attention product to the GEMM's, as reckoned from the
    weights, with TF32 off in the libraries and nothing left in them;
    under highest, tensorfloat32, bfloat16 and compute_dtype=bfloat16
    nothing on the route."""
    precision, dtype = lane
    ex = _extractor(tmp_path, key, precision, dtype)
    three = precision in THREE and dtype == 'float32'
    assert ex.three_pass_convs == three
    assert ex.program_specs()[0].kwargs['three_pass_convs'] == three
    ex.run_step(_frames(5, _size(key), batch=1))
    fam, _, _, _, sd = nets[key]
    if key == 'clip_vit':
        sd = clip_model.init_state_dict(seed=0, model_name=CLIP_VIT)
    convs, dws, gemms = reckon(fam, sd)
    routed = ('conv', 'dw', 'gemm')
    if three:
        assert (len(spies['conv']), len(spies['dw']), len(spies['gemm'])) \
            == (convs, dws, gemms)
        for name in routed:       # the CPU's plain versions, one per call
            assert len(spies[f'{name}_plain']) == len(spies[name])
        assert not spies['library_linear']
        assert {c[:2] for name in routed for c in spies[name]} == {(False, False)}
        grouped = 0
        if fam == 'regnet':
            depths, widths, gw = regnet.ARCHS[nets[key][1]]
            grouped = sum(d for d, w in zip(depths, widths) if w // gw > 1)
        assert len(spies['grouped']) == grouped
    else:
        assert not any(spies[name] for name in routed)
        assert not any(spies[f'{name}_plain'] for name in routed)
        assert len(spies['library_conv']) == convs + dws
        tf32 = device.library_tf32(precision, ex.feature_type, dtype)
        assert {c[:2] for c in spies['library_conv']} == {(tf32, tf32)}


def test_the_rn50_tower_routes_every_product(nets, spies):
    """CLIP RN50 (no random init: a seeded checkpoint's params) under
    mixed: its 3-conv stem (a 3-channel input padded to 4 in the kernel's
    wrapper on the card), 16 bottlenecks and 4 downsamples in the 3xTF32
    convolution, AttentionPool2d's 4 linears and 2 products in the GEMM."""
    frames = _frames(6, 64)
    _port_step(nets, 'clip_rn', frames, 'mixed')
    convs, dws, gemms = reckon('clip', nets['clip_rn'][4])
    assert (convs, dws, gemms) == (3 + 16 * 3 + 4, 0, 6)
    assert (len(spies['conv']), len(spies['dw']), len(spies['gemm'])) \
        == (convs, dws, gemms)
    assert not spies['library_linear'] and not spies['library_conv']


def test_show_pred_products_run_on_the_lane(tmp_path, spies):
    """CLIP's zero-shot logits and a timm head under mixed: their products
    go to the GEMM, with TF32 off."""
    ex = _extractor(tmp_path, 'vit', 'mixed')
    ex.params['head'] = {'weight': torch.randn(10, 64), 'bias': torch.zeros(10)}
    ex.maybe_show_pred(np.random.RandomState(7).randn(2, 64).astype(np.float32))
    assert len(spies['gemm']) == 1 and not spies['library_linear']
    cex = _extractor(tmp_path, 'clip_vit', 'mixed')
    spies['gemm'].clear()
    with torch.inference_mode(), cex.precision_scope(), \
            nn.three_pass_route(cex.three_pass_convs, products=True):
        clip_model.zero_shot_logits(cex.params, torch.randn(2, 32),
                                    torch.randn(5, 32))
    assert len(spies['gemm']) == 1
    assert {c[:2] for c in spies['gemm']} == {(False, False)}


def test_the_lane_names_the_three_libraries_on_the_card(monkeypatch, tmp_path,
                                                        archs):
    """clip and timm list the 3xTF32 convolution's, the GEMM's and the
    depthwise kernel's libraries under high and mixed on the card (so
    ``aot_warm`` and the executable store reach them), none on the CPU."""
    for k in ('clip_vit', 'convnext'):
        ex = _extractor(tmp_path, k, 'mixed')
        assert ex.kernel_libraries() == ()
        monkeypatch.setattr(ex, 'device', torch.device('cuda'))
        for precision in device.PRECISIONS:
            monkeypatch.setattr(ex, 'three_pass_convs', device.three_pass_convs(
                precision, ex.feature_type))
            assert ex.kernel_libraries() == (
                ('conv_tf32x3', 'gemm_tf32x3', 'dwconv_f32')
                if precision in THREE else ())


def test_the_registry_puts_clip_and_timm_on_the_lane():
    assert registry.THREE_PASS_FEATURES == set(registry.EXTRACTORS)
    assert registry.THREE_PASS_PRODUCT_FEATURES == {'clip', 'timm'}
    assert {'clip', 'timm'} <= registry.MIXED_FEATURES
    for ft in ('clip', 'timm'):
        assert device.three_pass_convs('mixed', ft)
        assert not device.three_pass_convs('mixed', ft, 'bfloat16')
        assert not device.library_tf32('high', ft)
        assert device.library_tf32('tensorfloat32', ft)


# -- the fingerprint ---------------------------------------------------------------


def _old_fingerprint(args):
    import hashlib
    relevant = {kk: v for kk, v in args.items()
                if kk not in key.CONFIG_KEY_EXCLUDE and not key.is_file_key(kk)}
    if relevant.get('compute_dtype') is None:
        relevant['compute_dtype'] = 'float32'
    return hashlib.sha256(key._canonical(relevant).encode()).hexdigest()


@pytest.mark.parametrize('ft', sorted(registry.EXTRACTORS))
def test_the_fingerprint_names_the_lanes_arithmetic(tmp_path, ft):
    """clip and timm under high and mixed key on a token that names the
    GEMM and the depthwise kernel besides the convolution (an output of
    their one-pass lane never answers); the six convolutional families
    keep their token byte for byte; every other lane keeps its key."""
    assert key.THREE_PASS_TOKEN == 'conv_tf32x3.wgmma'
    assert key.THREE_PASS_PRODUCTS_TOKEN == \
        'conv_tf32x3.wgmma+gemm_tf32x3.wgmma+dwconv_f32'
    for precision in device.PRECISIONS:
        for dtype in ('float32', 'bfloat16'):
            overrides = {'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
                         'precision': precision, 'compute_dtype': dtype,
                         'output_path': str(tmp_path / 'out')}
            if ft == 'timm':
                overrides['model_name'] = 'vit_tiny_patch16_224'
            try:
                args = load_config(ft, overrides)
            except (ValueError, NotImplementedError):
                continue              # a family without the bf16 lane
            new, old = key.config_fingerprint(args), _old_fingerprint(args)
            if precision in THREE and dtype == 'float32':
                token = (key.THREE_PASS_PRODUCTS_TOKEN if ft in ('clip', 'timm')
                         else key.THREE_PASS_TOKEN)
                assert new == _old_fingerprint(dict(args,
                                                    lane_arithmetic=token))
                assert new != old
            else:
                assert new == old, (ft, precision, dtype)


# -- every registered arch fits ----------------------------------------------------


def grouped_convolutions(family, arch):
    """Each grouped convolution of an arch as its model builds it:
    ``(out channels, groups, in channels per group, kernel, stride)``."""
    out = []
    if family == 'regnet':
        depths, widths, gw = regnet.ARCHS[arch]
        for d, w in zip(depths, widths):
            if w // gw > 1:
                out += [(w, w // gw, gw, 3, s) for s in [2] + [1] * (d - 1)]
    elif family == 'resnet':
        cfg = resnet.ARCHS[arch]
        groups, base = cfg.get('groups', 1), cfg.get('base_width', 64)
        if groups > 1:
            for planes in (64, 128, 256, 512):
                width = int(planes * base / 64) * groups
                out += [(width, groups, width // groups, 3, 2)]
    elif family == 'convnext':
        cfg = convnext.ARCHS[arch]
        out += [(c, c, 1, 7, 1) for c, d in zip(cfg['dims'], cfg['depths'])
                for _ in range(d)]
    elif family == 'efficientnet':
        cin = efficientnet.stem_head_channels(arch)[0]
        for si, (kk, s, e, c, r) in enumerate(efficientnet.stage_table(arch)):
            for bi in range(r):
                ch = cin if si == 0 else cin * e
                out += [(ch, ch, 1, kk, s if bi == 0 else 1)]
                cin = c
    elif family == 'mobilenetv3':
        for stage in mobilenetv3.ARCHS[arch]['blocks']:
            for kind, kk, s, mid, c, _, _ in stage:
                if kind != 'cn':
                    ch = mid if kind == 'ir' else c
                    out += [(ch, ch, 1, kk, s)]
    return out


def _fits(o, groups, ig, k, stride):
    if ig == 1 and o == groups:               # depthwise: the fp32 kernel
        return dwconv.smem_bytes(k, k, stride, stride) <= dwconv.SMEM_OPTIN
    bn, tiles = conv_tf32x3.channel_tiles(o, groups, ig)
    return bn * tiles == o


def test_every_registered_arch_has_a_kernel_for_each_grouped_convolution():
    """Every timm and CLIP arch in the registries: each grouped
    convolution has a tile plan in the 3xTF32 convolution's grouped mode
    (RegNet's group widths, ResNeXt's) or fits the depthwise kernel
    (ConvNeXt, EfficientNet, MobileNetV3); CLIP's towers have none."""
    seen = set()
    for name, spec in timm_ex.REGISTRY.items():
        for conv in grouped_convolutions(spec['family'], spec['arch']):
            assert _fits(*conv), (name, conv)
            seen.add(spec['family'])
    assert seen == {'regnet', 'resnet', 'convnext', 'efficientnet',
                    'mobilenetv3'}
    for name in clip_model.VISUAL_CFGS:
        assert clip_model.VISUAL_CFGS[name]['kind'] in ('vit', 'resnet')


def test_the_reckoned_grouped_convolutions_are_the_steps(nets, spies):
    """The table above against the narrow archs' steps: the same grouped
    and depthwise convolutions reach the wrappers."""
    frames = _frames(8, 64, batch=1)
    for k in ('regnet', 'convnext', 'efficientnet', 'mobilenetv3'):
        for name in spies:
            spies[name].clear()
        _port_step(nets, k, frames, 'mixed')
        fam, arch = nets[k][:2]
        table = grouped_convolutions(fam, arch)
        if fam == 'regnet':
            assert len(spies['grouped']) == len(table)
        else:
            assert len(spies['dw']) == len(table)
        assert len(spies['dw']) + len(spies['grouped']) > 0


# -- the mixed program --------------------------------------------------------------


def test_the_mixed_clip_program_has_one_node_per_product(archs):
    """Traced for the card on fake CUDA tensors (``analysis/programs.py``),
    the narrow CLIP ViT's step under mixed holds one ``vft::conv_tf32x3``
    node (the patch embedding) and one ``vft::gemm_tf32x3`` node per
    linear and product (2 blocks of 6, the projection), nothing else."""
    from video_features_torch.analysis import programs
    ex = programs.build_family('clip', overrides={'precision': 'mixed',
                                                  'model_name': CLIP_VIT})
    sig, _ = programs.program_signature(ex.program_specs()[0])
    vft = {name: n for name, n in sig['ops'].items() if name.startswith('vft.')}
    assert vft == {'vft.conv_tf32x3.default': 1, 'vft.gemm_tf32x3.default': 13}
    assert sig['kernels'] == 14


def test_the_mixed_convnext_program_has_a_depthwise_node_per_block(archs):
    from video_features_torch.analysis import programs
    ex = programs.build_family('timm', overrides={
        'precision': 'mixed', 'model_name': TINY['convnext'][0]})
    sig, _ = programs.program_signature(ex.program_specs()[0])
    vft = {name: n for name, n in sig['ops'].items() if name.startswith('vft.')}
    blocks = sum(TINY['convnext'][1]['depths'])
    assert vft == {'vft.conv_tf32x3.default': 4,
                   'vft.dwconv_f32.default': blocks,
                   'vft.gemm_tf32x3.default': 2 * blocks}
