"""The port's timm family (video_features_torch/models/{vit,convnext,swin,
efficientnet,regnet,mobilenetv3,beit,mixer}.py, extract/timm.py and the
CLI around them) against the JAX package's, on the CPU.

Each family runs a narrow two-block arch added to both packages' ARCHS
under one name, with the seeded state_dict that both random inits give,
carried into the port through ``params_from_jax``."""
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract import timm as jax_timm
from video_features_tpu.models import beit as jax_beit
from video_features_tpu.models import convnext as jax_convnext
from video_features_tpu.models import efficientnet as jax_efficientnet
from video_features_tpu.models import mixer as jax_mixer
from video_features_tpu.models import mobilenetv3 as jax_mobilenetv3
from video_features_tpu.models import regnet as jax_regnet
from video_features_tpu.models import resnet as jax_resnet
from video_features_tpu.models import swin as jax_swin
from video_features_tpu.models import vit as jax_vit
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.config import load_config
from video_features_torch.extract import timm as timm_ex
from video_features_torch.models import (
    beit, convnext, efficientnet, mixer, mobilenetv3, regnet, resnet, swin, vit,
)
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import params_from_jax, params_from_torch

REL_L2 = 1e-5       # float32 through the stack, different sum orders
CLI_REL_L2 = 1e-3   # the BASELINE feature bar

# (port module, JAX module) per family
MODULES = {'vit': (vit, jax_vit), 'convnext': (convnext, jax_convnext),
           'swin': (swin, jax_swin), 'efficientnet': (efficientnet, jax_efficientnet),
           'regnet': (regnet, jax_regnet), 'mobilenetv3': (mobilenetv3, jax_mobilenetv3),
           'beit': (beit, jax_beit), 'mixer': (mixer, jax_mixer),
           'resnet': (resnet, jax_resnet)}

# narrow two-block archs, added to both packages' ARCHS
TINY = {
    'vit': ('vit_test', dict(width=64, layers=2, heads=2, patch=16)),
    'convnext': ('convnext_test', dict(depths=(1, 2, 1, 1), dims=(16, 24, 32, 48))),
    'swin': ('swin_test', dict(embed_dim=16, depths=(2, 2, 2, 2),
                               heads=(1, 2, 2, 4), patch=4, window=7)),
    'efficientnet': ('efficientnet_test', (0.25, 0.5, 64, 0.875)),
    'regnet': ('regnety_test', ([1, 2, 1, 1], [16, 24, 32, 48], 8)),
    'regnetx': ('regnetx_test', ([1, 2, 1, 1], [16, 24, 32, 48], 8)),
    'mobilenetv3': ('mobilenetv3_test', dict(stem=8, head=32, blocks=[
        [('ds', 3, 1, 8, 8, 're', 8)],
        [('ir', 3, 2, 16, 16, 'hs', 8), ('ir', 5, 1, 24, 16, 'hs', 0)],
        [('cn', 1, 1, 0, 32, 'hs', 0)]])),
    'beit': ('beit_test', dict(width=64, layers=2, heads=2, patch=16)),
    'mixer': ('mixer_test', dict(width=64, layers=2, patch=16)),
}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution can put ~4e-5 of error
    in one thread's chunk; one thread holds 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def tiny_archs():
    """The TINY archs in both packages' ARCHS for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for family, (name, cfg) in TINY.items():
            mine, theirs = MODULES[family.replace('regnetx', 'regnet')]
            mp.setitem(mine.ARCHS, name, cfg)
            mp.setitem(theirs.ARCHS, name, cfg)
        yield


def _init(family, arch, **kw):
    mine, theirs = MODULES[family]
    sd = theirs.init_state_dict(arch=arch, **kw)
    ours = mine.init_state_dict(arch=arch, **kw)
    assert sd.keys() == ours.keys()
    for k in sd:
        assert sd[k].dtype == ours[k].dtype and np.array_equal(sd[k], ours[k]), k
    return sd


@pytest.fixture(scope='module')
def nets(tiny_archs):
    """{key: (family, arch, JAX params, port params)}: one seeded model
    per family (plus the x branch of RegNet, distilled DeiT and a
    ConvNeXt without layer scale)."""
    out = {}
    for family, (arch, _) in TINY.items():
        fam = family.replace('regnetx', 'regnet')
        kw = {'num_classes': 10} if fam in ('swin', 'efficientnet', 'regnet',
                                            'mobilenetv3', 'beit', 'mixer') else {}
        sd = _init(fam, arch, **kw)
        if fam == 'convnext':      # a layer scale of 1e-6 would hide the blocks
            sd = {k: (np.full_like(v, 0.5) if k.endswith('gamma') else v)
                  for k, v in sd.items()}
        out[family] = (fam, arch, sd)
    out['deit'] = ('vit', 'vit_test', _init('vit', 'vit_test', distilled=True))
    out['convnext_no_gamma'] = ('convnext', 'convnext_test', {
        k: v for k, v in out['convnext'][2].items() if not k.endswith('gamma')})
    out['resnet'] = ('resnet', 'resnet18', _init('resnet', 'resnet18'))
    return {key: (fam, arch, transplant(sd), params_from_jax(transplant(sd)))
            for key, (fam, arch, sd) in out.items()}


def _forward_pair(nets, key, size, features=True, batch=2, seed=0):
    fam, arch, jp, tp = nets[key]
    x = np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)
    forward = jax.jit(partial(MODULES[fam][1].forward, arch=arch,
                              features=features))
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(forward(jp, jnp.asarray(x)))
    with torch.inference_mode():
        got = MODULES[fam][0].forward(tp, torch.from_numpy(x), arch=arch,
                                      features=features).numpy()
    return got, ref


@pytest.mark.parametrize('key,size,features', [
    ('vit', 224, True), ('vit', 224, False), ('deit', 224, True),
    ('deit', 224, False), ('convnext', 64, True), ('convnext', 64, False),
    ('convnext_no_gamma', 64, True), ('swin', 224, True), ('swin', 224, False),
    ('efficientnet', 64, True), ('efficientnet', 64, False),
    ('regnet', 64, True), ('regnet', 64, False), ('regnetx', 64, True),
    ('mobilenetv3', 64, True), ('mobilenetv3', 64, False),
    ('beit', 224, True), ('beit', 224, False), ('mixer', 224, True),
    ('mixer', 224, False), ('resnet', 64, True),
])
def test_forward_matches_jax(nets, key, size, features):
    got, ref = _forward_pair(nets, key, size, features)
    assert got.shape == ref.shape and got.shape[0] == 2
    assert np.isfinite(got).all()
    assert rel_l2(got, ref) <= REL_L2


@pytest.mark.parametrize('key,size', [
    ('vit', 320),      # 20×20 grid: the pos embed resampled
    ('deit', 160),     # 10×10: downsampled (the antialiased kernel)
    ('swin', 160),     # 40 → 5: padded windows, a window shrunk to the map
    ('swin', 96),      # 24 → 3
])
def test_forward_at_other_resolutions_matches_jax(nets, key, size):
    got, ref = _forward_pair(nets, key, size)
    assert rel_l2(got, ref) <= REL_L2


def test_vit_past_the_blockwise_threshold_matches_jax(nets):
    """768 px at patch 16: 48² + 1 = 2305 tokens ≥ 2048, so both packages
    attend blockwise (5 blocks of 512 keys, the last ragged) with the pos
    embed resampled 14 → 48."""
    assert 48 * 48 + 1 >= vit.BLOCKWISE_THRESHOLD == jax_vit.BLOCKWISE_THRESHOLD
    got, ref = _forward_pair(nets, 'vit', 768, batch=1, seed=3)
    assert got.shape == (1, 64)
    assert rel_l2(got, ref) <= REL_L2


@pytest.mark.parametrize('grid,n_prefix', [((20, 20), 1), ((48, 48), 1),
                                           ((10, 10), 1), ((20, 12), 2)])
def test_interpolate_pos_embed_matches_jax(grid, n_prefix):
    """jax.image.resize's bicubic (Keys a = -0.5, antialiased when
    downsampling) on the 14×14 grid; F.interpolate's bicubic (a = -0.75)
    misses the bar, which is why the port copies the weights."""
    pos = np.random.RandomState(1).randn(1, n_prefix + 14 * 14, 8).astype(np.float32)
    ref = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(pos), grid,
                                                   n_prefix=n_prefix))
    got = vit.interpolate_pos_embed(torch.from_numpy(pos), grid,
                                    n_prefix=n_prefix).numpy()
    assert got.shape == ref.shape == (1, n_prefix + grid[0] * grid[1], 8)
    assert np.array_equal(got[:, :n_prefix], pos[:, :n_prefix])
    assert rel_l2(got, ref) <= REL_L2
    g = torch.from_numpy(pos[:, n_prefix:]).reshape(1, 14, 14, 8).permute(0, 3, 1, 2)
    other = F.interpolate(g, size=grid, mode='bicubic', align_corners=False)
    other = other.permute(0, 2, 3, 1).reshape(1, -1, 8).numpy()
    assert rel_l2(other, ref[:, n_prefix:]) > 100 * REL_L2


def test_interpolate_pos_embed_at_the_native_grid_is_identity():
    pos = torch.randn(1, 1 + 14 * 14, 8)
    assert vit.interpolate_pos_embed(pos, (14, 14)) is pos


def test_distilled_deit_features_are_the_cls_dist_mean(nets):
    """Distilled DeiT: features = (cls + dist) / 2 after the final norm."""
    _, arch, _, tp = nets['deit']
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 224, 224, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        tokens = vit.layer_norm(vit.trunk(tp, vit.embed(tp, x, arch), arch),
                                tp['norm'])
        feats = vit.forward(tp, x, arch=arch)
    assert tokens.shape[1] == 2 + 14 * 14
    assert torch.allclose(feats, (tokens[:, 0] + tokens[:, 1]) / 2)
    spec = timm_ex.REGISTRY['deit_base_distilled_patch16_224']
    assert spec == dict(family='deit', arch='vit_base_patch16_224',
                        feat_dim=768, init=dict(distilled=True))


def test_hard_swish_and_sigmoid_match_jax():
    x = np.linspace(-6, 6, 1201, dtype=np.float32)
    for mine, theirs in ((F.hardswish, jax.nn.hard_swish),
                         (F.hardsigmoid, jax.nn.hard_sigmoid)):
        np.testing.assert_allclose(mine(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)


def test_beit_index_stays_long_through_both_transplants(nets):
    """BEiT's relative_position_index is an integer gather index: long
    from a torch state_dict and from the JAX tree, never float."""
    _, arch, jp, tp = nets['beit']
    assert tp['blocks']['0']['attn']['relative_position_index'].dtype == torch.long
    sd = beit.init_state_dict(arch=arch)
    from_torch = params_from_torch({k: torch.from_numpy(v) for k, v in sd.items()})
    idx = from_torch['blocks']['1']['attn']['relative_position_index']
    assert idx.dtype == torch.long and idx.shape == (197, 197)
    int32 = params_from_jax({'i': np.asarray(jp['blocks']['0']['attn']
                                             ['relative_position_index'], np.int32)})
    assert int32['i'].dtype == torch.long


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def test_params_from_jax_equals_the_state_dict_leaf_for_leaf(nets):
    """Every family's JAX tree comes back as the torch state_dict, leaf
    for leaf (layouts, dtypes and values), that params_from_torch gives."""
    for key, (fam, arch, jp, tp) in nets.items():
        if key in ('convnext', 'convnext_no_gamma', 'deit', 'regnetx'):
            continue
        kw = {'num_classes': 10} if fam in ('swin', 'efficientnet', 'regnet',
                                            'mobilenetv3', 'beit', 'mixer') else {}
        ref = _flat(params_from_torch(MODULES[fam][0].init_state_dict(arch=arch, **kw)))
        got = _flat(tp)
        assert got.keys() == ref.keys(), key
        for name in ref:
            assert got[name].dtype == ref[name].dtype, (key, name)
            assert torch.equal(got[name], ref[name]), (key, name)


def test_step_matches_the_jax_extractor_step(nets):
    """uint8 frames → [0, 1] → normalize → features, against the JAX
    extractor's step function (swin's ImageNet stats)."""
    fam, arch, jp, tp = nets['swin']
    cfg = timm_ex._data_cfg('swin')
    frames = np.random.RandomState(5).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    step = jax.jit(partial(jax_timm.ExtractTIMM._forward, family=fam, arch=arch,
                           mean=cfg['mean'], std=cfg['std']))
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(step(jp, jnp.asarray(frames)))
    with torch.inference_mode():
        got = timm_ex.timm_step(tp, torch.from_numpy(frames), fam, arch,
                                cfg['mean'], cfg['std']).numpy()
    assert rel_l2(got, ref) <= REL_L2


def test_registry_and_data_configs_equal_jax():
    """44 names; each one's family, arch, feature width, init and data
    config (resize, crop, interpolation, mean, std) as in the JAX
    package, and each family's ARCHS table."""
    assert timm_ex.REGISTRY == jax_timm.REGISTRY
    assert len(timm_ex.REGISTRY) == 44
    for spec in timm_ex.REGISTRY.values():
        assert timm_ex._data_cfg(spec['family'], spec['arch']) == \
            jax_timm._data_cfg(spec['family'], spec['arch'])
    for fam, (mine, theirs) in MODULES.items():
        assert mine.ARCHS == theirs.ARCHS, fam
    assert set(timm_ex.MODEL_MODULES) == set(jax_timm._MODEL_MODULES)


@pytest.mark.parametrize('name,resolved', [
    ('hf_hub:timm/vit_base_patch16_224.augreg_in21k', 'vit_base_patch16_224'),
    ('timm/convnext_tiny.fb_in1k', 'convnext_tiny'),
    ('deit_small_distilled_patch16_224', 'deit_small_distilled_patch16_224'),
])
def test_model_names_resolve_by_their_tail(name, resolved):
    assert timm_ex.resolve_model_name(name) is timm_ex.REGISTRY[resolved]


@pytest.fixture(scope='module')
def clip_path(tmp_path_factory):
    return write_noise_clip(tmp_path_factory.mktemp('timm') / 'v.mp4', 3)


def _cfg(clip_path, tmp_path, **overrides):
    return {'video_paths': clip_path, 'device': 'cpu', 'allow_random_weights': True,
            'output_path': str(tmp_path / 'out'), 'tmp_path': str(tmp_path / 'tmp'),
            **overrides}


def test_model_name_is_required(clip_path, tmp_path):
    with pytest.raises(ValueError, match='model_name'):
        load_config('timm', overrides=_cfg(clip_path, tmp_path))


def test_unknown_model_name_is_refused_listing_the_registry(clip_path, tmp_path):
    with pytest.raises(NotImplementedError, match='not in the native') as e:
        load_config('timm', overrides=_cfg(clip_path, tmp_path,
                                           model_name='maxvit_tiny_tf_224'))
    assert all(name in str(e.value) for name in timm_ex.REGISTRY)


@pytest.mark.parametrize('model_name', ['beit_base_patch16_224', 'mixer_b16_224'])
def test_image_size_is_refused_for_beit_and_mixer_before_weights_load(
        clip_path, tmp_path, model_name):
    """Refused before the checkpoint is read: a missing file would raise
    FileNotFoundError if it were."""
    args = load_config('timm', overrides=_cfg(
        clip_path, tmp_path, model_name=model_name, image_size=384,
        checkpoint_path=str(tmp_path / 'missing.pt')))
    with pytest.raises(NotImplementedError, match='image_size'):
        create_extractor(args)


def test_image_size_must_be_a_patch_multiple(clip_path, tmp_path):
    args = load_config('timm', overrides=_cfg(clip_path, tmp_path,
                                              model_name='vit_tiny_patch16_224',
                                              image_size=350))
    with pytest.raises(ValueError, match='multiple of the patch'):
        create_extractor(args)


def test_image_size_scales_the_host_recipe(clip_path, tmp_path):
    """The crop becomes image_size and the resize keeps the family's
    crop_pct, as in the JAX package: vit 248 at 224 → round(248·768/224)
    = 850 at 768."""
    ex = create_extractor(load_config('timm', overrides=_cfg(
        clip_path, tmp_path, model_name='vit_tiny_patch16_224', image_size=768)))
    assert (ex.data_cfg['resize'], ex.data_cfg['crop']) == (850, 768)
    frame = np.random.RandomState(0).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    assert ex.host_transform(frame).shape == (768, 768, 3)


def test_sequence_parallel_is_refused_naming_the_key(clip_path, tmp_path):
    """sequence_parallel is ported for ViT/DeiT at float32; on the bf16
    lane it is refused naming the key, before the weights load."""
    with pytest.raises(NotImplementedError, match='sequence_parallel'):
        create_extractor(load_config('timm', overrides=_cfg(
            clip_path, tmp_path, model_name='vit_tiny_patch16_224',
            sequence_parallel=True, compute_dtype='bfloat16')))


def test_missing_checkpoint_is_an_error(clip_path, tmp_path, monkeypatch):
    """No checkpoint_path and no allow_random_weights: the port does not
    download (it never imports pip timm), so the run fails."""
    from video_features_torch.extract.weights import MissingCheckpointError
    monkeypatch.delenv('VFT_ALLOW_RANDOM_WEIGHTS', raising=False)
    args = load_config('timm', overrides=_cfg(
        clip_path, tmp_path, model_name='resnet18', allow_random_weights=False))
    assert args['pretrained'] is True
    with pytest.raises(MissingCheckpointError, match='checkpoint_path'):
        create_extractor(args)


def test_npz_checkpoint_in_the_jax_layout_loads(nets, clip_path, tmp_path):
    """A .npz in the JAX package's transplanted layout loads through
    ``checkpoint_path`` to the same params as the state_dict."""
    from video_features_tpu.transplant.torch2jax import save_transplanted
    sd = resnet.init_state_dict(seed=3, arch='resnet18')
    save_transplanted(transplant(sd), str(tmp_path / 'r18.npz'))
    ex = create_extractor(load_config('timm', overrides=_cfg(
        clip_path, tmp_path, model_name='resnet18',
        checkpoint_path=str(tmp_path / 'r18.npz'))))
    ref = _flat(params_from_torch(sd))
    got = _flat(ex.params)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one clip, ViT-B/16 at full width named by its hf-hub
    id, batch 2 with a short tail: the features within the bar under the
    sanitized <out>/timm/hf_hub:timm_vit_base_patch16_224.augreg_in21k/,
    _fps.npy and _timestamps_ms.npy identical."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 3, seed=9)
    name = 'hf_hub:timm/vit_base_patch16_224.augreg_in21k'
    common = [f'video_paths={clip}', 'device=cpu', 'allow_random_weights=true',
              'feature_type=timm', f'model_name={name}', 'batch_size=2',
              'on_extraction=save_numpy']
    assert jax_main([*common, 'decode_backend=cv2', 'pretrained=false',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "jax_tmp"}']) == 0
    torch.set_num_threads(4)
    assert torch_main([*common, f'output_path={tmp_path / "torch"}',
                       f'tmp_path={tmp_path / "torch_tmp"}']) == 0
    sub = name.replace('/', '_')
    out = {side: tmp_path / side / 'timm' / sub for side in ('jax', 'torch')}
    ref, got = (np.load(out[s] / 'clip_timm.npy') for s in ('jax', 'torch'))
    assert got.shape == ref.shape == (3, 768)
    assert rel_l2(got, ref) <= CLI_REL_L2
    for key in ('fps', 'timestamps_ms'):
        assert np.array_equal(np.load(out['torch'] / f'clip_{key}.npy'),
                              np.load(out['jax'] / f'clip_{key}.npy'))
