"""The port's HF checkpoint re-keying (video_features_torch/transplant/hf.py)
against the JAX package's on the CPU: for every family, a random
``transformers`` model built from a config (no download) goes through
both packages' converters, which must give the same keys and equal
arrays; the converted vit, convnext and regnet run through the port's
models and agree with ``transformers``' own forward; the converter's
``__main__`` writes a ``.pt`` that ``checkpoint_path`` loads."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_features_torch.models import convnext as convnext_model
from video_features_torch.models import regnet as regnet_model
from video_features_torch.models import vit as vit_model
from video_features_torch.transplant import params_from_torch
from video_features_torch.transplant import hf

transformers = pytest.importorskip('transformers')

REPO = __import__('pathlib').Path(__file__).resolve().parents[1]
REL_L2 = 1e-5     # float32 on both sides, one thread


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _randomize_bn(model, seed):
    """Random BN statistics and affine params: a fresh BN is the identity
    and would hide a weight/bias swap."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean = torch.randn(m.num_features, generator=gen) * 0.1
            m.running_var = torch.rand(m.num_features, generator=gen) + 0.5
            with torch.no_grad():
                m.weight.copy_(torch.rand(m.num_features, generator=gen)
                               * 0.2 + 0.9)
                m.bias.copy_(torch.randn(m.num_features, generator=gen) * 0.02)


def _vit_config(cls, **extra):
    cfg = vit_model.ARCHS['vit_tiny_patch16_224']
    return cls(hidden_size=cfg['width'], num_hidden_layers=cfg['layers'],
               num_attention_heads=cfg['heads'],
               intermediate_size=cfg['width'] * 4, image_size=224,
               patch_size=cfg['patch'], hidden_act='gelu',
               layer_norm_eps=1e-6, attention_probs_dropout_prob=0.0,
               hidden_dropout_prob=0.0, **extra)


def _build(family):
    """(HF model, converter arguments) at the arch the JAX package's
    tests/test_hf_crosscheck.py uses."""
    torch.manual_seed(0)
    if family == 'vit':
        return (transformers.ViTModel(_vit_config(transformers.ViTConfig),
                                      add_pooling_layer=False).eval(),
                'vit_tiny_patch16_224')
    if family == 'deit':
        return (transformers.DeiTModel(_vit_config(transformers.DeiTConfig),
                                       add_pooling_layer=False).eval(),
                'vit_tiny_patch16_224')
    if family == 'beit':
        model = transformers.BeitModel(transformers.BeitConfig(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, image_size=224, patch_size=16,
            use_relative_position_bias=True,
            use_absolute_position_embeddings=False, use_mean_pooling=True,
            layer_scale_init_value=0.1, layer_norm_eps=1e-6,
            hidden_act='gelu'), add_pooling_layer=True).eval()
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for layer in model.encoder.layer:
                layer.attention.attention.relative_position_bias \
                    .relative_position_bias_table.normal_(0, 0.05,
                                                          generator=gen)
        return model, 'beit_base_patch16_224'
    if family == 'convnext':
        cfg = convnext_model.ARCHS['convnext_tiny']
        return (transformers.ConvNextModel(transformers.ConvNextConfig(
            depths=list(cfg['depths']), hidden_sizes=list(cfg['dims']),
            layer_norm_eps=1e-6, hidden_act='gelu')).eval(), 'convnext_tiny')
    if family == 'swin':
        return (transformers.SwinModel(transformers.SwinConfig(
            image_size=224, patch_size=4, embed_dim=96, depths=[2, 2, 6, 2],
            num_heads=[3, 6, 12, 24], window_size=7, hidden_act='gelu',
            use_absolute_embeddings=False, layer_norm_eps=1e-5,
            drop_path_rate=0.0, attention_probs_dropout_prob=0.0,
            hidden_dropout_prob=0.0), add_pooling_layer=True).eval(),
            'swin_tiny_patch4_window7_224')
    if family in ('regnety', 'regnetx'):
        arch = f'{family}_008'
        depths, widths, group_w = regnet_model.ARCHS[arch]
        model = transformers.RegNetModel(transformers.RegNetConfig(
            embedding_size=32, hidden_sizes=list(widths), depths=list(depths),
            groups_width=group_w, layer_type=family[-1],
            hidden_act='relu')).eval()
        _randomize_bn(model, 3)
        return model, arch
    if family == 'clip':
        cfg = transformers.CLIPConfig()
        cfg.text_config.eos_token_id = 49407
        return transformers.CLIPModel(cfg).eval(), ''
    raise KeyError(family)


def _convert(pkg, family, sd, arch):
    if family == 'clip':
        return pkg.clip_to_openai(sd, arch)
    return pkg.hf_to_timm('regnet' if family.startswith('regnet') else family,
                          sd, arch)


@pytest.mark.parametrize('family', ['vit', 'deit', 'beit', 'convnext', 'swin',
                                    'regnety', 'regnetx', 'clip'])
def test_rekeying_equals_the_jax_packages(family):
    """Same keys, equal arrays: the re-keying moves no number."""
    from video_features_tpu.transplant import hf as jax_hf
    model, arch = _build(family)
    sd = model.state_dict()
    got = _convert(hf, family, sd, arch)
    want = _convert(jax_hf, family, sd, arch)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _port_features(family, params, x):
    arch_fwd = {'vit': (vit_model, 'vit_tiny_patch16_224'),
                'convnext': (convnext_model, 'convnext_tiny'),
                'regnety': (regnet_model, 'regnety_008'),
                'regnetx': (regnet_model, 'regnetx_008')}
    module, arch = arch_fwd[family]
    with torch.inference_mode():
        return module.forward(params, torch.from_numpy(x), arch=arch,
                              features=True).numpy()


@pytest.mark.parametrize('family,size', [('vit', 224), ('convnext', 96),
                                         ('regnety', 128), ('regnetx', 96)])
def test_converted_weights_match_transformers(family, size):
    model, arch = _build(family)
    params = params_from_torch(_convert(hf, family, model.state_dict(), arch))
    x = np.random.RandomState(1).rand(2, size, size, 3).astype(np.float32)
    x = x * 2 - 1
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = (out.last_hidden_state[:, 0] if family == 'vit'
           else out.pooler_output.reshape(2, -1)).numpy()
    got = _port_features(family, params, x)
    assert got.shape == ref.shape
    assert rel_l2(got, ref) <= REL_L2


def test_converter_main_writes_a_checkpoint_path(tmp_path):
    """A task-prefixed (``vit.``) HF checkpoint → ``python -m
    video_features_torch.transplant.hf`` → a ``.pt`` the timm extractor
    loads through ``checkpoint_path``, holding the converted weights and
    giving transformers' features."""
    from video_features_torch.extract.timm import ExtractTIMM
    model, arch = _build('vit')
    src, dst = tmp_path / 'pytorch_model.bin', tmp_path / 'vit_tiny.pt'
    torch.save({f'vit.{k}': v for k, v in model.state_dict().items()}, src)
    proc = subprocess.run(
        [sys.executable, '-m', 'video_features_torch.transplant.hf',
         str(src), str(dst), '--hf-family', 'vit', '--arch', arch],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ex = ExtractTIMM({'feature_type': 'timm', 'model_name': arch,
                      'device': 'cpu', 'checkpoint_path': str(dst),
                      'output_path': str(tmp_path / 'out')})
    want = params_from_torch(hf.hf_to_timm('vit', model.state_dict(), arch))
    flat_got = dict(_leaves(ex.params))
    flat_want = dict(_leaves(want))
    assert flat_got.keys() >= flat_want.keys()
    for k, v in flat_want.items():
        assert torch.equal(flat_got[k], v), k
    x = np.random.RandomState(2).rand(1, 224, 224, 3).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x).permute(0, 3, 1, 2)
                    ).last_hidden_state[:, 0].numpy()
    assert rel_l2(_port_features('vit', ex.params, x), ref) <= REL_L2


def _leaves(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v
