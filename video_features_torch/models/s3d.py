"""S3D (separable 3-D inception net, kylemin/S3D layout), port of
``video_features_tpu/models/s3d.py``.

Params are nested dicts of torch tensors keyed like the torch
state_dict (``base.<idx>.<sub>``), weights in torch's (O, I, kt, kh, kw)
layout. Layout NDHWC: input (B, T, 224, 224, 3) in [0, 1].

  * SepConv3d = spatial (1, k, k) conv → BN → ReLU, then temporal
    (k, 1, 1) conv → BN → ReLU; BasicConv3d = 1×1×1 conv → BN → ReLU;
    every BN with eps 1e-3;
  * inception blocks Mixed_3b … Mixed_5c, whose branch 3 max-pools
    3×3×3 at stride 1 with a ``-inf`` pad of 1;
  * head: average pool over (2, H, W) at stride 1, the 1×1×1 ``fc``
    conv (logits only), then the mean over the T - 1 positions;
  * ``three_pass_convs`` sends every convolution (the separable ones'
    spatial and temporal halves, the 1×1×1 ones, and the bias-carrying
    ``fc`` with ``features=False``: 77 for features) to the 3xTF32
    convolution (``ops/conv_tf32x3.py``), under ``precision=high`` and
    ``mixed``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from video_features_torch.ops.nn import (
    avg_pool, batch_norm, conv, max_pool, relu, three_pass_route,
)

Params = Dict[str, Any]

BN_EPS = 1e-3
FEAT_DIM = 1024

# Mixed block channel table: in, b0, (b1_mid, b1_out), (b2_mid, b2_out), b3
MIXED_CFGS = {
    ' 3b': (192, 64, (96, 128), (16, 32), 32),
    ' 3c': (256, 128, (128, 192), (32, 96), 64),
    ' 4b': (480, 192, (96, 208), (16, 48), 64),
    ' 4c': (512, 160, (112, 224), (24, 64), 64),
    ' 4d': (512, 128, (128, 256), (24, 64), 64),
    ' 4e': (512, 112, (144, 288), (32, 64), 64),
    ' 4f': (528, 256, (160, 320), (32, 128), 128),
    ' 5b': (832, 256, (160, 320), (32, 128), 128),
    ' 5c': (832, 384, (192, 384), (48, 128), 128),
}
# base Sequential: index -> ('sep'|'basic'|'maxpool'|'mixed', spec)
BASE_LAYOUT = [
    ('sep', dict(i=3, o=64, k=7, s=2, p=3)),
    ('maxpool', dict(k=(1, 3, 3), s=(1, 2, 2), p=(0, 1, 1))),
    ('basic', dict(i=64, o=64)),
    ('sep', dict(i=64, o=192, k=3, s=1, p=1)),
    ('maxpool', dict(k=(1, 3, 3), s=(1, 2, 2), p=(0, 1, 1))),
    ('mixed', ' 3b'),
    ('mixed', ' 3c'),
    ('maxpool', dict(k=(3, 3, 3), s=(2, 2, 2), p=(1, 1, 1))),
    ('mixed', ' 4b'),
    ('mixed', ' 4c'),
    ('mixed', ' 4d'),
    ('mixed', ' 4e'),
    ('mixed', ' 4f'),
    ('maxpool', dict(k=(2, 2, 2), s=(2, 2, 2), p=(0, 0, 0))),
    ('mixed', ' 5b'),
    ('mixed', ' 5c'),
]


def _basic(p: Params, x: torch.Tensor) -> torch.Tensor:
    return relu(batch_norm(conv(x, p['conv']['weight']), p['bn'], eps=BN_EPS))


def _sep(p: Params, x: torch.Tensor, k: int, s: int, pad: int) -> torch.Tensor:
    x = conv(x, p['conv_s']['weight'], stride=(1, s, s), padding=(0, pad, pad))
    x = relu(batch_norm(x, p['bn_s'], eps=BN_EPS))
    x = conv(x, p['conv_t']['weight'], stride=(s, 1, 1), padding=(pad, 0, 0))
    return relu(batch_norm(x, p['bn_t'], eps=BN_EPS))


def _mixed(p: Params, x: torch.Tensor) -> torch.Tensor:
    b0 = _basic(p['branch0']['0'], x)
    b1 = _sep(p['branch1']['1'], _basic(p['branch1']['0'], x), 3, 1, 1)
    b2 = _sep(p['branch2']['1'], _basic(p['branch2']['0'], x), 3, 1, 1)
    b3 = _basic(p['branch3']['1'], max_pool(x, 3, stride=1, padding=1))
    return torch.cat([b0, b1, b2, b3], dim=-1)


def forward(params: Params, x: torch.Tensor, features: bool = True,
            three_pass_convs: bool = False) -> torch.Tensor:
    """(B, T, H, W, 3) float in [0, 1] → (B, 1024) features or (B, 400)
    logits."""
    with three_pass_route(three_pass_convs):
        return _forward(params, x, features)


def _forward(params: Params, x: torch.Tensor, features: bool) -> torch.Tensor:
    base = params['base']
    for idx, (kind, spec) in enumerate(BASE_LAYOUT):
        p = base.get(str(idx))
        if kind == 'sep':
            x = _sep(p, x, spec['k'], spec['s'], spec['p'])
        elif kind == 'basic':
            x = _basic(p, x)
        elif kind == 'mixed':
            x = _mixed(p, x)
        else:
            x = max_pool(x, spec['k'], stride=spec['s'], padding=spec['p'])
    b, t, h, w, _ = x.shape
    if t < 2:
        # the temporal stride through the net is 8
        raise ValueError(
            f'S3D head needs >= 2 temporal positions after downsampling '
            f'(got {t}); use stack_size >= 16')
    x = avg_pool(x, (2, h, w), stride=1)          # (B, T-1, 1, 1, C)
    if not features:
        x = conv(x, params['fc']['0']['weight'], bias=params['fc']['0']['bias'])
    return x.reshape(b, t - 1, -1).mean(dim=1)


def init_state_dict(seed: int = 0, num_classes: int = 400) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with the kylemin/S3D naming and
    shapes (the same numbers as the JAX package's ``init_state_dict``)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def bn(name, c):
        sd[f'{name}.weight'] = rng.rand(c).astype(np.float32) + 0.5
        sd[f'{name}.bias'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_mean'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_var'] = rng.rand(c).astype(np.float32) + 0.5

    def basic(name, i, o):
        sd[f'{name}.conv.weight'] = rng.randn(o, i, 1, 1, 1).astype(np.float32) * 0.05
        bn(f'{name}.bn', o)

    def sep(name, i, o, k):
        sd[f'{name}.conv_s.weight'] = rng.randn(o, i, 1, k, k).astype(np.float32) * 0.05
        bn(f'{name}.bn_s', o)
        sd[f'{name}.conv_t.weight'] = rng.randn(o, o, k, 1, 1).astype(np.float32) * 0.05
        bn(f'{name}.bn_t', o)

    for idx, (kind, spec) in enumerate(BASE_LAYOUT):
        name = f'base.{idx}'
        if kind == 'sep':
            sep(name, spec['i'], spec['o'], spec['k'])
        elif kind == 'basic':
            basic(name, spec['i'], spec['o'])
        elif kind == 'mixed':
            cin, b0, (b1m, b1o), (b2m, b2o), b3 = MIXED_CFGS[spec]
            basic(f'{name}.branch0.0', cin, b0)
            basic(f'{name}.branch1.0', cin, b1m)
            sep(f'{name}.branch1.1', b1m, b1o, 3)
            basic(f'{name}.branch2.0', cin, b2m)
            sep(f'{name}.branch2.1', b2m, b2o, 3)
            basic(f'{name}.branch3.1', cin, b3)
    sd['fc.0.weight'] = rng.randn(num_classes, FEAT_DIM, 1, 1, 1).astype(np.float32) * 0.05
    sd['fc.0.bias'] = rng.randn(num_classes).astype(np.float32) * 0.05
    return sd
