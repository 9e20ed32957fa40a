"""RegNet image backbones (timm ``regnety_*``/``regnetx_*`` state_dict
layout), port of ``video_features_tpu/models/regnet.py``.

Params follow timm 0.9.12's ``RegNet`` (``stem.{conv,bn}``,
``s{1..4}.b{1..N}.{conv1,conv2,conv3}.{conv,bn}``, ``se.{fc1,fc2}``,
``downsample.{conv,bn}``, ``head.fc``). Layout NHWC. Each block: 1×1 →
grouped 3×3 (groups = width / group_width) → squeeze-excite when the
checkpoint carries one (RegNetY) → 1×1, plus the shortcut, then ReLU;
every stage strides 2 on its first block. Features are the global
average pool of the last stage.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from video_features_torch.ops.nn import batch_norm, conv, linear, relu

Params = Dict[str, Any]

# timm regnet _cfg: bicubic, crop_pct 0.875, ImageNet stats
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

STEM_WIDTH = 32
SE_RATIO = 0.25

# name: per-stage (depths, widths, group_width); the y variants carry
# squeeze-excite, the x variants do not
ARCHS: Dict[str, Tuple[List[int], List[int], int]] = {
    'regnety_004': ([1, 3, 6, 6], [48, 104, 208, 440], 8),
    'regnety_008': ([1, 3, 8, 2], [64, 128, 320, 768], 16),
    'regnety_016': ([2, 6, 17, 2], [48, 120, 336, 888], 24),
    'regnety_032': ([2, 5, 13, 1], [72, 216, 576, 1512], 24),
    'regnetx_008': ([1, 3, 7, 5], [64, 128, 288, 672], 16),
    'regnetx_016': ([2, 4, 10, 2], [72, 168, 408, 912], 24),
    'regnetx_032': ([2, 6, 15, 2], [96, 192, 432, 1008], 48),
}


def feat_dim(arch: str) -> int:
    return ARCHS[arch][1][-1]


def _conv_bn_act(p: Params, x: torch.Tensor, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 act: bool = True) -> torch.Tensor:
    x = batch_norm(conv(x, p['conv']['weight'], stride=stride,
                        padding=padding, groups=groups), p['bn'])
    return relu(x) if act else x


def _se(p: Params, x: torch.Tensor) -> torch.Tensor:
    """timm ``SEModule``: global mean → 1×1 reduce → ReLU → 1×1 expand →
    sigmoid gate (the reduce width comes from the checkpoint)."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = relu(conv(s, p['fc1']['weight'], bias=p['fc1']['bias']))
    s = conv(s, p['fc2']['weight'], bias=p['fc2']['bias'])
    return x * torch.sigmoid(s)


def _block(p: Params, x: torch.Tensor, stride: int, groups: int) -> torch.Tensor:
    h = _conv_bn_act(p['conv1'], x)
    h = _conv_bn_act(p['conv2'], h, stride=stride, padding=1, groups=groups)
    if 'se' in p:
        h = _se(p['se'], h)
    h = _conv_bn_act(p['conv3'], h, act=False)
    shortcut = x
    if 'downsample' in p:
        shortcut = _conv_bn_act(p['downsample'], x, stride=stride, act=False)
    return relu(h + shortcut)


def forward(params: Params, x: torch.Tensor, arch: str = 'regnety_008',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, feat_dim) pooled features (or
    (B, 1000) logits with ``features=False`` and a loaded head)."""
    depths, widths, group_w = ARCHS[arch]
    x = _conv_bn_act(params['stem'], x, stride=2, padding=1)
    for si, (d, w) in enumerate(zip(depths, widths), start=1):
        stage = params[f's{si}']
        for bi in range(1, d + 1):
            x = _block(stage[f'b{bi}'], x, stride=2 if bi == 1 else 1,
                       groups=w // group_w)
    x = x.mean(dim=(1, 2))
    return x if features else linear(x, params['head']['fc'])


def init_state_dict(arch: str = 'regnety_008', seed: int = 0,
                    num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's)."""
    from video_features_torch.models._seed import SeedWriter
    rng = np.random.RandomState(seed)
    depths, widths, group_w = ARCHS[arch]
    sd: Dict[str, np.ndarray] = {}
    w_ = SeedWriter(sd, rng, conv_scale=0.08)
    cw, bn = w_.conv, w_.bn

    cw('stem.conv', STEM_WIDTH, 3, 3)
    bn('stem.bn', STEM_WIDTH)
    cin = STEM_WIDTH
    for si, (d, w) in enumerate(zip(depths, widths), start=1):
        for bi in range(1, d + 1):
            base = f's{si}.b{bi}'
            groups = w // group_w
            se_ch = max(1, int(round(cin * SE_RATIO)))
            cw(f'{base}.conv1.conv', w, cin, 1)
            bn(f'{base}.conv1.bn', w)
            cw(f'{base}.conv2.conv', w, w // groups, 3)
            bn(f'{base}.conv2.bn', w)
            if arch.startswith('regnety'):
                cw(f'{base}.se.fc1', se_ch, w, 1, bias=True)
                cw(f'{base}.se.fc2', w, se_ch, 1, bias=True)
            cw(f'{base}.conv3.conv', w, w, 1)
            bn(f'{base}.conv3.bn', w)
            if bi == 1:   # the stride-2 first block always projects
                cw(f'{base}.downsample.conv', w, cin, 1)
                bn(f'{base}.downsample.bn', w)
            cin = w
    if num_classes:
        w_.linear('head.fc', num_classes, cin)
    return sd
