"""ResNet-family image backbones (torchvision resnet, ResNeXt and wide
ResNet), port of ``video_features_tpu/models/resnet.py``.

Params are nested dicts of torch tensors keyed like the torchvision
state_dict (``layer1.0.conv1.weight`` …), weights in torch's (O, I, kh,
kw) layout. Layout NHWC: input (B, H, W, 3), normalized.

  * stem: 7×7 stride-2 conv → BN → ReLU → 3×3 stride-2 max pool;
  * basic blocks (resnet18/34) or bottlenecks (the rest), whose 1×1 and
    3×3 convs run at ``width = planes·base_width/64·groups`` and whose
    3×3 is grouped for ResNeXt; the first block of layers 2-4 strides 2
    on its 3×3 (torchvision's V1.5), its shortcut a strided 1×1 conv →
    BN;
  * global average pool → features, or ``fc`` logits.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from video_features_torch.ops.nn import (
    adaptive_avg_pool, batch_norm, conv, linear, max_pool, relu,
)

Params = Dict[str, Any]

# torchvision's IMAGENET1K_V1 normalization
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

ARCHS = {
    'resnet18': dict(block='basic', layers=[2, 2, 2, 2], feat_dim=512),
    'resnet34': dict(block='basic', layers=[3, 4, 6, 3], feat_dim=512),
    'resnet50': dict(block='bottleneck', layers=[3, 4, 6, 3], feat_dim=2048),
    'resnet101': dict(block='bottleneck', layers=[3, 4, 23, 3], feat_dim=2048),
    'resnet152': dict(block='bottleneck', layers=[3, 8, 36, 3], feat_dim=2048),
    'resnext50_32x4d': dict(block='bottleneck', layers=[3, 4, 6, 3],
                            feat_dim=2048, groups=32, base_width=4),
    'resnext101_32x8d': dict(block='bottleneck', layers=[3, 4, 23, 3],
                             feat_dim=2048, groups=32, base_width=8),
    'resnext101_64x4d': dict(block='bottleneck', layers=[3, 4, 23, 3],
                             feat_dim=2048, groups=64, base_width=4),
    'wide_resnet50_2': dict(block='bottleneck', layers=[3, 4, 6, 3],
                            feat_dim=2048, base_width=128),
    'wide_resnet101_2': dict(block='bottleneck', layers=[3, 4, 23, 3],
                             feat_dim=2048, base_width=128),
}


def arch_def(name: str) -> dict:
    """``ARCHS[name]``; an unknown name raises, listing the valid ones."""
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f'model_name must be one of {", ".join(ARCHS)}; '
                         f'got {name!r}') from None


def _shortcut(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    if 'downsample' not in p:
        return x
    return batch_norm(conv(x, p['downsample']['0']['weight'], stride=stride),
                      p['downsample']['1'])


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = relu(batch_norm(conv(x, p['conv1']['weight'], stride=stride,
                               padding=1), p['bn1']))
    out = batch_norm(conv(out, p['conv2']['weight'], padding=1), p['bn2'])
    return relu(out + _shortcut(p, x, stride))


def _bottleneck(p: Params, x: torch.Tensor, stride: int,
                groups: int = 1) -> torch.Tensor:
    out = relu(batch_norm(conv(x, p['conv1']['weight']), p['bn1']))
    out = relu(batch_norm(conv(out, p['conv2']['weight'], stride=stride,
                               padding=1, groups=groups), p['bn2']))
    out = batch_norm(conv(out, p['conv3']['weight']), p['bn3'])
    return relu(out + _shortcut(p, x, stride))


def forward(params: Params, x: torch.Tensor, arch: str = 'resnet50',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized image → (B, feat_dim) features, or (B,
    num_classes) logits."""
    cfg = arch_def(arch)
    if cfg['block'] == 'basic':
        block_fn = _basic_block
    else:
        block_fn = partial(_bottleneck, groups=cfg.get('groups', 1))
    x = relu(batch_norm(conv(x, params['conv1']['weight'], stride=2,
                             padding=3), params['bn1']))
    x = max_pool(x, 3, stride=2, padding=1)
    for li, num_blocks in enumerate(cfg['layers'], start=1):
        layer = params[f'layer{li}']
        for bi in range(num_blocks):
            x = block_fn(layer[str(bi)], x, 2 if (li > 1 and bi == 0) else 1)
    x = adaptive_avg_pool(x)
    return x if features else linear(x, params['fc'])


def init_state_dict(seed: int = 0, arch: str = 'resnet50',
                    num_classes: int = 1000) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with the torchvision naming and
    shapes (the same numbers as the JAX package's ``init_state_dict``)."""
    rng = np.random.RandomState(seed)
    cfg = arch_def(arch)
    sd: Dict[str, np.ndarray] = {}

    def conv_w(name: str, o: int, i: int, k: int):
        sd[name] = rng.randn(o, i, k, k).astype(np.float32) * 0.03

    def bn(name: str, c: int):
        sd[f'{name}.weight'] = rng.rand(c).astype(np.float32) + 0.5
        sd[f'{name}.bias'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_mean'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_var'] = rng.rand(c).astype(np.float32) + 0.5

    conv_w('conv1.weight', 64, 3, 7)
    bn('bn1', 64)
    in_p = 64
    expansion = 1 if cfg['block'] == 'basic' else 4
    groups, base_width = cfg.get('groups', 1), cfg.get('base_width', 64)
    for li, (nb, planes) in enumerate(zip(cfg['layers'], [64, 128, 256, 512]), 1):
        out_p = planes * expansion
        width = int(planes * base_width / 64) * groups
        for bi in range(nb):
            base = f'layer{li}.{bi}'
            stride = 2 if (li > 1 and bi == 0) else 1
            if cfg['block'] == 'basic':
                conv_w(f'{base}.conv1.weight', planes, in_p, 3)
                bn(f'{base}.bn1', planes)
                conv_w(f'{base}.conv2.weight', planes, planes, 3)
                bn(f'{base}.bn2', planes)
            else:
                conv_w(f'{base}.conv1.weight', width, in_p, 1)
                bn(f'{base}.bn1', width)
                conv_w(f'{base}.conv2.weight', width, width // groups, 3)
                bn(f'{base}.bn2', width)
                conv_w(f'{base}.conv3.weight', out_p, width, 1)
                bn(f'{base}.bn3', out_p)
            if stride != 1 or in_p != out_p:
                conv_w(f'{base}.downsample.0.weight', out_p, in_p, 1)
                bn(f'{base}.downsample.1', out_p)
            in_p = out_p
    sd['fc.weight'] = rng.randn(num_classes, cfg['feat_dim']).astype(np.float32) * 0.03
    sd['fc.bias'] = rng.randn(num_classes).astype(np.float32) * 0.03
    return sd
