"""R(2+1)D video ResNet (torchvision ``r2plus1d_18`` / ig65m
``r2plus1d_34``), port of ``video_features_tpu/models/r21d.py``.

Params are nested dicts of torch tensors keyed like the torchvision
state_dict (``layer2.0.conv1.0.0.weight`` …), weights in torch's (O, I,
kt, kh, kw) layout. Layout NDHWC: input (B, T, 112, 112, 3), normalized.

  * stem: (1, 7, 7) spatial conv at stride (1, 2, 2) → BN → ReLU →
    (3, 1, 1) temporal conv → BN → ReLU;
  * each Conv2Plus1D is Sequential(spatial (1, 3, 3) conv, BN, ReLU,
    temporal (3, 1, 1) conv), torch indices 0, 1, 3, with the midplane
    count that matches a full 3-D conv's parameter budget;
  * the first block of layers 2-4 strides 2 in time and space, its
    shortcut a 1×1×1 conv at stride (2, 2, 2) → BN;
  * global average pool → 512-d features, or ``fc`` logits.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from video_features_torch.ops.nn import (
    adaptive_avg_pool, batch_norm, conv, linear, relu,
)

Params = Dict[str, Any]

ARCHS = {
    'r2plus1d_18': {'blocks': [2, 2, 2, 2], 'num_classes': 400},
    'r2plus1d_34': {'blocks': [3, 4, 6, 3], 'num_classes': 400},
}
FEAT_DIM = 512

# the reference transform chain's video normalization
MEAN = (0.43216, 0.394666, 0.37645)
STD = (0.22803, 0.22145, 0.216989)


def midplanes(in_planes: int, out_planes: int) -> int:
    return (in_planes * out_planes * 3 * 3 * 3) // (
        in_planes * 3 * 3 + 3 * out_planes)


def _conv2plus1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    x = conv(x, p['0']['weight'], stride=(1, stride, stride), padding=(0, 1, 1))
    x = relu(batch_norm(x, p['1']))
    return conv(x, p['3']['weight'], stride=(stride, 1, 1), padding=(1, 0, 0))


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = relu(batch_norm(_conv2plus1d(p['conv1']['0'], x, stride),
                          p['conv1']['1']))
    out = batch_norm(_conv2plus1d(p['conv2']['0'], out, 1), p['conv2']['1'])
    identity = x
    if 'downsample' in p:
        identity = batch_norm(conv(x, p['downsample']['0']['weight'],
                                   stride=stride), p['downsample']['1'])
    return relu(out + identity)


def _stem(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = conv(x, p['0']['weight'], stride=(1, 2, 2), padding=(0, 3, 3))
    x = relu(batch_norm(x, p['1']))
    x = conv(x, p['3']['weight'], padding=(1, 0, 0))
    return relu(batch_norm(x, p['4']))


def forward(params: Params, x: torch.Tensor, arch: str = 'r2plus1d_18',
            features: bool = True) -> torch.Tensor:
    """(B, T, H, W, 3) normalized video → (B, 512) features or (B, 400)
    logits."""
    x = _stem(params['stem'], x)
    for layer_idx, num_blocks in enumerate(ARCHS[arch]['blocks'], start=1):
        layer = params[f'layer{layer_idx}']
        for block_idx in range(num_blocks):
            stride = 2 if (layer_idx > 1 and block_idx == 0) else 1
            x = _basic_block(layer[str(block_idx)], x, stride)
    x = adaptive_avg_pool(x)
    return x if features else linear(x, params['fc'])


def init_state_dict(seed: int = 0, arch: str = 'r2plus1d_18'
                    ) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with the torchvision naming and
    shapes (the same numbers as the JAX package's ``init_state_dict``)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv_w(name: str, o: int, i: int, k: Tuple[int, int, int]):
        sd[name] = rng.randn(o, i, *k).astype(np.float32) * 0.05

    def bn(name: str, c: int):
        sd[f'{name}.weight'] = rng.rand(c).astype(np.float32) + 0.5
        sd[f'{name}.bias'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_mean'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_var'] = rng.rand(c).astype(np.float32) + 0.5

    conv_w('stem.0.weight', 45, 3, (1, 7, 7))
    bn('stem.1', 45)
    conv_w('stem.3.weight', 64, 45, (3, 1, 1))
    bn('stem.4', 64)
    in_p = 64
    for li, (nb, out_p) in enumerate(zip(ARCHS[arch]['blocks'],
                                         (64, 128, 256, 512)), start=1):
        for bi in range(nb):
            base = f'layer{li}.{bi}'
            stride = 2 if (li > 1 and bi == 0) else 1
            mid1 = midplanes(in_p, out_p)
            conv_w(f'{base}.conv1.0.0.weight', mid1, in_p, (1, 3, 3))
            bn(f'{base}.conv1.0.1', mid1)
            conv_w(f'{base}.conv1.0.3.weight', out_p, mid1, (3, 1, 1))
            bn(f'{base}.conv1.1', out_p)
            mid2 = midplanes(out_p, out_p)
            conv_w(f'{base}.conv2.0.0.weight', mid2, out_p, (1, 3, 3))
            bn(f'{base}.conv2.0.1', mid2)
            conv_w(f'{base}.conv2.0.3.weight', out_p, mid2, (3, 1, 1))
            bn(f'{base}.conv2.1', out_p)
            if stride != 1 or in_p != out_p:
                conv_w(f'{base}.downsample.0.weight', out_p, in_p, (1, 1, 1))
                bn(f'{base}.downsample.1', out_p)
            in_p = out_p
    nc = ARCHS[arch]['num_classes']
    sd['fc.weight'] = rng.randn(nc, FEAT_DIM).astype(np.float32) * 0.05
    sd['fc.bias'] = rng.randn(nc).astype(np.float32) * 0.05
    return sd
