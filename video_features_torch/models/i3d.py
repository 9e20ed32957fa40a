"""I3D (Inception-v1 inflated 3-D ConvNet, two-stream rgb/flow), port of
``video_features_tpu/models/i3d.py``.

Params are nested dicts of torch tensors keyed like the torch
state_dict (``conv3d_1a_7x7.conv3d.weight`` …), weights in torch's
(O, I, kt, kh, kw) layout. Layout NDHWC: rgb input (B, T, 224, 224, 3)
in [-1, 1], flow (B, T, 224, 224, 2).

  * TF-SAME padding approximated as pad = max(kernel - stride, 0), split
    low = pad // 2, high = the rest, per edge;
  * max pools zero-pad with the same rule, then pool in ceil mode (a
    high-side ``-inf`` pad);
  * 9 inception Mixed blocks, a (2, 7, 7) stride-1 average pool, and a
    ``features=True`` head that means over time to 1024-d; the
    classifier is a 1×1×1 conv with bias.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from video_features_torch.ops.nn import (
    avg_pool, batch_norm, ceil_mode_padding, conv, max_pool, pad_spatial, relu,
)

Params = Dict[str, Any]

FEAT_DIM = 1024

# Mixed blocks: name -> (in, [b0, b1_mid, b1_out, b2_mid, b2_out, b3])
MIXED_CFGS = {
    'mixed_3b': (192, [64, 96, 128, 16, 32, 32]),
    'mixed_3c': (256, [128, 128, 192, 32, 96, 64]),
    'mixed_4b': (480, [192, 96, 208, 16, 48, 64]),
    'mixed_4c': (512, [160, 112, 224, 24, 64, 64]),
    'mixed_4d': (512, [128, 128, 256, 24, 64, 64]),
    'mixed_4e': (512, [112, 144, 288, 32, 64, 64]),
    'mixed_4f': (528, [256, 160, 320, 32, 128, 128]),
    'mixed_5b': (832, [256, 160, 320, 32, 128, 128]),
    'mixed_5c': (832, [384, 192, 384, 48, 128, 128]),
}


def tf_same_pads(kernel: Tuple[int, ...], stride: Tuple[int, ...]):
    """pad = max(k - s, 0) split (lo = pad // 2, hi = rest) per dim."""
    pads = []
    for k, s in zip(kernel, stride):
        p = max(k - s, 0)
        pads.append((p // 2, p - p // 2))
    return pads


def unit3d(p: Params, x: torch.Tensor, kernel: Tuple[int, int, int],
           stride: Tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
           activation: bool = True) -> torch.Tensor:
    """Unit3Dpy: SAME conv (+ bias) → BN → ReLU."""
    x = conv(x, p['conv3d']['weight'], stride=stride,
             padding=tf_same_pads(kernel, stride),
             bias=p['conv3d'].get('bias'))
    if use_bn:
        x = batch_norm(x, p['batch3d'])
    if activation:
        x = relu(x)
    return x


def max_pool_tf(x: torch.Tensor, kernel: Tuple[int, int, int],
                stride: Tuple[int, int, int]) -> torch.Tensor:
    """MaxPool3dTFPadding: explicit ZERO pad (k - s rule), then a
    ceil-mode pool (windows clipped at the edge == ``-inf`` high-side
    padding)."""
    x = pad_spatial(x, tf_same_pads(kernel, stride))
    extra = [ceil_mode_padding(x.shape[i + 1], k, s)
             for i, (k, s) in enumerate(zip(kernel, stride))]
    return max_pool(x, kernel, stride=stride, padding=extra)


def mixed(p: Params, x: torch.Tensor) -> torch.Tensor:
    b0 = unit3d(p['branch_0'], x, (1, 1, 1))
    b1 = unit3d(p['branch_1']['1'],
                unit3d(p['branch_1']['0'], x, (1, 1, 1)), (3, 3, 3))
    b2 = unit3d(p['branch_2']['1'],
                unit3d(p['branch_2']['0'], x, (1, 1, 1)), (3, 3, 3))
    b3 = unit3d(p['branch_3']['1'],
                max_pool_tf(x, (3, 3, 3), (1, 1, 1)), (1, 1, 1))
    return torch.cat([b0, b1, b2, b3], dim=-1)


def forward(params: Params, x: torch.Tensor, features: bool = True):
    """(B, T, 224, 224, C) → (B, 1024) features, or (softmax, logits)."""
    x = unit3d(params['conv3d_1a_7x7'], x, (7, 7, 7), (2, 2, 2))
    x = max_pool_tf(x, (1, 3, 3), (1, 2, 2))
    x = unit3d(params['conv3d_2b_1x1'], x, (1, 1, 1))
    x = unit3d(params['conv3d_2c_3x3'], x, (3, 3, 3))
    x = max_pool_tf(x, (1, 3, 3), (1, 2, 2))
    x = mixed(params['mixed_3b'], x)
    x = mixed(params['mixed_3c'], x)
    x = max_pool_tf(x, (3, 3, 3), (2, 2, 2))
    for name in ('mixed_4b', 'mixed_4c', 'mixed_4d', 'mixed_4e', 'mixed_4f'):
        x = mixed(params[name], x)
    x = max_pool_tf(x, (2, 2, 2), (2, 2, 2))
    x = mixed(params['mixed_5b'], x)
    x = mixed(params['mixed_5c'], x)
    x = avg_pool(x, (2, x.shape[2], x.shape[3]), stride=1)   # (B, T', 1, 1, 1024)
    if features:
        return x.reshape(x.shape[0], x.shape[1], -1).mean(dim=1)
    logits = conv(x, params['conv3d_0c_1x1']['conv3d']['weight'],
                  bias=params['conv3d_0c_1x1']['conv3d']['bias'])
    logits = logits.reshape(logits.shape[0], logits.shape[1], -1).mean(dim=1)
    return torch.softmax(logits, dim=-1), logits


def init_state_dict(seed: int = 0, modality: str = 'rgb',
                    num_classes: int = 400) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with the reference I3D naming and
    shapes (the same numbers as the JAX package's ``init_state_dict``)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    in_channels = 3 if modality == 'rgb' else 2

    def unit(name, i, o, k, bias=False, bn=True):
        kt, kh, kw = (k, k, k) if isinstance(k, int) else k
        sd[f'{name}.conv3d.weight'] = rng.randn(o, i, kt, kh, kw).astype(np.float32) * 0.05
        if bias:
            sd[f'{name}.conv3d.bias'] = rng.randn(o).astype(np.float32) * 0.05
        if bn:
            sd[f'{name}.batch3d.weight'] = rng.rand(o).astype(np.float32) + 0.5
            sd[f'{name}.batch3d.bias'] = rng.randn(o).astype(np.float32) * 0.1
            sd[f'{name}.batch3d.running_mean'] = rng.randn(o).astype(np.float32) * 0.1
            sd[f'{name}.batch3d.running_var'] = rng.rand(o).astype(np.float32) + 0.5

    unit('conv3d_1a_7x7', in_channels, 64, 7)
    unit('conv3d_2b_1x1', 64, 64, 1)
    unit('conv3d_2c_3x3', 64, 192, 3)
    for name, (cin, (b0, b1m, b1o, b2m, b2o, b3)) in MIXED_CFGS.items():
        unit(f'{name}.branch_0', cin, b0, 1)
        unit(f'{name}.branch_1.0', cin, b1m, 1)
        unit(f'{name}.branch_1.1', b1m, b1o, 3)
        unit(f'{name}.branch_2.0', cin, b2m, 1)
        unit(f'{name}.branch_2.1', b2m, b2o, 3)
        unit(f'{name}.branch_3.1', cin, b3, 1)
    unit('conv3d_0c_1x1', 1024, num_classes, 1, bias=True, bn=False)
    return sd
