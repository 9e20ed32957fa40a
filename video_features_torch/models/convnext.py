"""ConvNeXt image backbones (timm ``convnext_*`` state_dict layout), port
of ``video_features_tpu/models/convnext.py``.

Params follow timm's ``ConvNeXt`` naming (``stem.{0,1}``,
``stages.S.blocks.B.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``,
``stages.S.downsample.{0,1}``, ``head.{norm,fc}``). Layout NHWC, so the
LayerNorms (eps 1e-6) normalize the trailing channel axis directly.
Each block: depthwise 7×7 → LN → fc1 → exact-erf GELU → fc2 → the
optional layer scale ``gamma``, residual.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.ops import nn
from video_features_torch.ops.nn import conv, linear

Params = Dict[str, Any]

# timm default_cfg: 224 px at crop_pct 0.875, bicubic, ImageNet stats
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

ARCHS = {
    'convnext_tiny': dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    'convnext_small': dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    'convnext_base': dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    'convnext_large': dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    return nn.layer_norm(x, p, eps)


def _block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv(x, p['conv_dw']['weight'], padding=3, groups=x.shape[-1],
             bias=p['conv_dw']['bias'])
    h = layer_norm(h, p['norm'])
    h = linear(F.gelu(linear(h, p['mlp']['fc1'])), p['mlp']['fc2'])
    if 'gamma' in p:
        h = h * p['gamma']
    return x + h


def forward(params: Params, x: torch.Tensor, arch: str = 'convnext_tiny',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, dims[-1]) features: global
    average pool → ``head.norm``; ``features=False`` adds ``head.fc``."""
    cfg = ARCHS[arch]
    x = conv(x, params['stem']['0']['weight'], stride=4,
             bias=params['stem']['0']['bias'])
    x = layer_norm(x, params['stem']['1'])
    for s, depth in enumerate(cfg['depths']):
        stage = params['stages'][str(s)]
        if 'downsample' in stage:
            x = layer_norm(x, stage['downsample']['0'])
            x = conv(x, stage['downsample']['1']['weight'], stride=2,
                     bias=stage['downsample']['1']['bias'])
        for b in range(depth):
            x = _block(stage['blocks'][str(b)], x)
    x = layer_norm(x.mean(dim=(1, 2)), params['head']['norm'])
    return x if features else linear(x, params['head']['fc'])


def init_state_dict(seed: int = 0, arch: str = 'convnext_tiny',
                    num_classes: int = 1000) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict (timm's keys and shapes; the same
    numbers as the JAX package's)."""
    cfg = ARCHS[arch]
    rng = np.random.RandomState(seed)

    def f32(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln(name, c):
        sd[f'{name}.weight'] = np.ones(c, np.float32)
        sd[f'{name}.bias'] = np.zeros(c, np.float32)

    dims = cfg['dims']
    sd: Dict[str, np.ndarray] = {
        'stem.0.weight': f32(dims[0], 3, 4, 4),
        'stem.0.bias': np.zeros(dims[0], np.float32),
    }
    ln('stem.1', dims[0])
    for s, depth in enumerate(cfg['depths']):
        if s > 0:
            ln(f'stages.{s}.downsample.0', dims[s - 1])
            sd[f'stages.{s}.downsample.1.weight'] = f32(dims[s], dims[s - 1],
                                                        2, 2)
            sd[f'stages.{s}.downsample.1.bias'] = np.zeros(dims[s],
                                                           np.float32)
        for b in range(depth):
            base = f'stages.{s}.blocks.{b}'
            sd[f'{base}.conv_dw.weight'] = f32(dims[s], 1, 7, 7)
            sd[f'{base}.conv_dw.bias'] = np.zeros(dims[s], np.float32)
            ln(f'{base}.norm', dims[s])
            sd[f'{base}.mlp.fc1.weight'] = f32(4 * dims[s], dims[s])
            sd[f'{base}.mlp.fc1.bias'] = np.zeros(4 * dims[s], np.float32)
            sd[f'{base}.mlp.fc2.weight'] = f32(dims[s], 4 * dims[s])
            sd[f'{base}.mlp.fc2.bias'] = np.zeros(dims[s], np.float32)
            sd[f'{base}.gamma'] = np.full(dims[s], 1e-6, np.float32)
    ln('head.norm', dims[-1])
    sd['head.fc.weight'] = f32(num_classes, dims[-1])
    sd['head.fc.bias'] = np.zeros(num_classes, np.float32)
    return sd
