"""MLP-Mixer image backbones (timm ``mixer_*`` state_dict layout), port
of ``video_features_tpu/models/mixer.py``.

Params follow timm 0.9.12's ``MlpMixer`` (``stem.proj``,
``blocks.N.{norm1,mlp_tokens,norm2,mlp_channels}``, ``norm``). Each
block mixes tokens with an MLP across the patch axis (its weights are
sized by the 196-token grid, so the input is fixed at 224 px), then
channels with an ordinary MLP, both residual; features are the mean
over tokens after the final norm.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from video_features_torch.models.vit import layer_norm, mlp
from video_features_torch.ops import nn
from video_features_torch.ops.nn import conv

Params = Dict[str, Any]

# timm mixer _cfg: bicubic, crop_pct 0.875, "inception" 0.5 stats
MEAN = (0.5, 0.5, 0.5)
STD = (0.5, 0.5, 0.5)

ARCHS = {
    'mixer_b16_224': dict(width=768, layers=12, patch=16),
    'mixer_l16_224': dict(width=1024, layers=24, patch=16),
}
INPUT_RESOLUTION = 224


def feat_dim(arch: str) -> int:
    return ARCHS[arch]['width']


def _block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = mlp(p['mlp_tokens'], layer_norm(x, p['norm1']).transpose(1, 2))
    x = x + h.transpose(1, 2)
    return x + mlp(p['mlp_channels'], layer_norm(x, p['norm2']))


def forward(params: Params, x: torch.Tensor, arch: str = 'mixer_b16_224',
            features: bool = True) -> torch.Tensor:
    """(B, 224, 224, 3) normalized frames → (B, width) features;
    ``features=False`` applies a loaded ``head``."""
    cfg = ARCHS[arch]
    if tuple(x.shape[1:3]) != (INPUT_RESOLUTION, INPUT_RESOLUTION):
        raise ValueError(f'mixer runs at {INPUT_RESOLUTION} px (its token-MLP '
                         f'geometry); got {tuple(x.shape)}')
    k = params['stem']['proj']
    x = conv(x, k['weight'], stride=cfg['patch'], bias=k['bias'])
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    for i in range(cfg['layers']):
        x = _block(params['blocks'][str(i)], x)
    feats = layer_norm(x, params['norm']).mean(dim=1)
    if features:
        return feats
    return nn.linear(feats, params['head'])


def init_state_dict(arch: str = 'mixer_b16_224', seed: int = 0,
                    num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's)."""
    cfg = ARCHS[arch]
    width, layers = cfg['width'], cfg['layers']
    tokens = (INPUT_RESOLUTION // cfg['patch']) ** 2
    # timm mixer dims: tokens MLP = width/2, channels MLP = width*4
    tok_dim, ch_dim = width // 2, width * 4
    rng = np.random.RandomState(seed)

    def f32(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd: Dict[str, np.ndarray] = {
        'stem.proj.weight': f32(width, 3, cfg['patch'], cfg['patch']),
        'stem.proj.bias': f32(width),
        'norm.weight': np.ones(width, np.float32),
        'norm.bias': np.zeros(width, np.float32),
    }
    for i in range(layers):
        b = f'blocks.{i}.'
        for n in ('norm1', 'norm2'):
            sd[b + n + '.weight'] = np.ones(width, np.float32)
            sd[b + n + '.bias'] = np.zeros(width, np.float32)
        sd[b + 'mlp_tokens.fc1.weight'] = f32(tok_dim, tokens)
        sd[b + 'mlp_tokens.fc1.bias'] = np.zeros(tok_dim, np.float32)
        sd[b + 'mlp_tokens.fc2.weight'] = f32(tokens, tok_dim)
        sd[b + 'mlp_tokens.fc2.bias'] = np.zeros(tokens, np.float32)
        sd[b + 'mlp_channels.fc1.weight'] = f32(ch_dim, width)
        sd[b + 'mlp_channels.fc1.bias'] = np.zeros(ch_dim, np.float32)
        sd[b + 'mlp_channels.fc2.weight'] = f32(width, ch_dim)
        sd[b + 'mlp_channels.fc2.bias'] = np.zeros(width, np.float32)
    if num_classes:
        sd['head.weight'] = f32(num_classes, width)
        sd['head.bias'] = np.zeros(num_classes, np.float32)
    return sd
