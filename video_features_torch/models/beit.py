"""BEiT image backbones (timm ``beit_*`` state_dict layout), port of
``video_features_tpu/models/beit.py``.

Params follow timm 0.9.12's ``Beit``: no absolute position embedding; a
relative-position bias table per block with 3 extra rows for the cls
token, gathered through the checkpoint's integer
``relative_position_index`` (kept ``torch.long``); a packed qkv weight
with q and v biases only; layer-scale residuals (``gamma_1``,
``gamma_2``); features are the mean of the patch tokens through
``fc_norm``. The bias tables fix the input at 224 px.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from video_features_torch.models.vit import layer_norm, mlp
from video_features_torch.ops import nn
from video_features_torch.ops.nn import conv

Params = Dict[str, Any]

# timm beit _cfg: bicubic, crop_pct 0.9, "inception" 0.5 stats
MEAN = (0.5, 0.5, 0.5)
STD = (0.5, 0.5, 0.5)

ARCHS = {
    'beit_base_patch16_224': dict(width=768, layers=12, heads=12, patch=16),
    'beit_large_patch16_224': dict(width=1024, layers=24, heads=16,
                                   patch=16),
}
INPUT_RESOLUTION = 224


def num_relative_distance(window: Tuple[int, int]) -> int:
    return (2 * window[0] - 1) * (2 * window[1] - 1) + 3


def gen_relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """timm ``gen_relative_position_index``: the (N+1, N+1) int64 index
    into the bias table; the last 3 rows serve cls↔token and cls↔cls."""
    wh, ww = window
    n = wh * ww
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))          # (2, wh, ww)
    flat = coords.reshape(2, -1)                           # (2, n)
    rel = flat[:, :, None] - flat[:, None, :]              # (2, n, n)
    rel = rel.transpose(1, 2, 0).astype(np.int64)          # (n, n, 2)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    nrd = num_relative_distance(window)
    index = np.zeros((n + 1, n + 1), dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = nrd - 3
    index[0:, 0] = nrd - 2
    index[0, 0] = nrd - 1
    return index


def _rel_pos_bias(p: Params, heads: int) -> torch.Tensor:
    """(heads, N+1, N+1) additive attention bias from the block's table."""
    index = p['relative_position_index']
    n = index.shape[0]
    bias = p['relative_position_bias_table'][index.reshape(-1)]
    return bias.reshape(n, n, heads).permute(2, 0, 1)


def _attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed qkv with q/v-only biases, per-head scaled dot product plus
    the block's relative-position bias."""
    B, N, D = x.shape
    hd = D // num_heads
    bias = torch.cat([p['q_bias'], torch.zeros_like(p['q_bias']), p['v_bias']])
    qkv = nn.linear(x, {'weight': p['qkv']['weight'], 'bias': bias}
                    ).reshape(B, N, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)         # (B, H, N, hd)
    scores = nn.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    scores = scores + _rel_pos_bias(p, num_heads)[None]
    out = nn.matmul(nn.softmax(scores, dim=-1), v).transpose(1, 2).reshape(
        B, N, D)
    return nn.linear(out, p['proj'])


def _block(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    x = x + p['gamma_1'] * _attention(p['attn'], layer_norm(x, p['norm1']),
                                      num_heads)
    return x + p['gamma_2'] * mlp(p['mlp'], layer_norm(x, p['norm2']))


def forward(params: Params, x: torch.Tensor,
            arch: str = 'beit_base_patch16_224',
            features: bool = True) -> torch.Tensor:
    """(B, 224, 224, 3) normalized frames → (B, width) features: the mean
    of the patch tokens (cls excluded) through ``fc_norm``;
    ``features=False`` applies a loaded ``head``."""
    cfg = ARCHS[arch]
    if tuple(x.shape[1:3]) != (INPUT_RESOLUTION, INPUT_RESOLUTION):
        raise ValueError(f'beit runs at {INPUT_RESOLUTION} px (its relative-'
                         f'position bias geometry); got {tuple(x.shape)}')
    k = params['patch_embed']['proj']
    x = conv(x, k['weight'], stride=cfg['patch'], bias=k['bias'])
    B, width = x.shape[0], x.shape[-1]
    x = torch.cat([params['cls_token'].expand(B, 1, width),
                   x.reshape(B, -1, width)], dim=1)
    for i in range(cfg['layers']):
        x = _block(params['blocks'][str(i)], x, cfg['heads'])
    feats = layer_norm(x[:, 1:].mean(dim=1), params['fc_norm'])
    if features:
        return feats
    return nn.linear(feats, params['head'])


def feat_dim(arch: str) -> int:
    return ARCHS[arch]['width']


def init_state_dict(arch: str = 'beit_base_patch16_224', seed: int = 0,
                    num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's), with the integer
    ``relative_position_index`` buffers timm saves."""
    cfg = ARCHS[arch]
    width, layers = cfg['width'], cfg['layers']
    side = INPUT_RESOLUTION // cfg['patch']
    window = (side, side)
    nrd = num_relative_distance(window)
    index = gen_relative_position_index(window)
    rng = np.random.RandomState(seed)

    def f32(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd: Dict[str, np.ndarray] = {
        'cls_token': f32(1, 1, width),
        'patch_embed.proj.weight': f32(width, 3, cfg['patch'], cfg['patch']),
        'patch_embed.proj.bias': f32(width),
        'fc_norm.weight': np.ones(width, np.float32),
        'fc_norm.bias': np.zeros(width, np.float32),
    }
    for i in range(layers):
        b = f'blocks.{i}.'
        sd[b + 'norm1.weight'] = np.ones(width, np.float32)
        sd[b + 'norm1.bias'] = np.zeros(width, np.float32)
        sd[b + 'gamma_1'] = np.full(width, 0.1, np.float32)
        sd[b + 'gamma_2'] = np.full(width, 0.1, np.float32)
        sd[b + 'attn.qkv.weight'] = f32(3 * width, width)
        sd[b + 'attn.q_bias'] = f32(width)
        sd[b + 'attn.v_bias'] = f32(width)
        sd[b + 'attn.relative_position_bias_table'] = f32(nrd, cfg['heads'])
        sd[b + 'attn.relative_position_index'] = index
        sd[b + 'attn.proj.weight'] = f32(width, width)
        sd[b + 'attn.proj.bias'] = np.zeros(width, np.float32)
        sd[b + 'norm2.weight'] = np.ones(width, np.float32)
        sd[b + 'norm2.bias'] = np.zeros(width, np.float32)
        sd[b + 'mlp.fc1.weight'] = f32(4 * width, width)
        sd[b + 'mlp.fc1.bias'] = np.zeros(4 * width, np.float32)
        sd[b + 'mlp.fc2.weight'] = f32(width, 4 * width)
        sd[b + 'mlp.fc2.bias'] = np.zeros(width, np.float32)
    if num_classes:
        sd['head.weight'] = f32(num_classes, width)
        sd['head.bias'] = np.zeros(num_classes, np.float32)
    return sd
