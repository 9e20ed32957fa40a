"""Swin Transformer image backbones (timm ``swin_*`` state_dict layout),
port of ``video_features_tpu/models/swin.py``.

Params follow timm 0.9.12's ``SwinTransformer`` (``patch_embed.proj``,
``layers.N.downsample.{norm,reduction}`` at the stage's start,
``layers.N.blocks.M.{norm1,attn,norm2,mlp}``, ``norm``, ``head.fc``).
Layout NHWC.

  * windows are reshape/transpose partitions; the cyclic shift is
    ``torch.roll`` (the sign convention of ``jnp.roll``);
  * the relative-position index and the shifted-window mask are built
    on the host from numpy, as in the JAX package, and cached on the
    device per geometry;
  * a feature map no larger than the window collapses to one unshifted
    window (``_calc_window_shift``), which ``image_size`` overrides
    reach; a map that is not a window multiple is zero-padded;
  * features are the global average pool of the final-norm map.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.models.vit import mlp
from video_features_torch.ops import nn
from video_features_torch.ops.nn import conv, linear

Params = Dict[str, Any]

# timm swin default_cfg: 224 px, bicubic, crop_pct 0.9, ImageNet stats
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

ARCHS = {
    'swin_tiny_patch4_window7_224': dict(
        embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24),
        patch=4, window=7),
    'swin_small_patch4_window7_224': dict(
        embed_dim=96, depths=(2, 2, 18, 2), heads=(3, 6, 12, 24),
        patch=4, window=7),
    'swin_base_patch4_window7_224': dict(
        embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
        patch=4, window=7),
}

LN_EPS = 1e-5  # timm swin uses the nn.LayerNorm default, not ViT's 1e-6


def _layer_norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    return nn.layer_norm(x, p, LN_EPS)


def _calc_window_shift(feat: Tuple[int, int], window: int, shift: int
                       ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """timm ``SwinTransformerBlock._calc_window_shift``: a feature map no
    larger than the window collapses to one unshifted full-map window."""
    ws = tuple(f if f <= window else window for f in feat)
    ss = tuple(0 if f <= w else shift for f, w in zip(feat, ws))
    return ws, ss


def _rel_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh·ww, wh·ww) index into the (2wh-1)(2ww-1) bias table (timm
    ``get_relative_position_index``)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))           # (2, wh, ww)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # (2, N, N)
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)                     # (N, N)


def _shift_attn_mask(h: int, w: int, wh: int, ww: int,
                     sh: int, sw: int) -> Optional[np.ndarray]:
    """(nW, N, N) additive mask (0 / -100) that keeps shifted-window
    attention inside the original neighbourhoods (timm
    ``SwinTransformerBlock.__init__``), on the window-padded grid."""
    if not (sh or sw):
        return None
    hp = -(-h // wh) * wh
    wp = -(-w // ww) * ww
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh if sh else None),
               slice(-sh, None) if sh else slice(0, 0)):
        for ws_ in (slice(0, -ww), slice(-ww, -sw if sw else None),
                    slice(-sw, None) if sw else slice(0, 0)):
            img[hs, ws_] = cnt
            cnt += 1
    win = (img.reshape(hp // wh, wh, wp // ww, ww)
           .transpose(0, 2, 1, 3).reshape(-1, wh * ww))     # (nW, N)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def _device_index(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rel_position_index(wh, ww).reshape(-1)).to(device)


@lru_cache(maxsize=None)
def _device_mask(h: int, w: int, wh: int, ww: int, sh: int, sw: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    mask = _shift_attn_mask(h, w, wh, ww, sh, sw)
    return None if mask is None else torch.from_numpy(mask).to(device)


def _window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, wh·ww, C), row-major windows."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, C)


def _window_reverse(x: torch.Tensor, wh: int, ww: int, H: int, W: int,
                    B: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // wh, W // ww, wh, ww, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _window_attention(p: Params, x: torch.Tensor, num_heads: int,
                      wh: int, ww: int,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """timm ``WindowAttention`` on (B·nW, N, C) windows: qkv → scaled
    scores + relative-position bias (+ shift mask) → softmax → proj."""
    Bn, N, C = x.shape
    hd = C // num_heads
    qkv = linear(x, p['qkv']).reshape(Bn, N, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)          # (Bn, H, N, hd)
    scores = (q * hd ** -0.5) @ k.transpose(-1, -2)         # (Bn, H, N, N)
    bias = p['relative_position_bias_table'][_device_index(wh, ww, x.device)]
    scores = scores + bias.reshape(N, N, num_heads).permute(2, 0, 1)
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(Bn // nw, nw, num_heads, N, N)
                  + mask[None, :, None]).reshape(Bn, num_heads, N, N)
    out = (nn.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(Bn, N, C)
    return linear(out, p['proj'])


def _block(p: Params, x: torch.Tensor, num_heads: int, window: int,
           shift: bool) -> torch.Tensor:
    """timm ``SwinTransformerBlock`` on an NHWC map: (shifted-)window
    attention, then the MLP, both pre-norm residual."""
    B, H, W, C = x.shape
    (wh, ww), (sh, sw) = _calc_window_shift(
        (H, W), window, window // 2 if shift else 0)

    t = _layer_norm(x, p['norm1'])
    if sh or sw:
        t = torch.roll(t, shifts=(-sh, -sw), dims=(1, 2))
    pad_h, pad_w = (wh - H % wh) % wh, (ww - W % ww) % ww
    if pad_h or pad_w:
        t = F.pad(t, (0, 0, 0, pad_w, 0, pad_h))
    wins = _window_attention(p['attn'], _window_partition(t, wh, ww),
                             num_heads, wh, ww,
                             _device_mask(H, W, wh, ww, sh, sw, x.device))
    t = _window_reverse(wins, wh, ww, H + pad_h, W + pad_w, B)[:, :H, :W]
    if sh or sw:
        t = torch.roll(t, shifts=(sh, sw), dims=(1, 2))
    x = x + t
    return x + mlp(p['mlp'], _layer_norm(x, p['norm2']))


def _patch_merging(p: Params, x: torch.Tensor) -> torch.Tensor:
    """timm ``PatchMerging``: 2×2 neighbourhood → channel concat (h-major
    per column pair) → norm → bias-free halving linear."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = H + H % 2, W + W % 2
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x = x.permute(0, 1, 3, 4, 2, 5).reshape(B, H // 2, W // 2, 4 * C)
    return linear(_layer_norm(x, p['norm']), p['reduction'])


def forward(params: Params, x: torch.Tensor,
            arch: str = 'swin_tiny_patch4_window7_224',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, 8·embed_dim) pooled features
    (or (B, 1000) logits with ``features=False`` and a loaded head)."""
    cfg = ARCHS[arch]
    pe = params['patch_embed']
    x = conv(x, pe['proj']['weight'], stride=cfg['patch'], bias=pe['proj']['bias'])
    x = _layer_norm(x, pe['norm'])
    for i, depth in enumerate(cfg['depths']):
        stage = params['layers'][str(i)]
        if i > 0:
            x = _patch_merging(stage['downsample'], x)
        for j in range(depth):
            x = _block(stage['blocks'][str(j)], x, cfg['heads'][i],
                       cfg['window'], shift=bool(j % 2))
    x = _layer_norm(x, params['norm']).mean(dim=(1, 2))
    if features or 'fc' not in params.get('head', {}):
        return x
    return linear(x, params['head']['fc'])


def feat_dim(arch: str) -> int:
    return ARCHS[arch]['embed_dim'] * 8


def init_state_dict(arch: str = 'swin_tiny_patch4_window7_224',
                    seed: int = 0, num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's); the relative-position index
    and the attention mask are derived, not stored."""
    cfg = ARCHS[arch]
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def lin(name, i, o, bias=True, scale=0.04):
        sd[f'{name}.weight'] = rng.randn(o, i).astype(np.float32) * scale
        if bias:
            sd[f'{name}.bias'] = rng.randn(o).astype(np.float32) * 0.02

    def ln(name, c):
        sd[f'{name}.weight'] = (rng.rand(c).astype(np.float32) * 0.2 + 0.9)
        sd[f'{name}.bias'] = rng.randn(c).astype(np.float32) * 0.02

    C0, win = cfg['embed_dim'], cfg['window']
    sd['patch_embed.proj.weight'] = (
        rng.randn(C0, 3, cfg['patch'], cfg['patch']).astype(np.float32) * 0.05)
    sd['patch_embed.proj.bias'] = rng.randn(C0).astype(np.float32) * 0.02
    ln('patch_embed.norm', C0)

    for i, depth in enumerate(cfg['depths']):
        dim = C0 * 2 ** i
        if i > 0:
            ln(f'layers.{i}.downsample.norm', 2 * dim)
            lin(f'layers.{i}.downsample.reduction', 2 * dim, dim, bias=False)
        heads = cfg['heads'][i]
        for j in range(depth):
            base = f'layers.{i}.blocks.{j}'
            ln(f'{base}.norm1', dim)
            lin(f'{base}.attn.qkv', dim, 3 * dim)
            sd[f'{base}.attn.relative_position_bias_table'] = (
                rng.randn((2 * win - 1) ** 2, heads).astype(np.float32) * 0.02)
            lin(f'{base}.attn.proj', dim, dim)
            ln(f'{base}.norm2', dim)
            lin(f'{base}.mlp.fc1', dim, 4 * dim)
            lin(f'{base}.mlp.fc2', 4 * dim, dim)
    ln('norm', C0 * 8)
    if num_classes:
        lin('head.fc', C0 * 8, num_classes)
    return sd
