"""Vision Transformer image backbones (timm ``vit_*`` state_dict layout),
port of ``video_features_tpu/models/vit.py``.

Params are nested dicts of torch tensors keyed like timm's
``VisionTransformer`` (``cls_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp}``, ``norm``, ``head``),
weights in torch's layout. Input (B, H, W, 3), normalized.

  * pre-norm blocks (LayerNorm eps 1e-6, exact-erf GELU), fused qkv;
  * attention is dense below ``BLOCKWISE_THRESHOLD`` tokens and
    blockwise (512-key blocks) from there on;
  * an input that is not the checkpoint's 224 px resamples the pos
    embed's grid with ``jax.image.resize``'s bicubic (Keys a = -0.5),
    whose weights :func:`bicubic_weights` copies; ``F.interpolate``'s
    bicubic is a = -0.75 and gives other numbers;
  * features are the cls token after the final norm; a distilled DeiT
    checkpoint (``dist_token``) gives the mean of the cls and dist
    tokens, and its logits the mean of ``head`` and ``head_dist``;
  * every linear goes through ``ops/nn.py::linear`` (the 3xTF32 GEMM on
    the three-pass lane), the attention products through
    ``ops/attention.py``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.ops import attention, nn
from video_features_torch.ops.nn import conv

Params = Dict[str, Any]

# timm default_cfg: 224 px, bicubic, crop_pct 0.9, "inception" 0.5 stats
MEAN = (0.5, 0.5, 0.5)
STD = (0.5, 0.5, 0.5)

ARCHS = {
    'vit_tiny_patch16_224': dict(width=192, layers=12, heads=3, patch=16),
    'vit_small_patch16_224': dict(width=384, layers=12, heads=6, patch=16),
    'vit_small_patch32_224': dict(width=384, layers=12, heads=6, patch=32),
    'vit_base_patch16_224': dict(width=768, layers=12, heads=12, patch=16),
    'vit_base_patch32_224': dict(width=768, layers=12, heads=12, patch=32),
    'vit_large_patch16_224': dict(width=1024, layers=24, heads=16, patch=16),
}
INPUT_RESOLUTION = 224

# from this many tokens on, attention runs blockwise (ViT-B/16 crosses it
# at image_size 736: 46² + 1 = 2117 tokens)
BLOCKWISE_THRESHOLD = 2048
_BLOCK = 512


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    return nn.layer_norm(x, p, eps)


def _attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """timm ``Attention``: fused qkv linear, per-head scaled dot product,
    dense or blockwise by token count."""
    B, N, D = x.shape
    qkv = nn.linear(x, p['qkv'])
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)
    if N >= BLOCKWISE_THRESHOLD:
        out = attention.blockwise_attention(q, k, v, block_size=_BLOCK)
    else:
        out = attention.dense_attention(q, k, v)
    return nn.linear(out.reshape(B, N, D), p['proj'])


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """fc1 → exact-erf GELU → fc2."""
    return nn.linear(F.gelu(nn.linear(x, p['fc1'])), p['fc2'])


def _block(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    x = x + _attention(p['attn'], layer_norm(x, p['norm1']), num_heads)
    return x + mlp(p['mlp'], layer_norm(x, p['norm2']))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5, in float32."""
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + two
    out = np.where(x >= one, far, out)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


@lru_cache(maxsize=None)
def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(method=
    'bicubic')`` along one axis (its ``compute_weight_mat``: half-pixel
    centres, each column normalized to sum 1, the kernel widened by
    1/scale when downsampling, since antialias is on by default)."""
    inv_scale = np.float32(1.0) / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid: Tuple[int, int],
                          n_prefix: int = 1) -> torch.Tensor:
    """Resample a (1, n_prefix + g², D) pos embed to a new (gh, gw) grid:
    the ``n_prefix`` prefix positions (cls, and dist for distilled DeiT)
    stay, the grid positions go through the bicubic resize of
    :func:`bicubic_weights`."""
    n = pos_embed.shape[1] - n_prefix
    side = int(round(n ** 0.5))
    if (side, side) == tuple(grid):
        return pos_embed
    d = pos_embed.shape[-1]
    g = pos_embed[:, n_prefix:].reshape(side, side, d)
    for axis, out in ((0, grid[0]), (1, grid[1])):
        if out == side:
            continue
        w = torch.from_numpy(bicubic_weights(side, out)).to(g.device, g.dtype)
        g = torch.tensordot(g, w, dims=([axis], [0])).movedim(-1, axis)
    return torch.cat([pos_embed[:, :n_prefix],
                      g.reshape(1, grid[0] * grid[1], d)], dim=1)


def embed(params: Params, x: torch.Tensor,
          arch: str = 'vit_base_patch16_224') -> torch.Tensor:
    """(B, H, W, 3) → (B, prefix + grid², width): patch conv, cls (and
    dist) tokens, resampled pos embed."""
    cfg = ARCHS[arch]
    k = params['patch_embed']['proj']
    x = conv(x, k['weight'], stride=cfg['patch'], bias=k['bias'])
    B, gh, gw, width = x.shape
    prefix = [params['cls_token'].expand(B, 1, width)]
    if 'dist_token' in params:
        prefix.append(params['dist_token'].expand(B, 1, width))
    tokens = torch.cat(prefix + [x.reshape(B, gh * gw, width)], dim=1)
    return tokens + interpolate_pos_embed(params['pos_embed'], (gh, gw),
                                          n_prefix=len(prefix))


def trunk(params: Params, tokens: torch.Tensor, arch: str) -> torch.Tensor:
    """Every transformer block over (B, N, width) tokens (no final norm)."""
    cfg = ARCHS[arch]
    for i in range(cfg['layers']):
        tokens = _block(params['blocks'][str(i)], tokens, cfg['heads'])
    return tokens


def forward(params: Params, x: torch.Tensor, arch: str = 'vit_base_patch16_224',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, width) features, or (B, 1000)
    logits with ``features=False``."""
    x = layer_norm(trunk(params, embed(params, x, arch), arch), params['norm'])
    return _pool(params, x, features)


def _pool(params: Params, x: torch.Tensor, features: bool) -> torch.Tensor:
    """Final-normed (B, N, width) tokens → features (the cls token, or for
    distilled DeiT the mean of cls and dist) or logits."""
    if 'dist_token' in params:
        if features:
            return (x[:, 0] + x[:, 1]) / 2
        return (nn.linear(x[:, 0], params['head'])
                + nn.linear(x[:, 1], params['head_dist'])) / 2
    if features:
        return x[:, 0]
    return nn.linear(x[:, 0], params['head'])


def forward_sequence_parallel(params: Params, x: torch.Tensor, mesh,
                              arch: str = 'vit_base_patch16_224',
                              axis: str = 'time', features: bool = True,
                              replicas: Optional[List[Params]] = None
                              ) -> torch.Tensor:
    """:func:`forward` with the TOKEN axis split over the devices of
    ``mesh[axis]``: tokens are zero-padded to a multiple of the shard
    count with a validity mask, every token-local op (layer norms, qkv,
    projections, MLP) runs on its shard's device, and attention is
    :func:`~video_features_torch.ops.attention.ring_attention`, the padded
    keys masked out of every softmax. ``replicas`` are the params on each
    device of the axis (copied here when None). The result, and the same
    head dispatch as :func:`forward`'s, are on ``x``'s device."""
    from video_features_torch.ops.attention import ring_attention
    from video_features_torch.parallel.mesh import move
    from video_features_torch.parallel.ring import axis_devices
    devices = axis_devices(mesh, axis)
    n = len(devices)
    if replicas is None:
        replicas = [move(params, d) for d in devices]
    cfg = ARCHS[arch]
    heads = cfg['heads']
    tokens = embed(params, x, arch)
    B, N, width = tokens.shape
    pad = (-N) % n
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    s = (N + pad) // n
    valid = torch.arange(N + pad, device=tokens.device) < N
    xs = [tokens[:, i * s:(i + 1) * s].to(d) for i, d in enumerate(devices)]
    masks = [valid[i * s:(i + 1) * s].to(d) for i, d in enumerate(devices)]
    for layer in range(cfg['layers']):
        ps = [r['blocks'][str(layer)] for r in replicas]
        qkv = []
        for p, t in zip(ps, xs):
            h = nn.linear(layer_norm(t, p['norm1']), p['attn']['qkv'])
            qkv.append(h.reshape(B, s, 3, heads, width // heads).unbind(2))
        outs = ring_attention([t[0] for t in qkv], [t[1] for t in qkv],
                              [t[2] for t in qkv], kv_valid=masks)
        xs = [t + nn.linear(o.reshape(B, s, width), p['attn']['proj'])
              for p, t, o in zip(ps, xs, outs)]
        xs = [t + mlp(p['mlp'], layer_norm(t, p['norm2']))
              for p, t in zip(ps, xs)]
    out = torch.cat([t.to(tokens.device) for t in xs], dim=1)[:, :N]
    return _pool(params, layer_norm(out, params['norm']), features)


def init_state_dict(seed: int = 0, arch: str = 'vit_base_patch16_224',
                    num_classes: int = 1000,
                    distilled: bool = False) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict (timm's keys and shapes; the same
    numbers as the JAX package's); ``distilled`` adds DeiT's dist_token,
    head_dist and extra pos slot."""
    cfg = ARCHS[arch]
    width, patch, layers = cfg['width'], cfg['patch'], cfg['layers']
    n_tokens = (2 if distilled else 1) + (INPUT_RESOLUTION // patch) ** 2
    rng = np.random.RandomState(seed)

    def f32(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {
        'cls_token': f32(1, 1, width),
        'pos_embed': f32(1, n_tokens, width),
        'patch_embed.proj.weight': f32(width, 3, patch, patch),
        'patch_embed.proj.bias': f32(width),
        'norm.weight': np.ones(width, np.float32),
        'norm.bias': np.zeros(width, np.float32),
        'head.weight': f32(num_classes, width),
        'head.bias': np.zeros(num_classes, np.float32),
    }
    if distilled:
        sd['dist_token'] = f32(1, 1, width)
        sd['head_dist.weight'] = f32(num_classes, width)
        sd['head_dist.bias'] = np.zeros(num_classes, np.float32)
    for i in range(layers):
        b = f'blocks.{i}.'
        sd[b + 'norm1.weight'] = np.ones(width, np.float32)
        sd[b + 'norm1.bias'] = np.zeros(width, np.float32)
        sd[b + 'attn.qkv.weight'] = f32(3 * width, width)
        sd[b + 'attn.qkv.bias'] = np.zeros(3 * width, np.float32)
        sd[b + 'attn.proj.weight'] = f32(width, width)
        sd[b + 'attn.proj.bias'] = np.zeros(width, np.float32)
        sd[b + 'norm2.weight'] = np.ones(width, np.float32)
        sd[b + 'norm2.bias'] = np.zeros(width, np.float32)
        sd[b + 'mlp.fc1.weight'] = f32(4 * width, width)
        sd[b + 'mlp.fc1.bias'] = np.zeros(4 * width, np.float32)
        sd[b + 'mlp.fc2.weight'] = f32(width, 4 * width)
        sd[b + 'mlp.fc2.bias'] = np.zeros(width, np.float32)
    return sd
