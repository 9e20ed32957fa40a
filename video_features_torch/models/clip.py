"""CLIP (OpenAI): the ViT and ModifiedResNet visual towers and the text
transformer, port of ``video_features_tpu/models/clip.py``.

Params are nested dicts of torch tensors keyed like the OpenAI
checkpoint's state_dict, in torch's layout:

  * conv weights (O, I, kh, kw); ``attn.in_proj_weight`` (3D, D),
    ``out_proj``, ``c_fc``, ``c_proj`` and AttentionPool2d's
    ``q/k/v/c_proj`` weights (O, I), all used as linear weights;
  * ``visual.proj`` and ``text_projection`` are raw matmul operands,
    ``x @ W``;
  * ``token_embedding.weight`` (vocab, D) is a gather table.

Attention is plain matmuls and a softmax: q·kᵀ·scale, an additive mask,
softmax, ·v. Every linear and product goes through ``ops/nn.py::linear``
and ``::matmul`` (the 3xTF32 GEMM on the three-pass lane). Layout NHWC for
the image towers: input (B, H, W, 3), normalized.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from video_features_torch.ops import nn
from video_features_torch.ops.nn import (
    avg_pool, batch_norm, conv, linear, matmul, relu,
)

Params = Dict[str, Any]

# OpenAI CLIP preprocessing constants
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)

# leaves that the JAX transplant keeps in torch layout (params_from_jax)
NO_TRANSPOSE = ('token_embedding.weight',)

VISUAL_CFGS = {
    'ViT-B/32': dict(kind='vit', width=768, layers=12, heads=12, patch=32,
                     input_resolution=224, embed_dim=512),
    'ViT-B/16': dict(kind='vit', width=768, layers=12, heads=12, patch=16,
                     input_resolution=224, embed_dim=512),
    'RN50': dict(kind='resnet', width=64, layers=(3, 4, 6, 3), heads=32,
                 input_resolution=224, embed_dim=1024),
    'RN101': dict(kind='resnet', width=64, layers=(3, 4, 23, 3), heads=32,
                  input_resolution=224, embed_dim=512),
    'RN50x4': dict(kind='resnet', width=80, layers=(4, 6, 10, 6), heads=40,
                   input_resolution=288, embed_dim=640),
    'RN50x16': dict(kind='resnet', width=96, layers=(6, 8, 18, 8), heads=48,
                    input_resolution=384, embed_dim=768),
    'RN50x64': dict(kind='resnet', width=128, layers=(3, 15, 36, 10), heads=64,
                    input_resolution=448, embed_dim=1024),
    'ViT-L/14': dict(kind='vit', width=1024, layers=24, heads=16, patch=14,
                     input_resolution=224, embed_dim=768),
    'ViT-L/14@336px': dict(kind='vit', width=1024, layers=24, heads=16,
                           patch=14, input_resolution=336, embed_dim=768),
}


def model_def(model_name: str) -> dict:
    """``VISUAL_CFGS[model_name]``; an unknown name raises, listing the
    valid ones."""
    try:
        return VISUAL_CFGS[model_name]
    except KeyError:
        raise ValueError(f'model_name must be one of {", ".join(VISUAL_CFGS)} '
                         f'or custom; got {model_name!r}') from None


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis (biased variance)."""
    return nn.layer_norm(x, p, eps)


def multi_head_attention(p: Params, x: torch.Tensor, num_heads: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` self-attention with the fused
    ``in_proj``; x: (B, L, D)."""
    b, n, d = x.shape
    head_dim = d // num_heads

    def heads(t):
        return t.reshape(b, n, num_heads, head_dim).transpose(1, 2)
    q, k, v = linear(x, {'weight': p['in_proj_weight'],
                         'bias': p['in_proj_bias']}).chunk(3, dim=-1)
    q, k, v = heads(q), heads(k), heads(v)
    attn = matmul(q, k.transpose(-2, -1), alpha=head_dim ** -0.5)
    if mask is not None:
        attn = attn + mask
    out = matmul(nn.softmax(attn, dim=-1), v).transpose(1, 2).reshape(b, n, d)
    return linear(out, p['out_proj'])


def residual_attention_block(p: Params, x: torch.Tensor, num_heads: int,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = x + multi_head_attention(p['attn'], layer_norm(x, p['ln_1']),
                                 num_heads, mask)
    h = quick_gelu(linear(layer_norm(x, p['ln_2']), p['mlp']['c_fc']))
    return x + linear(h, p['mlp']['c_proj'])


def transformer(p: Params, x: torch.Tensor, num_heads: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    blocks = p['resblocks']
    for i in range(len(blocks)):
        x = residual_attention_block(blocks[str(i)], x, num_heads, mask)
    return x


# -- ViT visual tower --------------------------------------------------------

def encode_image_vit(params: Params, x: torch.Tensor,
                     model_name: str) -> torch.Tensor:
    """(B, H, W, 3) normalized → (B, embed_dim) image features."""
    cfg = VISUAL_CFGS[model_name]
    p = params['visual']
    x = conv(x, p['conv1']['weight'], stride=cfg['patch'])   # (B, g, g, width)
    b = x.shape[0]
    x = x.reshape(b, -1, cfg['width'])
    cls = p['class_embedding'].to(x.dtype).expand(b, 1, cfg['width'])
    x = torch.cat([cls, x], dim=1) + p['positional_embedding']
    x = layer_norm(x, p['ln_pre'])
    x = transformer(p['transformer'], x, cfg['heads'])
    return matmul(layer_norm(x[:, 0, :], p['ln_post']), p['proj'])


# -- ModifiedResNet visual tower ---------------------------------------------

def _clip_bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Bottleneck with anti-aliased striding: a stride-s average pool
    after the 3×3 conv, and before the shortcut's 1×1 conv."""
    out = relu(batch_norm(conv(x, p['conv1']['weight']), p['bn1']))
    out = relu(batch_norm(conv(out, p['conv2']['weight'], padding=1), p['bn2']))
    if stride > 1:
        out = avg_pool(out, stride)
    out = batch_norm(conv(out, p['conv3']['weight']), p['bn3'])
    identity = x
    if 'downsample' in p:
        if stride > 1:
            identity = avg_pool(identity, stride)
        identity = batch_norm(conv(identity, p['downsample']['0']['weight']),
                              p['downsample']['1'])
    return relu(out + identity)


def _attention_pool(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """AttentionPool2d: the mean token, prepended to the HW tokens, is
    the one query."""
    b, h, w, c = x.shape
    x = x.reshape(b, h * w, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + p['positional_embedding']
    n = x.shape[1]
    head_dim = c // num_heads
    q = linear(x[:, :1], p['q_proj']).reshape(b, 1, num_heads, head_dim)
    k = linear(x, p['k_proj']).reshape(b, n, num_heads, head_dim)
    v = linear(x, p['v_proj']).reshape(b, n, num_heads, head_dim)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    attn = nn.softmax(matmul(q, k.transpose(-2, -1), alpha=head_dim ** -0.5),
                      dim=-1)
    return linear(matmul(attn, v).transpose(1, 2).reshape(b, c), p['c_proj'])


def encode_image_resnet(params: Params, x: torch.Tensor,
                        model_name: str) -> torch.Tensor:
    """(B, H, W, 3) normalized → (B, embed_dim): the 3-conv stem
    (stride 2, then two stride-1 convs) and a 2×2 average pool, four
    layers of bottlenecks, AttentionPool2d."""
    cfg = VISUAL_CFGS[model_name]
    p = params['visual']
    x = relu(batch_norm(conv(x, p['conv1']['weight'], stride=2, padding=1), p['bn1']))
    x = relu(batch_norm(conv(x, p['conv2']['weight'], padding=1), p['bn2']))
    x = relu(batch_norm(conv(x, p['conv3']['weight'], padding=1), p['bn3']))
    x = avg_pool(x, 2)
    for li, nb in enumerate(cfg['layers'], start=1):
        layer = p[f'layer{li}']
        for bi in range(nb):
            x = _clip_bottleneck(layer[str(bi)], x, 2 if (li > 1 and bi == 0) else 1)
    return _attention_pool(p['attnpool'], x, cfg['heads'])


def encode_image(params: Params, x: torch.Tensor, model_name: str) -> torch.Tensor:
    if VISUAL_CFGS[model_name]['kind'] == 'vit':
        return encode_image_vit(params, x, model_name)
    return encode_image_resnet(params, x, model_name)


# -- text tower --------------------------------------------------------------

def encode_text(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) int tokens → (B, embed_dim) text features: a causal
    transformer (width // 64 heads), pooled at each row's largest token
    id (the end-of-text token)."""
    tokens = tokens.long()
    x = params['token_embedding']['weight'][tokens] + params['positional_embedding']
    n = x.shape[1]
    mask = torch.full((n, n), float('-inf'), dtype=x.dtype,
                      device=x.device).triu(1)
    x = transformer(params['transformer'], x, x.shape[-1] // 64, mask)
    x = layer_norm(x, params['ln_final'])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return matmul(x, params['text_projection'])


def zero_shot_logits(params: Params, image_feats: torch.Tensor,
                     text_feats: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits scaled by the learned temperature."""
    img = image_feats / image_feats.norm(dim=-1, keepdim=True)
    txt = text_feats / text_feats.norm(dim=-1, keepdim=True)
    return matmul(params['logit_scale'].exp() * img, txt.T)


# -- architecture inference (model_name=custom) ------------------------------

def _match_visual_cfg(kind: str, width: int, layers, patch=None,
                      grid=None) -> str:
    """The VISUAL_CFGS key of a tower's dimensions; ``grid`` (the ViT's
    positional-embedding side) tells ViT-L/14 from ViT-L/14@336px."""
    for name, cfg in VISUAL_CFGS.items():
        if cfg['kind'] != kind or cfg['width'] != width:
            continue
        if kind == 'vit' and cfg['patch'] == patch and cfg['layers'] == layers:
            if grid is None or cfg['input_resolution'] // cfg['patch'] == grid:
                return name
        if kind == 'resnet' and tuple(cfg['layers']) == tuple(layers):
            return name
    raise NotImplementedError(
        f'unrecognized {kind}: width={width} patch={patch} layers={layers} '
        f'grid={grid}')


def infer_model_name(state_dict: Mapping[str, Any]) -> str:
    """The architecture of an OpenAI-layout state_dict, detected as
    OpenAI's ``build_model`` does."""
    def shape(k):
        return tuple(state_dict[k].shape)

    if 'visual.proj' in state_dict:
        width, _, _, patch = shape('visual.conv1.weight')
        layers = len({k.split('.')[3] for k in state_dict
                      if k.startswith('visual.transformer.resblocks.')})
        grid = int(round((shape('visual.positional_embedding')[0] - 1) ** 0.5))
        return _match_visual_cfg('vit', width, layers, patch, grid)
    width = shape('visual.layer1.0.conv1.weight')[0]
    layers = tuple(len({k.split('.')[2] for k in state_dict
                        if k.startswith(f'visual.layer{li}.')})
                   for li in (1, 2, 3, 4))
    return _match_visual_cfg('resnet', width, layers)


def infer_model_name_from_params(params: Params) -> str:
    """:func:`infer_model_name` for a nested params tree."""
    visual = params['visual']
    if 'proj' in visual:
        width, _, _, patch = visual['conv1']['weight'].shape
        layers = len(visual['transformer']['resblocks'])
        grid = int(round((visual['positional_embedding'].shape[0] - 1) ** 0.5))
        return _match_visual_cfg('vit', width, layers, patch, grid)
    width = visual['layer1']['0']['conv1']['weight'].shape[0]
    layers = tuple(len(visual[f'layer{li}']) for li in (1, 2, 3, 4))
    return _match_visual_cfg('resnet', width, layers)


# -- random init -------------------------------------------------------------

def init_state_dict(seed: int = 0, model_name: str = 'ViT-B/32',
                    text_layers: int = 2, vocab_size: int = 512,
                    context_length: int = 77) -> Dict[str, np.ndarray]:
    """Random OpenAI-layout state_dict of a ViT model with a small text
    tower (the same numbers as the JAX package's ``init_state_dict``)."""
    cfg = model_def(model_name)
    if cfg['kind'] != 'vit':
        raise NotImplementedError(
            f'random init supports the ViT models only; {model_name} needs '
            '`checkpoint_path`')
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    w, d = cfg['width'], cfg['embed_dim']

    def f32(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def block(prefix, dim):
        sd[f'{prefix}.ln_1.weight'] = np.ones(dim, np.float32)
        sd[f'{prefix}.ln_1.bias'] = f32(dim)
        sd[f'{prefix}.attn.in_proj_weight'] = f32(3 * dim, dim)
        sd[f'{prefix}.attn.in_proj_bias'] = f32(3 * dim)
        sd[f'{prefix}.attn.out_proj.weight'] = f32(dim, dim)
        sd[f'{prefix}.attn.out_proj.bias'] = f32(dim)
        sd[f'{prefix}.ln_2.weight'] = np.ones(dim, np.float32)
        sd[f'{prefix}.ln_2.bias'] = f32(dim)
        sd[f'{prefix}.mlp.c_fc.weight'] = f32(4 * dim, dim)
        sd[f'{prefix}.mlp.c_fc.bias'] = f32(4 * dim)
        sd[f'{prefix}.mlp.c_proj.weight'] = f32(dim, 4 * dim)
        sd[f'{prefix}.mlp.c_proj.bias'] = f32(dim)

    grid = cfg['input_resolution'] // cfg['patch']
    sd['visual.conv1.weight'] = f32(w, 3, cfg['patch'], cfg['patch'])
    sd['visual.class_embedding'] = f32(w)
    sd['visual.positional_embedding'] = f32(grid * grid + 1, w)
    sd['visual.ln_pre.weight'] = np.ones(w, np.float32)
    sd['visual.ln_pre.bias'] = f32(w)
    for i in range(cfg['layers']):
        block(f'visual.transformer.resblocks.{i}', w)
    sd['visual.ln_post.weight'] = np.ones(w, np.float32)
    sd['visual.ln_post.bias'] = f32(w)
    sd['visual.proj'] = f32(w, d)

    tw = d              # a small text tower, as wide as the embedding
    sd['token_embedding.weight'] = f32(vocab_size, tw)
    sd['positional_embedding'] = f32(context_length, tw)
    for i in range(text_layers):
        block(f'transformer.resblocks.{i}', tw)
    sd['ln_final.weight'] = np.ones(tw, np.float32)
    sd['ln_final.bias'] = f32(tw)
    sd['text_projection'] = f32(tw, d)
    sd['logit_scale'] = np.float32(np.log(1 / 0.07))
    return sd
