"""EfficientNet image backbones (timm ``efficientnet_b*`` state_dict
layout), port of ``video_features_tpu/models/efficientnet.py``.

Params follow timm 0.9.12's ``EfficientNet`` (``conv_stem``/``bn1``,
``blocks.S.B.{conv_pw,bn1,conv_dw,bn2,se.conv_reduce,se.conv_expand,
conv_pwl,bn3}``, ``conv_head``/``bn2``, ``classifier``). Layout NHWC.
Convolutions pad symmetrically (``kernel // 2``), as timm's native
``efficientnet_b*`` do; TF "SAME" padding belongs to the ``tf_`` ports,
which are not in the registry. SiLU activations, squeeze-excite gates,
inverted residuals; features are the global average pool of
``conv_head``'s output.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.ops.nn import batch_norm, conv, linear

Params = Dict[str, Any]

# timm efficientnet default_cfg: bicubic, ImageNet stats
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# b0's stage table: (kernel, stride, expand, out_channels, repeats);
# stage 0 is the DepthwiseSeparableConv stage (no expansion conv)
_BASE_STAGES: List[Tuple[int, int, int, int, int]] = [
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
]
SE_RATIO = 0.25

# name: (width_mult, depth_mult, input_size, crop_pct), per timm 0.9.12's
# default_cfgs
ARCHS = {
    'efficientnet_b0': (1.0, 1.0, 224, 0.875),
    'efficientnet_b1': (1.0, 1.1, 240, 0.882),
}


def _round_channels(c: float, mult: float, divisor: int = 8) -> int:
    """timm ``round_channels``: scale, then round to the nearest multiple
    of 8, never dropping below 90%."""
    c *= mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return new


def _round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(r * mult))


def stage_table(arch: str) -> List[Tuple[int, int, int, int, int]]:
    wm, dm, _, _ = ARCHS[arch]
    return [(k, s, e, _round_channels(c, wm), _round_repeats(r, dm))
            for k, s, e, c, r in _BASE_STAGES]


def stem_head_channels(arch: str) -> Tuple[int, int]:
    wm = ARCHS[arch][0]
    return _round_channels(32, wm), _round_channels(1280, wm)


def feat_dim(arch: str) -> int:
    return stem_head_channels(arch)[1]


def _bn_silu(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.silu(batch_norm(x, p))


def _se(p: Params, x: torch.Tensor) -> torch.Tensor:
    """timm ``SqueezeExcite``: global mean → 1×1 reduce → SiLU → 1×1
    expand → sigmoid gate."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = F.silu(conv(s, p['conv_reduce']['weight'], bias=p['conv_reduce']['bias']))
    s = conv(s, p['conv_expand']['weight'], bias=p['conv_expand']['bias'])
    return x * torch.sigmoid(s)


def _ds_block(p: Params, x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """DepthwiseSeparableConv (stage 0): dw → bn+silu → se → pw → bn,
    residual when the shapes allow."""
    c = x.shape[-1]
    h = conv(x, p['conv_dw']['weight'], stride=stride, padding=kernel // 2,
             groups=c)
    h = _se(p['se'], _bn_silu(h, p['bn1']))
    h = batch_norm(conv(h, p['conv_pw']['weight']), p['bn2'])
    return h + x if stride == 1 and h.shape[-1] == c else h


def _ir_block(p: Params, x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """InvertedResidual: pw expand → bn+silu → dw → bn+silu → se → pw
    project → bn, residual when the shapes allow."""
    c = x.shape[-1]
    h = _bn_silu(conv(x, p['conv_pw']['weight']), p['bn1'])
    h = conv(h, p['conv_dw']['weight'], stride=stride, padding=kernel // 2,
             groups=h.shape[-1])
    h = _se(p['se'], _bn_silu(h, p['bn2']))
    h = batch_norm(conv(h, p['conv_pwl']['weight']), p['bn3'])
    return h + x if stride == 1 and h.shape[-1] == c else h


def forward(params: Params, x: torch.Tensor, arch: str = 'efficientnet_b0',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, head_ch) pooled features (or
    (B, 1000) logits with ``features=False`` and a loaded classifier)."""
    x = _bn_silu(conv(x, params['conv_stem']['weight'], stride=2, padding=1),
                 params['bn1'])
    for si, (k, s, _, _, r) in enumerate(stage_table(arch)):
        stage = params['blocks'][str(si)]
        block = _ds_block if si == 0 else _ir_block
        for bi in range(r):
            x = block(stage[str(bi)], x, k, s if bi == 0 else 1)
    x = _bn_silu(conv(x, params['conv_head']['weight']), params['bn2'])
    x = x.mean(dim=(1, 2))
    return x if features else linear(x, params['classifier'])


def init_state_dict(arch: str = 'efficientnet_b0', seed: int = 0,
                    num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's)."""
    from video_features_torch.models._seed import SeedWriter
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    w_ = SeedWriter(sd, rng)
    cw, bn = w_.conv, w_.bn

    stem, head = stem_head_channels(arch)
    cw('conv_stem', stem, 3, 3)
    bn('bn1', stem)
    cin = stem
    for si, (k, s, e, c, r) in enumerate(stage_table(arch)):
        for bi in range(r):
            base = f'blocks.{si}.{bi}'
            block_in = cin if bi == 0 else c
            rd = max(1, int(block_in * SE_RATIO))
            if si == 0:
                w_.dwconv(f'{base}.conv_dw', block_in, k)
                bn(f'{base}.bn1', block_in)
                cw(f'{base}.se.conv_reduce', rd, block_in, 1, bias=True)
                cw(f'{base}.se.conv_expand', block_in, rd, 1, bias=True)
                cw(f'{base}.conv_pw', c, block_in, 1)
                bn(f'{base}.bn2', c)
            else:
                ce = block_in * e
                cw(f'{base}.conv_pw', ce, block_in, 1)
                bn(f'{base}.bn1', ce)
                w_.dwconv(f'{base}.conv_dw', ce, k)
                bn(f'{base}.bn2', ce)
                cw(f'{base}.se.conv_reduce', rd, ce, 1, bias=True)
                cw(f'{base}.se.conv_expand', ce, rd, 1, bias=True)
                cw(f'{base}.conv_pwl', c, ce, 1)
                bn(f'{base}.bn3', c)
        cin = c
    cw('conv_head', head, cin, 1)
    bn('bn2', head)
    if num_classes:
        w_.linear('classifier', num_classes, head)
    return sd
