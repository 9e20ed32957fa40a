"""MobileNetV3 image backbones (timm ``mobilenetv3_*_100`` state_dict
layout), port of ``video_features_tpu/models/mobilenetv3.py``.

Params follow timm 0.9.12's ``MobileNetV3`` (``conv_stem``/``bn1``,
``blocks.S.B.*`` with efficientnet's block names, ``conv_head`` with a
bias, ``classifier``). Layout NHWC. Per block: ReLU early and hard-swish
late, squeeze-excite with a hard-sigmoid gate on some stages; the head's
1×1 conv and hard-swish run after the global pool, so the features are
the head's width. Hard-swish and hard-sigmoid are ``F.hardswish`` and
``F.hardsigmoid``, relu6(x + 3) / 6 as in ``jax.nn``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.ops.nn import batch_norm, conv, linear

Params = Dict[str, Any]

# timm mobilenetv3 _cfg: bilinear, crop_pct 0.875, ImageNet stats
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# per-block rows: (kind, kernel, stride, mid_chs, out_chs, act, se_chs);
# kind 'ds' depthwise-separable, 'ir' inverted residual, 'cn' conv-bn-act;
# act 're' ReLU, 'hs' hard-swish; se_chs 0 = no squeeze-excite
Block = Tuple[str, int, int, int, int, str, int]

ARCHS: Dict[str, Dict[str, Any]] = {
    'mobilenetv3_large_100': dict(
        stem=16, head=1280,
        blocks=[
            [('ds', 3, 1, 16, 16, 're', 0)],
            [('ir', 3, 2, 64, 24, 're', 0),
             ('ir', 3, 1, 72, 24, 're', 0)],
            [('ir', 5, 2, 72, 40, 're', 24),
             ('ir', 5, 1, 120, 40, 're', 32),
             ('ir', 5, 1, 120, 40, 're', 32)],
            [('ir', 3, 2, 240, 80, 'hs', 0),
             ('ir', 3, 1, 200, 80, 'hs', 0),
             ('ir', 3, 1, 184, 80, 'hs', 0),
             ('ir', 3, 1, 184, 80, 'hs', 0)],
            [('ir', 3, 1, 480, 112, 'hs', 120),
             ('ir', 3, 1, 672, 112, 'hs', 168)],
            [('ir', 5, 2, 672, 160, 'hs', 168),
             ('ir', 5, 1, 960, 160, 'hs', 240),
             ('ir', 5, 1, 960, 160, 'hs', 240)],
            [('cn', 1, 1, 0, 960, 'hs', 0)],
        ]),
    'mobilenetv3_small_100': dict(
        stem=16, head=1024,
        blocks=[
            [('ds', 3, 2, 16, 16, 're', 8)],
            [('ir', 3, 2, 72, 24, 're', 0),
             ('ir', 3, 1, 88, 24, 're', 0)],
            [('ir', 5, 2, 96, 40, 'hs', 24),
             ('ir', 5, 1, 240, 40, 'hs', 64),
             ('ir', 5, 1, 240, 40, 'hs', 64)],
            [('ir', 5, 1, 120, 48, 'hs', 32),
             ('ir', 5, 1, 144, 48, 'hs', 40)],
            [('ir', 5, 2, 288, 96, 'hs', 72),
             ('ir', 5, 1, 576, 96, 'hs', 144),
             ('ir', 5, 1, 576, 96, 'hs', 144)],
            [('cn', 1, 1, 0, 576, 'hs', 0)],
        ]),
}


def feat_dim(arch: str) -> int:
    return ARCHS[arch]['head']


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    return torch.relu(x) if kind == 're' else F.hardswish(x)


def _se(p: Params, x: torch.Tensor) -> torch.Tensor:
    """mean → 1×1 reduce → ReLU → 1×1 expand → hard-sigmoid gate."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = torch.relu(conv(s, p['conv_reduce']['weight'], bias=p['conv_reduce']['bias']))
    s = conv(s, p['conv_expand']['weight'], bias=p['conv_expand']['bias'])
    return x * F.hardsigmoid(s)


def _block(p: Params, x: torch.Tensor, row: Block) -> torch.Tensor:
    kind, k, stride, mid, out, act, se = row
    if kind == 'cn':
        return _act(batch_norm(conv(x, p['conv']['weight']), p['bn1']), act)
    cin = x.shape[-1]
    if kind == 'ds':
        h = conv(x, p['conv_dw']['weight'], stride=stride, padding=k // 2,
                 groups=cin)
        h = _act(batch_norm(h, p['bn1']), act)
        if se:
            h = _se(p['se'], h)
        h = batch_norm(conv(h, p['conv_pw']['weight']), p['bn2'])
    else:
        h = _act(batch_norm(conv(x, p['conv_pw']['weight']), p['bn1']), act)
        h = conv(h, p['conv_dw']['weight'], stride=stride, padding=k // 2,
                 groups=mid)
        h = _act(batch_norm(h, p['bn2']), act)
        if se:
            h = _se(p['se'], h)
        h = batch_norm(conv(h, p['conv_pwl']['weight']), p['bn3'])
    return h + x if stride == 1 and cin == out else h


def forward(params: Params, x: torch.Tensor,
            arch: str = 'mobilenetv3_large_100',
            features: bool = True) -> torch.Tensor:
    """(B, H, W, 3) normalized frames → (B, head) features (or (B, 1000)
    logits with ``features=False`` and a loaded classifier): the global
    pool first, then the biased head conv and hard-swish."""
    cfg = ARCHS[arch]
    x = conv(x, params['conv_stem']['weight'], stride=2, padding=1)
    x = _act(batch_norm(x, params['bn1']), 'hs')
    for si, stage in enumerate(cfg['blocks']):
        sp = params['blocks'][str(si)]
        for bi, row in enumerate(stage):
            x = _block(sp[str(bi)], x, row)
    x = x.mean(dim=(1, 2), keepdim=True)
    x = F.hardswish(conv(x, params['conv_head']['weight'],
                         bias=params['conv_head']['bias']))[:, 0, 0]
    return x if features else linear(x, params['classifier'])


def init_state_dict(arch: str = 'mobilenetv3_large_100', seed: int = 0,
                    num_classes: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with timm 0.9.12's names and shapes
    (the same numbers as the JAX package's)."""
    from video_features_torch.models._seed import SeedWriter
    rng = np.random.RandomState(seed)
    cfg = ARCHS[arch]
    sd: Dict[str, np.ndarray] = {}
    w_ = SeedWriter(sd, rng)
    cw, bn = w_.conv, w_.bn

    cw('conv_stem', cfg['stem'], 3, 3)
    bn('bn1', cfg['stem'])
    cin = cfg['stem']
    for si, stage in enumerate(cfg['blocks']):
        for bi, (kind, k, stride, mid, out, act, se) in enumerate(stage):
            base = f'blocks.{si}.{bi}'
            if kind == 'cn':
                cw(f'{base}.conv', out, cin, k)
                bn(f'{base}.bn1', out)
            elif kind == 'ds':
                w_.dwconv(f'{base}.conv_dw', cin, k)
                bn(f'{base}.bn1', cin)
                if se:
                    cw(f'{base}.se.conv_reduce', se, cin, 1, bias=True)
                    cw(f'{base}.se.conv_expand', cin, se, 1, bias=True)
                cw(f'{base}.conv_pw', out, cin, 1)
                bn(f'{base}.bn2', out)
            else:
                cw(f'{base}.conv_pw', mid, cin, 1)
                bn(f'{base}.bn1', mid)
                w_.dwconv(f'{base}.conv_dw', mid, k)
                bn(f'{base}.bn2', mid)
                if se:
                    cw(f'{base}.se.conv_reduce', se, mid, 1, bias=True)
                    cw(f'{base}.se.conv_expand', mid, se, 1, bias=True)
                cw(f'{base}.conv_pwl', out, mid, 1)
                bn(f'{base}.bn3', out)
            cin = out
    cw('conv_head', cfg['head'], cin, 1, bias=True)
    if num_classes:
        w_.linear('classifier', num_classes, cfg['head'])
    return sd
