"""Plain RAFT ('basic' model, raft-sintel widths), channels-first float32.

Follows princeton-vl/RAFT (Teed & Deng, ECCV 2020): BasicEncoder for the
feature (instance norm) and context (batch norm) networks, the all-pairs
correlation volume with a 4-level average-pooled pyramid looked up by
``grid_sample`` (radius 4, align_corners=True, zeros outside), the
BasicMotionEncoder, the SepConvGRU, the flow head, the 0.25-scaled mask
head and the convex 8x upsample. Weights are a state dict in the
upstream naming and layout.

One departure, which changes no value beyond rounding: the GRU's input
``[h, inp, motion]`` splits its weights by input block, and the ``inp``
block's term, which the 20 iterations share, is computed once before the
loop (:func:`context_terms`). The upstream code recomputes it every
iteration; counting FLOPs over this model counts what the algorithm needs.
The mask head runs once, after the loop: only the final mask is used.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

HIDDEN = 128
CONTEXT = 128
LEVELS = 4
RADIUS = 4
ITERS = 20
GATES = ('z', 'r', 'q')


def leaves() -> List[Tuple[str, tuple, str]]:
    """Every weight of the model: (name, shape, kind), in a fixed order.
    Kinds: 'conv' and 'bias' (normal), 'bn_weight' and 'bn_var'
    (uniform), 'bn_bias' and 'bn_mean' (normal), 'flow_out' (the flow
    head's last conv, normal at a small scale)."""
    out = []

    def conv(name, o, i, kh, kw, kind='conv'):
        out.append((f'{name}.weight', (o, i, kh, kw), kind))
        out.append((f'{name}.bias', (o,), 'bias'))

    def bn(name, c):
        for leaf, kind in (('weight', 'bn_weight'), ('bias', 'bn_bias'),
                           ('running_mean', 'bn_mean'),
                           ('running_var', 'bn_var')):
            out.append((f'{name}.{leaf}', (c,), kind))

    def encoder(prefix, out_dim, batch_norm):
        conv(f'{prefix}.conv1', 64, 3, 7, 7)
        if batch_norm:
            bn(f'{prefix}.norm1', 64)
        cin = 64
        for li, (cout, stride) in enumerate(((64, 1), (96, 2), (128, 2)), 1):
            for bi in range(2):
                base = f'{prefix}.layer{li}.{bi}'
                s = stride if bi == 0 else 1
                conv(f'{base}.conv1', cout, cin, 3, 3)
                conv(f'{base}.conv2', cout, cout, 3, 3)
                if batch_norm:
                    bn(f'{base}.norm1', cout)
                    bn(f'{base}.norm2', cout)
                if s != 1:
                    conv(f'{base}.downsample.0', cout, cin, 1, 1)
                    if batch_norm:
                        bn(f'{base}.norm3', cout)
                cin = cout
        conv(f'{prefix}.conv2', out_dim, 128, 1, 1)

    encoder('fnet', 256, False)
    encoder('cnet', HIDDEN + CONTEXT, True)
    cor = LEVELS * (2 * RADIUS + 1) ** 2
    conv('update_block.encoder.convc1', 256, cor, 1, 1)
    conv('update_block.encoder.convc2', 192, 256, 3, 3)
    conv('update_block.encoder.convf1', 128, 2, 7, 7)
    conv('update_block.encoder.convf2', 64, 128, 3, 3)
    conv('update_block.encoder.conv', 126, 256, 3, 3)
    for g in GATES:
        conv(f'update_block.gru.conv{g}1', HIDDEN, HIDDEN + 256, 1, 5)
        conv(f'update_block.gru.conv{g}2', HIDDEN, HIDDEN + 256, 5, 1)
    conv('update_block.flow_head.conv1', 256, HIDDEN, 3, 3)
    conv('update_block.flow_head.conv2', 2, 256, 3, 3, kind='flow_out')
    conv('update_block.mask.0', 256, HIDDEN, 3, 3)
    conv('update_block.mask.2', 64 * 9, 256, 1, 1)
    return out


def _conv(sd, name, x, stride=1, padding=0):
    return F.conv2d(x, sd[f'{name}.weight'], sd.get(f'{name}.bias'),
                    stride, padding)


def _norm(sd, name, x, batch_norm):
    if batch_norm:
        return F.batch_norm(x, sd[f'{name}.running_mean'],
                            sd[f'{name}.running_var'], sd[f'{name}.weight'],
                            sd[f'{name}.bias'], False, 0.0, 1e-5)
    return F.instance_norm(x, eps=1e-5)


def encoder(sd, prefix: str, x: torch.Tensor, batch_norm: bool):
    """BasicEncoder: (N, 3, H, W) in [-1, 1] → (N, C, H/8, W/8)."""
    x = F.relu(_norm(sd, f'{prefix}.norm1',
                     _conv(sd, f'{prefix}.conv1', x, 2, 3), batch_norm))
    for li, stride in ((1, 1), (2, 2), (3, 2)):
        for bi in range(2):
            base = f'{prefix}.layer{li}.{bi}'
            s = stride if bi == 0 else 1
            y = F.relu(_norm(sd, f'{base}.norm1',
                             _conv(sd, f'{base}.conv1', x, s, 1), batch_norm))
            y = F.relu(_norm(sd, f'{base}.norm2',
                             _conv(sd, f'{base}.conv2', y, 1, 1), batch_norm))
            if f'{base}.downsample.0.weight' in sd:
                x = _norm(sd, f'{base}.norm3',
                          _conv(sd, f'{base}.downsample.0', x, s), batch_norm)
            x = F.relu(x + y)
    return _conv(sd, f'{prefix}.conv2', x)


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
    """CorrBlock: the all-pairs volume f1ᵀf2/√C as (N·H·W, 1, H, W), then
    2×2 average pools."""
    n, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(n, c, h * w).transpose(1, 2),
                        fmap2.reshape(n, c, h * w)) / math.sqrt(c)
    pyramid = [corr.reshape(n * h * w, 1, h, w)]
    for _ in range(LEVELS - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """CorrBlock.__call__: (N, 2, H, W) level-0 (x, y) coordinates →
    (N, LEVELS·(2r+1)², H, W), bilinear with zeros outside."""
    n, _, h, w = coords.shape
    xy = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    d = torch.linspace(-RADIUS, RADIUS, 2 * RADIUS + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing='ij'), dim=-1)
    out = []
    for i, corr in enumerate(pyramid):
        grid = xy / 2 ** i + delta.reshape(1, 2 * RADIUS + 1, 2 * RADIUS + 1, 2)
        hh, ww = corr.shape[-2:]
        gx = 2 * grid[..., 0] / (ww - 1) - 1
        gy = 2 * grid[..., 1] / (hh - 1) - 1
        sampled = F.grid_sample(corr, torch.stack([gx, gy], dim=-1),
                                align_corners=True)
        out.append(sampled.reshape(n, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def _gru_split(sd) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each GRU conv's weight split by input block: (h | motion) weight,
    inp weight, bias."""
    out = {}
    for g in GATES:
        for axis in ('1', '2'):
            w = sd[f'update_block.gru.conv{g}{axis}.weight']
            hm = torch.cat([w[:, :HIDDEN], w[:, HIDDEN + CONTEXT:]], dim=1)
            out[g + axis] = (hm, w[:, HIDDEN:HIDDEN + CONTEXT],
                             sd[f'update_block.gru.conv{g}{axis}.bias'])
    return out


def _gru_pad(axis: str):
    return (0, 2) if axis == '1' else (2, 0)


def context_terms(split, inp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The loop-invariant ``inp`` term (with the bias) of every GRU conv."""
    return {k: F.conv2d(inp, wi, b, padding=_gru_pad(k[-1]))
            for k, (_, wi, b) in split.items()}


def sep_conv_gru(split, terms, h, motion):
    for axis in ('1', '2'):
        pad = _gru_pad(axis)
        hx = torch.cat([h, motion], dim=1)
        z = torch.sigmoid(F.conv2d(hx, split['z' + axis][0], padding=pad)
                          + terms['z' + axis])
        r = torch.sigmoid(F.conv2d(hx, split['r' + axis][0], padding=pad)
                          + terms['r' + axis])
        q = torch.tanh(F.conv2d(torch.cat([r * h, motion], dim=1),
                                split['q' + axis][0], padding=pad)
                       + terms['q' + axis])
        h = (1 - z) * h + z * q
    return h


def motion_encoder(sd, flow, corr):
    p = 'update_block.encoder'
    cor = F.relu(_conv(sd, f'{p}.convc1', corr))
    cor = F.relu(_conv(sd, f'{p}.convc2', cor, padding=1))
    flo = F.relu(_conv(sd, f'{p}.convf1', flow, padding=3))
    flo = F.relu(_conv(sd, f'{p}.convf2', flo, padding=1))
    out = F.relu(_conv(sd, f'{p}.conv', torch.cat([cor, flo], dim=1), padding=1))
    return torch.cat([out, flow], dim=1)


def upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex upsample: flow (N, 2, H, W), mask (N, 576, H, W) →
    (N, 2, 8H, 8W)."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def refine(sd, fmap1, fmap2, cnet, iters: int = ITERS) -> torch.Tensor:
    """Correlation pyramid, ``iters`` update iterations, mask head and
    upsample: encoder outputs → (N, 2, 8h, 8w) flow."""
    net = torch.tanh(cnet[:, :HIDDEN])
    inp = F.relu(cnet[:, HIDDEN:])
    n, _, h, w = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=fmap1.device),
                            torch.arange(w, device=fmap1.device), indexing='ij')
    coords0 = torch.stack([xs, ys]).float()[None].expand(n, 2, h, w)
    pyramid = corr_pyramid(fmap1, fmap2)
    split = _gru_split(sd)
    terms = context_terms(split, inp)
    coords1 = coords0
    for _ in range(iters):
        corr = corr_lookup(pyramid, coords1)
        flow = coords1 - coords0
        net = sep_conv_gru(split, terms, net, motion_encoder(sd, flow, corr))
        t = F.relu(_conv(sd, 'update_block.flow_head.conv1', net, padding=1))
        coords1 = coords1 + _conv(sd, 'update_block.flow_head.conv2', t,
                                  padding=1)
    t = F.relu(_conv(sd, 'update_block.mask.0', net, padding=1))
    mask = 0.25 * _conv(sd, 'update_block.mask.2', t)
    return upsample(coords1 - coords0, mask)


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (N, 3, H, W) → float32 in [-1, 1]."""
    return 2 * (frames.float() / 255.0) - 1.0


def pad_amounts(h: int, w: int, multiple: int = 8):
    """InputPadder('sintel'): (left, right, top, bottom), centred."""
    ph = (((h // multiple) + 1) * multiple - h) % multiple
    pw = (((w // multiple) + 1) * multiple - w) % multiple
    return (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)


def flows(sd, frames: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """(T, 3, H, W) uint8 consecutive frames, H and W multiples of 8 →
    (T-1, 2, H, W) flow from each frame to the next."""
    x = normalize(frames)
    fmaps = encoder(sd, 'fnet', x, False)
    cnet = encoder(sd, 'cnet', x[:-1], True)
    return refine(sd, fmaps[:-1], fmaps[1:], cnet, iters)


def pair_flows(sd, first: torch.Tensor, second: torch.Tensor,
               iters: int = ITERS) -> torch.Tensor:
    """RAFT.forward on (N, 3, H, W) frame pairs (values 0..255, H and W
    multiples of 8) → (N, 2, H, W) flow from ``first`` to ``second``."""
    x1, x2 = normalize(first), normalize(second)
    return refine(sd, encoder(sd, 'fnet', x1, False),
                  encoder(sd, 'fnet', x2, False), encoder(sd, 'cnet', x1, True),
                  iters)
