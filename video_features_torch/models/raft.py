"""RAFT optical flow ('basic' variant), port of
``video_features_tpu/models/raft.py``.

Params are nested dicts of torch tensors whose keys mirror the torch
state_dict (``fnet.``/``cnet.``/``update_block.`` prefixes) and whose
weights keep torch's (O, I, kh, kw) layout. Tensors are channels-last:
two (B, H, W, 3) frames with values 0..255 in, (B, H, W, 2) flow out.
H and W must divide by 8 (:func:`pad_to_multiple`).

As in the JAX package: the loop-invariant context contribution to every
GRU conv is computed once before the refinement loop
(:func:`fuse_gru_params`, :func:`gru_inp_terms`) and the convex-upsample
mask head runs once after it.

On the card every refinement iteration launches two hand-written CUDA
kernels: the correlation-window lookup selected by ``VFT_RAFT_LOOKUP``
(ops/corr_lookup.py, once) and the SepConvGRU direction
(ops/gru.py, twice: the 1×5 pass, then the 5×1 pass). On the CPU both
run their plain versions. ``gru_passes`` is the GRU kernel's TF32
products per fp32 product: 3 (3xTF32) or 1, as the run's ``precision``
sets it (``utils/device.py::LANES``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_features_torch.ops import corr_lookup, gru as gru_op
from video_features_torch.ops.corr_lookup import (
    CORR_LEVELS, CORR_RADIUS, build_corr_pyramid,
)
from video_features_torch.ops.nn import batch_norm, conv, instance_norm, relu

Params = Dict[str, Any]

HIDDEN_DIM = 128
CONTEXT_DIM = 128
ITERS = 20
# the kernel libraries (csrc/<name>.cu) a forward launches on the card:
# the correlation lookup and the GRU direction
KERNEL_LIBRARIES = ('corr_lookup', 'gru_direction')


def resolve_iters(value) -> int:
    """Validate a config ``raft_iters`` (None → 20, the fork's pin)."""
    if value is None:
        return ITERS
    iters = int(value)
    if iters < 1:
        raise ValueError(f'raft_iters must be >= 1 (got {iters})')
    return iters


# -- encoders ----------------------------------------------------------------

def _norm(p: Params, name: str, x: torch.Tensor, norm_fn: str) -> torch.Tensor:
    if norm_fn == 'batch':
        return batch_norm(x, p[name])
    if norm_fn == 'instance':
        return instance_norm(x, p.get(name, {}))
    return x


def _residual_block(p: Params, x: torch.Tensor, norm_fn: str,
                    stride: int) -> torch.Tensor:
    y = relu(_norm(p, 'norm1', conv(x, p['conv1']['weight'], stride=stride,
                                    padding=1, bias=p['conv1']['bias']),
                   norm_fn))
    y = relu(_norm(p, 'norm2', conv(y, p['conv2']['weight'], padding=1,
                                    bias=p['conv2']['bias']), norm_fn))
    if 'downsample' in p:
        x = conv(x, p['downsample']['0']['weight'], stride=stride,
                 bias=p['downsample']['0']['bias'])
        x = _norm(p, 'norm3', x, norm_fn)
    return relu(x + y)


def basic_encoder(p: Params, x: torch.Tensor, norm_fn: str) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] → (B, H/8, W/8, out_dim)."""
    x = conv(x, p['conv1']['weight'], stride=2, padding=3,
             bias=p['conv1']['bias'])
    x = relu(_norm(p, 'norm1', x, norm_fn))
    for layer in ('layer1', 'layer2', 'layer3'):
        stride = 1 if layer == 'layer1' else 2
        x = _residual_block(p[layer]['0'], x, norm_fn, stride)
        x = _residual_block(p[layer]['1'], x, norm_fn, 1)
    return conv(x, p['conv2']['weight'], bias=p['conv2']['bias'])


# -- update block ------------------------------------------------------------

def _conv_b(p: Params, x: torch.Tensor, padding=0) -> torch.Tensor:
    return conv(x, p['weight'], padding=padding, bias=p['bias'])


def motion_encoder(p: Params, flow: torch.Tensor,
                   corr: torch.Tensor) -> torch.Tensor:
    cor = relu(_conv_b(p['convc1'], corr))
    cor = relu(_conv_b(p['convc2'], cor, padding=1))
    flo = relu(_conv_b(p['convf1'], flow, padding=3))
    flo = relu(_conv_b(p['convf2'], flo, padding=1))
    out = relu(_conv_b(p['conv'], torch.cat([cor, flo], -1), padding=1))
    return torch.cat([out, flow], -1)


# the SepConvGRU's passes by weight-name suffix: 1×5 (taps along W), then
# 5×1 (taps along H)
GRU_AXES = (('1', 'w'), ('2', 'h'))


def fuse_gru_params(p: Params, hidden: int = HIDDEN_DIM,
                    context: int = CONTEXT_DIM) -> Params:
    """Restructure the six GRU conv weights once per forward.

    The z and r gates of a direction read the same input, so their
    weights stack on the output axis (one conv computes both). Every GRU
    conv's input channels split as (h | inp | motion); the ``inp`` block
    is loop-invariant over the refinement iterations, so its term is
    computed once (:func:`gru_inp_terms`) and the per-iteration convs
    contract 256 channels instead of 384. The (h | motion) weights of a
    direction are repacked into the GRU kernel's tap layout
    (``ops/gru.py::pack_direction``) under ``'taps'``: (w_zr, w_q).
    """
    out = {}
    sl_h = slice(0, hidden)
    sl_i = slice(hidden, hidden + context)
    sl_m = slice(hidden + context, None)
    for suffix, _ in GRU_AXES:
        zw, rw = p[f'convz{suffix}'], p[f'convr{suffix}']
        w = torch.cat([zw['weight'], rw['weight']], dim=0)
        b = torch.cat([zw['bias'], rw['bias']])
        qw = p[f'convq{suffix}']['weight']
        out[f'zr{suffix}'] = {'inp': w[:, sl_i].contiguous(), 'bias': b}
        out[f'q{suffix}'] = {'inp': qw[:, sl_i].contiguous(),
                             'bias': p[f'convq{suffix}']['bias']}
        out[f'taps{suffix}'] = gru_op.pack_direction(
            torch.cat([w[:, sl_h], w[:, sl_m]], dim=1),
            torch.cat([qw[:, sl_h], qw[:, sl_m]], dim=1))
    return out


def gru_inp_terms(fused: Params, inp: torch.Tensor) -> Params:
    """The loop-invariant context contribution to all four GRU convs
    (plus their biases), computed once before the refinement loop."""
    terms = {}
    for suffix, axis in GRU_AXES:
        for gate in ('zr', 'q'):
            pp = fused[f'{gate}{suffix}']
            terms[f'{gate}{suffix}'] = conv(inp, pp['inp'],
                                            padding=gru_op.PADS[axis],
                                            bias=pp['bias']).contiguous()
    return terms


def sep_conv_gru(fused: Params, terms: Params, h: torch.Tensor,
                 motion: torch.Tensor, plain: bool = False,
                 passes: int = 3) -> torch.Tensor:
    """SepConvGRU: a 1×5 then a 5×1 pass over :func:`fuse_gru_params`
    weights plus the precomputed context terms, each pass one
    ``ops/gru.py::gru_direction`` in ``passes`` TF32 products (its plain
    version when ``plain``)."""
    direction = gru_op.gru_direction_plain if plain else gru_op.gru_direction
    for suffix, axis in GRU_AXES:
        w_zr, w_q = fused[f'taps{suffix}']
        h = direction(h, motion, w_zr, w_q, terms[f'zr{suffix}'],
                      terms[f'q{suffix}'], axis, passes=passes)
    return h


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8× upsample: flow (B, H, W, 2), mask
    (B, H, W, 576) → (B, 8H, 8W, 2)."""
    B, H, W, _ = flow.shape
    mask = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    # 3×3 patches, row-major to match F.unfold ordering
    patches = torch.stack([fp[:, i:i + H, j:j + W, :]
                           for i in range(3) for j in range(3)], dim=3)
    up = torch.einsum('bhwkij,bhwkc->bhwijc', mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, 2)


# -- full model --------------------------------------------------------------

def coords_grid(B: int, H: int, W: int, device=None) -> torch.Tensor:
    """(B, H, W, 2) grid of (x, y) pixel coordinates."""
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing='ij')
    return torch.stack([x, y], -1).expand(B, H, W, 2).contiguous()


def _normalize_frames(img: torch.Tensor) -> torch.Tensor:
    """0..255 RGB → ±1."""
    return 2.0 * (img.to(torch.float32) / 255.0) - 1.0


def forward(params: Params, image1: torch.Tensor, image2: torch.Tensor,
            iters: int = ITERS, plain_kernels: bool = False,
            gru_passes: int = 3) -> torch.Tensor:
    """Two (B, H, W, 3) frames (values 0..255) → (B, H, W, 2) flow."""
    image1 = _normalize_frames(image1)
    image2 = _normalize_frames(image2)
    fmap1 = basic_encoder(params['fnet'], image1, 'instance')
    fmap2 = basic_encoder(params['fnet'], image2, 'instance')
    cnet = basic_encoder(params['cnet'], image1, 'batch')
    return _refine(params, fmap1, fmap2, cnet, iters, plain_kernels,
                   gru_passes)


def forward_consecutive(params: Params, frames: torch.Tensor,
                        iters: int = ITERS, plain_kernels: bool = False,
                        gru_passes: int = 3) -> torch.Tensor:
    """(N, H, W, 3) consecutive frames → (N-1, H, W, 2) pairwise flows:
    :func:`forward` on ``(frames[:-1], frames[1:])``, with every frame
    fnet-encoded once."""
    return forward_stack_pairs(params, frames[None], iters,
                               plain_kernels=plain_kernels,
                               gru_passes=gru_passes)[0]


def forward_stack_pairs(params: Params, stacks: torch.Tensor,
                        iters: int = ITERS, plain_kernels: bool = False,
                        gru_passes: int = 3) -> torch.Tensor:
    """(B, S+1, H, W, 3) frame stacks → (B, S, H, W, 2) within-stack
    flows; fnet runs once on each of the B·(S+1) unique frames."""
    B, S1, H, W, C = stacks.shape
    S = S1 - 1
    flat = _normalize_frames(stacks.reshape(B * S1, H, W, C))
    fmaps = basic_encoder(params['fnet'], flat, 'instance')
    h8, w8, c = fmaps.shape[1:]
    fmaps = fmaps.reshape(B, S1, h8, w8, c)
    fmap1 = fmaps[:, :-1].reshape(B * S, h8, w8, c)
    fmap2 = fmaps[:, 1:].reshape(B * S, h8, w8, c)
    first = flat.reshape(B, S1, H, W, C)[:, :-1].reshape(B * S, H, W, C)
    cnet = basic_encoder(params['cnet'], first, 'batch')
    flow = _refine(params, fmap1, fmap2, cnet, iters, plain_kernels,
                   gru_passes)
    return flow.reshape(B, S, flow.shape[1], flow.shape[2], 2)


def _refine(params: Params, fmap1: torch.Tensor, fmap2: torch.Tensor,
            cnet: torch.Tensor, iters: int, plain_kernels: bool = False,
            gru_passes: int = 3) -> torch.Tensor:
    """Correlation pyramid + GRU refinement + 8× upsample.

    ``plain_kernels=True`` runs the plain versions of the selected lookup
    kernel and of the GRU direction kernel instead of the kernels (a test
    seam: it lets a run on the card hold the kernels against their plain
    versions end to end).
    """
    net, inp = torch.split(cnet, [HIDDEN_DIM, cnet.shape[-1] - HIDDEN_DIM],
                           dim=-1)
    net = torch.tanh(net)
    inp = relu(inp)

    B, H8, W8, _ = fmap1.shape
    coords0 = coords_grid(B, H8, W8, device=fmap1.device)
    up = params['update_block']

    prep, lookup = corr_lookup.select_lookup(
        corr_lookup.lookup_impl_from_env(), fmap1.device, plain=plain_kernels)
    levels = prep(build_corr_pyramid(fmap1, fmap2, CORR_LEVELS))
    fh, mk = up['flow_head'], up['mask']
    gru = fuse_gru_params(up['gru'])
    gru_terms = gru_inp_terms(gru, inp)

    coords1 = coords0
    for _ in range(iters):
        corr = lookup(levels, coords1)
        flow = coords1 - coords0
        motion = motion_encoder(up['encoder'], flow, corr)
        net = sep_conv_gru(gru, gru_terms, net, motion, plain=plain_kernels,
                           passes=gru_passes)
        t = relu(_conv_b(fh['conv1'], net, padding=1))
        delta = _conv_b(fh['conv2'], t, padding=1)
        coords1 = (coords1 + delta).contiguous()
    # the mask head once, after the loop: only the final mask is consumed
    t_mask = relu(_conv_b(mk['0'], net, padding=1))
    mask = 0.25 * _conv_b(mk['2'], t_mask)
    return upsample_flow(coords1 - coords0, mask)


def pad_to_multiple(x: torch.Tensor, mode: str = 'sintel', multiple: int = 8
                    ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Edge-pad (B, H, W, C) so H and W divide ``multiple``; returns
    (padded, (top, bottom, left, right)). 'sintel' centers the pad,
    'kitti' pads the bottom only in height."""
    pads = pad_amounts(x.shape[1], x.shape[2], mode, multiple)
    return edge_pad(x, pads, h_axis=1), pads


def pad_amounts(H: int, W: int, mode: str = 'sintel',
                multiple: int = 8) -> Tuple[int, int, int, int]:
    """The (top, bottom, left, right) edge pad that makes H, W divide
    ``multiple`` (the reference's InputPadder)."""
    pad_h = (((H // multiple) + 1) * multiple - H) % multiple
    pad_w = (((W // multiple) + 1) * multiple - W) % multiple
    if mode == 'sintel':
        return (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
    return (0, pad_h, pad_w // 2, pad_w - pad_w // 2)


def unpad(x: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """Undo :func:`pad_to_multiple` on (B, H, W, C)."""
    t, b, l, r = pads
    H, W = x.shape[1], x.shape[2]
    return x[:, t:H - b, l:W - r, :]


def edge_pad(x: torch.Tensor, pads: Tuple[int, int, int, int],
             h_axis: int) -> torch.Tensor:
    """Replicate-pad axes ``h_axis`` and ``h_axis + 1`` by (t, b, l, r),
    any dtype (an index gather of the edge rows and columns)."""
    t, b, l, r = pads
    if not any(pads):
        return x
    H, W = x.shape[h_axis], x.shape[h_axis + 1]
    rows = torch.arange(-t, H + b, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-l, W + r, device=x.device).clamp(0, W - 1)
    return x.index_select(h_axis, rows).index_select(h_axis + 1, cols)


# -- random init -------------------------------------------------------------

def init_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with princeton-vl RAFT naming and
    shapes (the same numbers as the JAX package's ``init_state_dict``)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv_w(name, o, i, kh, kw, scale=0.05):
        sd[f'{name}.weight'] = rng.randn(o, i, kh, kw).astype(np.float32) * scale
        sd[f'{name}.bias'] = rng.randn(o).astype(np.float32) * 0.05

    def bn(name, c):
        sd[f'{name}.weight'] = rng.rand(c).astype(np.float32) + 0.5
        sd[f'{name}.bias'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_mean'] = rng.randn(c).astype(np.float32) * 0.1
        sd[f'{name}.running_var'] = rng.rand(c).astype(np.float32) + 0.5

    def encoder(prefix, out_dim, norm_fn):
        conv_w(f'{prefix}.conv1', 64, 3, 7, 7)
        if norm_fn == 'batch':
            bn(f'{prefix}.norm1', 64)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for li, (i_p, o_p, stride) in enumerate(dims, start=1):
            for bi in range(2):
                base = f'{prefix}.layer{li}.{bi}'
                cin = i_p if bi == 0 else o_p
                s = stride if bi == 0 else 1
                conv_w(f'{base}.conv1', o_p, cin, 3, 3)
                conv_w(f'{base}.conv2', o_p, o_p, 3, 3)
                if norm_fn == 'batch':
                    bn(f'{base}.norm1', o_p)
                    bn(f'{base}.norm2', o_p)
                if s != 1 or cin != o_p:
                    conv_w(f'{base}.downsample.0', o_p, cin, 1, 1)
                    if norm_fn == 'batch':
                        bn(f'{base}.norm3', o_p)
        conv_w(f'{prefix}.conv2', out_dim, 128, 1, 1)

    encoder('fnet', 256, 'instance')
    encoder('cnet', HIDDEN_DIM + CONTEXT_DIM, 'batch')

    cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
    conv_w('update_block.encoder.convc1', 256, cor_planes, 1, 1)
    conv_w('update_block.encoder.convc2', 192, 256, 3, 3)
    conv_w('update_block.encoder.convf1', 128, 2, 7, 7)
    conv_w('update_block.encoder.convf2', 64, 128, 3, 3)
    conv_w('update_block.encoder.conv', 126, 256, 3, 3)
    for g in ('z', 'r', 'q'):
        conv_w(f'update_block.gru.conv{g}1', 128, 256 + 128, 1, 5)
        conv_w(f'update_block.gru.conv{g}2', 128, 256 + 128, 5, 1)
    conv_w('update_block.flow_head.conv1', 256, 128, 3, 3)
    conv_w('update_block.flow_head.conv2', 2, 256, 3, 3)
    conv_w('update_block.mask.0', 256, 128, 3, 3)
    conv_w('update_block.mask.2', 64 * 9, 256, 1, 1)
    return sd
