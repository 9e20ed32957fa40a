"""A convolution in 3xTF32 on the tensor cores: a CUDA kernel, its plain
PyTorch version, the weight pack and the tile plan between them.

On the TPU the JAX package runs every convolution of every family with
the ambient matmul precision of its lane, and ``precision=mixed`` and
``high`` mean three bf16 products per fp32 product there
(``video_features_tpu/extract/base.py:177``). cuDNN and cuBLAS have no
three-pass mode, so under those two lanes the i3d, raft, r21d, s3d,
resnet and vggish families send every convolution here instead
(``utils/device.py::three_pass_convs``, ``ops/nn.py::conv_route``),
with the libraries' TF32 off for what stays in them.

Kernel (``csrc/conv_tf32x3.cu``, CUDA C++ for sm_90a,
``conv_tf32x3_wgmma<WGS, BN>``): an implicit-GEMM convolution,
channels-last, 2-D ``(N, H, W, C)`` or 3-D ``(N, T, H, W, C)``, a stride
and a zero padding per edge for each spatial axis (I3D's TF-SAME pads are
asymmetric, so no ``pad_spatial`` copy is made), ``groups`` ≥ 1
(ResNeXt's grouped 3×3), an optional bias, fp32 in and out. Each operand
splits into hi = tf32(x) and lo = tf32(x - hi)
(:func:`~video_features_torch.ops.gru.tf32_split`,
``cvt.rna.tf32.f32``) and every 32-K chunk accumulates lo·hi + hi·lo +
hi·hi on ``wgmma`` into a fresh accumulator that is then added to the
running sum in fp32: fp32-class results. It replaces no Pallas kernel:
XLA did this arithmetic on the TPU. Bound by operations at the path's
shapes (the source's note gives the design).

K order: the taps (row-major over ``*k``) and, inside each tap, the
input channels padded to a multiple of :data:`C_GROUP` (4), so every
16-byte copy of an input row is 4 channels of one tap and a 32-K chunk
may span taps. An input whose channels are not a multiple of 4 (2 or 3:
the stems and RAFT's flow input; 45, 230 and 921: R(2+1)D's midplanes; 1:
VGGish's log-mel) is padded by the wrapper, one copy.

Groups (``groups`` = G > 1, the weight ``(O, I/G, *k)``): an output tile
covers whole groups, or lies inside one (:func:`channel_tiles`), and its
K reads only the input channels of the groups it covers
(:func:`tile_inputs`, from the tile's first group on); its packed weight
is the tile's block diagonal, zeros off the blocks. The products wasted
are the tile's groups, ``bn / (O/G)``: 2× at ResNeXt's 4 channels per
group on the narrowest tile of 8, none from 8 on. A grouped geometry
no tile fits (one whose tile would read a channel count that is not a
multiple of 4) raises.

:func:`pack_weight` turns torch's ``(O, I, *k)`` into
the kernel's operand, hi and lo already split, K-major in the 128-byte
swizzle ``wgmma`` reads; :func:`conv_plan` picks the tile (pixels ×
output channels) for a call. A weight used by many calls (RAFT's seven
per-iteration convolutions) is packed once per forward
(:func:`prepack`, through ``ops/nn.py::route_weight``); a bare weight is
packed at the call.

The wrapper launches the kernel on a CUDA tensor (or raises) and takes
the plain version only for a CPU tensor; ``conv_tf32x3.launches``
counts one per launch, and ``grouped_launches`` those with ``groups`` >
1. :func:`conv_tf32x3_mma` launches the kernel's
earlier ``mma.sync`` design (``vft_conv_tf32x3_mma``, its own pack
:func:`pack_weight_mma`): a yardstick that ``chip_smoke.py`` and the
card's tests time and hold beside the kernel, on no path.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from video_features_torch.ops.gru import K_ORDER, _swizzle, tf32_split
from video_features_torch.ops.nn import (
    IntOrTuple, Padding, _pad_pairs, _tuple, library_conv,
)

K_CHUNK = 32        # K per staged chunk: one 128-byte row of a weight tile
C_GROUP = 4         # input channels per 16-byte copy; each tap's are padded to it
# output channels per tile: the kernel's template widths (wgmma's N)
TILE_WIDTHS = (8, 16, 24, 32, 48, 64, 72, 80, 96, 104, 112, 128)
SMS = 132                # streaming multiprocessors of an H100 SXM


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


class Plan(NamedTuple):
    """One call's tiling: ``bm`` output pixels by ``bn`` output channels
    per block, ``tiles`` blocks along the output channels."""
    bm: int
    bn: int
    tiles: int


def channel_tiles(o: int, groups: int = 1,
                  ig: Optional[int] = None) -> Tuple[int, int]:
    """``(bn, tiles)``: ``o`` output channels as equal tiles of a
    :data:`TILE_WIDTHS` width. One group: the fewest tiles that can hold
    them or one more, whichever pads fewer channels (ties to fewer tiles):
    2 → one of 8, 192 → 2 × 96, 576 → 6 × 96, 126 → one of 128.
    ``groups`` > 1 (``ig`` input channels per group): tiles that cover
    whole groups, or lie inside one, with no pad and a 4-aligned input
    span (:func:`tile_inputs`), the fewest wasted products first (a tile
    over k groups does k times a group's), then the widest: 4 channels
    per group → 8, 8 → 8, 16 → 16, 64 → 64, 256 → 128."""
    if o < 1:
        raise ValueError(f'output channels must be >= 1; got {o}')
    if groups == 1:
        first = -(-o // TILE_WIDTHS[-1])
        best = None
        for tiles in (first, first + 1):
            bn = next(w for w in TILE_WIDTHS if w >= -(-o // tiles))
            if best is None or tiles * bn < best[0] * best[1]:
                best = (bn, tiles)
        return best
    og = o // groups
    fits = []
    for bn in TILE_WIDTHS:
        span = bn // og if bn % og == 0 else 1
        if (bn % og == 0 and groups % span == 0) or og % bn == 0:
            if tile_inputs(ig, o, groups, bn) % C_GROUP == 0:
                fits.append((span, -bn))
    if not fits:
        raise ValueError(
            f'no tile of the 3xTF32 convolution fits groups={groups} with '
            f'{ig} input and {og} output channels per group: a tile covers '
            f'whole groups or lies inside one, and reads a multiple of '
            f'{C_GROUP} input channels')
    bn = -min(fits)[1]
    return bn, o // bn


def tile_inputs(ig: int, o: int, groups: int, bn: int) -> int:
    """The input channels one output tile of width ``bn`` reads per tap:
    every channel, padded to :data:`C_GROUP`, for one group; those of the
    groups the tile covers (one group's where it lies inside one) for
    ``groups`` > 1."""
    if groups == 1:
        return _round_up(ig, C_GROUP)
    og = o // groups
    return ig * (bn // og if bn % og == 0 else 1)


def conv_plan(m: int, o: int, sms: int = SMS, groups: int = 1,
              ig: Optional[int] = None) -> Plan:
    """The tile of a call with ``m`` output pixels and ``o`` output
    channels (``groups`` of ``ig`` input channels each):
    :func:`channel_tiles` along the channels; 128 pixels per block, or 64
    where 128 would leave fewer blocks than the card has SMs (RAFT's
    per-iteration convolutions at 8 pairs, M = 10,752)."""
    bn, tiles = channel_tiles(o, groups, ig)
    bm = 128 if -(-m // 128) * tiles >= sms else 64
    return Plan(bm, bn, tiles)


def k_chunks(channels: int, taps: int) -> int:
    """K chunks of 32 for ``taps`` taps of ``channels`` input channels,
    each tap's channels padded to :data:`C_GROUP`."""
    return -(-taps * _round_up(channels, C_GROUP) // K_CHUNK)


def packed_shape(weight_shape: Sequence[int], groups: int = 1,
                 bn: Optional[int] = None) -> Tuple[int, ...]:
    """:func:`pack_weight`'s shape for an ``(O, I/groups, *k)`` weight:
    (tiles, chunks, 2 (hi, lo), bn, 32); ``bn`` a given tile width (one
    group: the 3xTF32 GEMM's weights) or :func:`channel_tiles`'."""
    O, ig = weight_shape[:2]
    if bn is None:
        bn, tiles = channel_tiles(O, groups, ig)
    elif groups != 1:
        raise ValueError(f'a given tile width takes one group; got {groups}')
    else:
        tiles = -(-O // bn)
    cin = tile_inputs(ig, O, groups, bn)
    return (tiles, k_chunks(cin, math.prod(weight_shape[2:])), 2, bn,
            K_CHUNK)


def _group_slots(o: int, ig: int, groups: int,
                 bn: int) -> Tuple[int, torch.Tensor]:
    """``(span, slot)``: the groups a tile's K covers, and for each output
    channel the position of its group among them (0 for one group)."""
    span = tile_inputs(ig, o, groups, bn) // ig if groups > 1 else 1
    return span, (torch.arange(o) // (o // groups)) % span


def pack_weight(weight: torch.Tensor, groups: int = 1,
                bn: Optional[int] = None) -> torch.Tensor:
    """``(O, I/groups, *k)`` → the kernel's operand ``(tiles, chunks, 2,
    bn, 32)``: the GEMM's B matrix (K = taps × the tile's input channels,
    padded to 4 per tap, then to a multiple of 32; O padded to ``tiles ×
    bn``, zeros in every pad; for ``groups`` > 1 each tile's block
    diagonal, an output channel's weights at its group's channels and
    zeros at the other groups' of the tile) cut into one (bn × 32) tile
    per output tile and K chunk, split into TF32 hi and lo parts
    (:func:`~video_features_torch.ops.gru.tf32_split`), each row's 32 K
    values in the kernel's fragment order (``ops/gru.py::K_ORDER``) and
    stored in the 128-byte swizzle (``ops/gru.py::_swizzle``). A tile's
    hi and lo parts are contiguous, one bulk copy per ring stage. ``bn``:
    a given tile width (:func:`packed_shape`)."""
    O, ig = weight.shape[:2]
    taps = math.prod(weight.shape[2:])
    tiles, chunks, _, bn, _ = packed_shape(weight.shape, groups, bn)
    c4 = tile_inputs(ig, O, groups, bn)
    w = weight.reshape(O, ig, taps).transpose(1, 2)              # (O, taps, I/G)
    if groups > 1:
        span, slot = _group_slots(O, ig, groups, bn)
        own = (slot[:, None] == torch.arange(span)).to(w.device)
        w = torch.where(own[:, None, :, None], w[:, :, None, :],
                        w.new_zeros(())).reshape(O, taps, span * ig)
    w = F.pad(w, (0, c4 - w.shape[-1])).reshape(O, taps * c4)
    w = F.pad(w, (0, chunks * K_CHUNK - taps * c4, 0, tiles * bn - O))
    w = w.reshape(tiles, bn, chunks, K_CHUNK).transpose(1, 2).contiguous()
    parts = torch.stack(tf32_split(w), dim=2)                    # (t, q, 2, bn, 32)
    return torch.gather(parts, -1, _pack_index(bn, parts.device).expand(
        parts.shape))


def _pack_index_of(bn: int, device: torch.device) -> torch.Tensor:
    """(bn, 32): the natural K position that packed position c of row r
    holds, the fragment order (``K_ORDER``) under the 128-byte swizzle
    (16-byte chunk j of row r stored at j ^ (r % 8)): one gather packs a
    tile, with no index built per call."""
    rows = torch.arange(bn)[:, None] % 8
    cols = torch.arange(K_CHUNK)[None, :]
    pos = ((cols // 4) ^ rows) * 4 + cols % 4
    return torch.tensor(K_ORDER)[pos].to(device)


_pack_index_cached = functools.lru_cache(maxsize=None)(_pack_index_of)


def _pack_index(bn: int, device: torch.device) -> torch.Tensor:
    # made anew while torch.export traces (its tensors are the tracer's)
    if torch.compiler.is_exporting():
        return _pack_index_of(bn, device)
    return _pack_index_cached(bn, device)


def unpack_matrix(packed: torch.Tensor) -> torch.Tensor:
    """A :func:`pack_weight` tensor → the GEMM's B matrix it holds, hi +
    lo: ``(chunks × 32, tiles × bn)``, K in the kernel's order."""
    tiles, chunks, _, bn, _ = packed.shape
    inverse = sorted(range(K_CHUNK), key=K_ORDER.__getitem__)
    parts = _swizzle(packed)[..., inverse]
    w = parts[:, :, 0] + parts[:, :, 1]                          # (t, q, bn, 32)
    return w.permute(1, 3, 0, 2).reshape(chunks * K_CHUNK, tiles * bn)


def unpack_weight(packed: torch.Tensor, weight_shape: Sequence[int],
                  groups: int = 1) -> torch.Tensor:
    """The inverse of :func:`pack_weight`: the ``(O, I/groups, *k)``
    weight its parts hold, hi + lo (each output channel's from its
    group's block)."""
    O, ig = weight_shape[:2]
    taps = math.prod(weight_shape[2:])
    bn = packed.shape[3]
    c4 = tile_inputs(ig, O, groups, bn)
    span, slot = _group_slots(O, ig, groups, bn)
    m = unpack_matrix(packed)[:taps * c4, :O].reshape(taps, c4, O)
    m = m[:, :span * ig].reshape(taps, span, ig, O)
    m = m[:, slot.to(m.device), :, torch.arange(O, device=m.device)]
    return m.permute(0, 2, 1).reshape(tuple(weight_shape))   # (O, I/G, taps)


class PackedWeight(NamedTuple):
    """A weight packed once for several calls: ``weight`` ``(O, I, *k)``
    for the plain version, ``packed`` (:func:`pack_weight`) for the
    kernel."""
    weight: torch.Tensor
    packed: torch.Tensor


def prepack(weight: torch.Tensor) -> PackedWeight:
    return PackedWeight(weight, pack_weight(weight))


def _out_extent(x: torch.Tensor, weight: torch.Tensor, stride,
                padding) -> Tuple[int, ...]:
    """The output's spatial extent, one entry per spatial axis."""
    n = weight.ndim - 2
    return tuple((x.shape[1 + i] + lo + hi - weight.shape[2 + i]) // s + 1
                 for i, ((lo, hi), s) in enumerate(zip(_pad_pairs(padding, n),
                                                       _tuple(stride, n))))


def conv_tf32x3_plain(x: torch.Tensor, weight: torch.Tensor,
                      stride: IntOrTuple = 1, padding: Padding = 0,
                      bias: Optional[torch.Tensor] = None,
                      groups: int = 1) -> torch.Tensor:
    """Plain version of :func:`conv_tf32x3`: ``ops/nn.py::library_conv``
    in fp32 (true fp32 on the card where the caller's scope keeps cuDNN's
    TF32 off, as the three-pass lane's does)."""
    return library_conv(x, weight, stride, padding, bias, groups)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('conv_tf32x3')
    lib.vft_conv_tf32x3.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 25
                                    + [ctypes.c_void_p])
    lib.vft_conv_tf32x3.restype = ctypes.c_int
    lib.vft_conv_tf32x3_mma.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 21
                                        + [ctypes.c_void_p])
    lib.vft_conv_tf32x3_mma.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, weight, stride, padding, bias, packed=None,
           groups: int = 1) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    if weight.ndim not in (4, 5) or x.ndim != weight.ndim:
        raise ValueError(f'a 2-D (N, H, W, C) or 3-D (N, T, H, W, C) input '
                         f'with an (O, I, *k) weight of as many spatial '
                         f'axes; got x {tuple(x.shape)}, weight '
                         f'{tuple(weight.shape)}')
    if not isinstance(groups, int) or groups < 1 or weight.shape[0] % groups \
            or x.shape[-1] != weight.shape[1] * groups:
        raise ValueError(f'groups={groups} must divide the input\'s and the '
                         f'output\'s channels: the input has {x.shape[-1]} '
                         f'channels, the weight {weight.shape[0]} outputs and '
                         f'{weight.shape[1]} inputs per group')
    channel_tiles(weight.shape[0], groups, weight.shape[1])
    tensors = {'x': x, 'weight': weight}
    if bias is not None:
        if tuple(bias.shape) != (weight.shape[0],):
            raise ValueError(f'bias must be ({weight.shape[0]},); got '
                             f'{tuple(bias.shape)}')
        tensors['bias'] = bias
    if packed is not None:
        want = packed_shape(weight.shape, groups)
        if tuple(packed.shape) != want:
            raise ValueError(f'packed weight must be {want} for weight '
                             f'{tuple(weight.shape)}; got '
                             f'{tuple(packed.shape)}')
        tensors['packed weight'] = packed
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(
                f'{name} must be a contiguous float32 tensor on {x.device}; '
                f'got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}')
    n = weight.ndim - 2
    strides = _tuple(stride, n)
    pairs = _pad_pairs(padding, n)
    if len(pairs) != n or any(s < 1 for s in strides) \
            or any(lo < 0 or hi < 0 for lo, hi in pairs):
        raise ValueError(f'strides >= 1 and pads >= 0, one per spatial axis; '
                         f'got stride {stride!r}, padding {padding!r}')
    out = _out_extent(x, weight, strides, pairs)
    if any(o < 1 for o in out):
        raise ValueError(f'empty output {out} for input {tuple(x.shape)} and '
                         f'weight {tuple(weight.shape)}')


def conv_tf32x3(x: torch.Tensor, weight, stride: IntOrTuple = 1,
                padding: Padding = 0, bias: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """The convolution of channels-last ``x`` with ``weight`` ``(O,
    I/groups, *k)`` or a :class:`PackedWeight` of it (``ops/nn.py::conv``'s
    arguments) in 3xTF32.

    CUDA tensors launch ``vft_conv_tf32x3`` (through ``vft::conv_tf32x3``
    while ``torch.export`` traces, one node per convolution:
    :func:`export_op`), a bare weight packed at the call; CPU tensors run
    :func:`conv_tf32x3_plain` on the weight.
    """
    packed = None
    if isinstance(weight, PackedWeight):
        weight, packed = weight
    exporting = torch.compiler.is_exporting()
    if exporting:
        # a trace's layouts are its tracer's: the op takes its inputs
        # contiguous, as the kernel does (a no-op where they are)
        x, weight = x.contiguous(), weight.contiguous()
        bias = None if bias is None else bias.contiguous()
        packed = None if packed is None else packed.contiguous()
    _check(x, weight, stride, padding, bias, packed, groups)
    if x.device.type == 'cpu':
        return conv_tf32x3_plain(x, weight, stride, padding, bias, groups)
    n = weight.ndim - 2
    strides = list(_tuple(stride, n))
    pads = [p for pair in _pad_pairs(padding, n) for p in pair]
    if exporting:          # a CUDA tensor: the op that launches the kernel
        return export_op()(x, weight, packed, bias, strides, pads, groups)
    return _launch(x, weight, packed, bias, strides, pads, groups)


def _geometry(x, weight, strides: Sequence[int], pads: Sequence[int]):
    """The kernels' integer arguments after the input's channel count:
    (ot, oh, ow, o, kt, kh, kw, st, sh, sw, pt, ph, pw) and the input's
    (t, h, w); a 2-D call is one time step with one temporal tap."""
    pairs = list(zip(pads[0::2], pads[1::2]))
    out = _out_extent(x, weight, strides, pairs)
    if x.ndim == 4:
        t, (h, w), (ot, oh, ow) = 1, x.shape[1:3], (1, *out)
        (kt, kh, kw), (st, sh, sw) = (1, *weight.shape[2:]), (1, *strides)
        pt, ph, pw = 0, pairs[0][0], pairs[1][0]
    else:
        (t, h, w), (ot, oh, ow) = x.shape[1:4], out
        (kt, kh, kw), (st, sh, sw) = weight.shape[2:], strides
        pt, ph, pw = (p[0] for p in pairs)
    return out, (t, h, w), (ot, oh, ow, weight.shape[0], kt, kh, kw, st, sh,
                            sw, pt, ph, pw)


def _launch(x, weight, packed, bias, strides: Sequence[int],
            pads: Sequence[int], groups: int = 1):
    out, (t, h, w), geo = _geometry(x, weight, strides, pads)
    o, ig = weight.shape[:2]
    if packed is None:
        packed = pack_weight(weight, groups)
    c4 = _round_up(x.shape[-1], C_GROUP)
    if c4 != x.shape[-1]:  # 16-byte input rows: one copy of a narrow input
        x = F.pad(x, (0, c4 - x.shape[-1]))
    plan = conv_plan(x.shape[0] * math.prod(out), o, _sms(x.device.index),
                     groups, ig)
    cin = tile_inputs(ig, o, groups, plan.bn)
    if groups == 1:        # one group: every (padded) channel
        ig, og = c4, o
    else:
        og = o // groups
    y = torch.empty((x.shape[0], *out, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_conv_tf32x3(
            x.data_ptr(), packed.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.shape[0], t, h, w, c4, *geo, cin, ig, og, plan.bm, plan.bn,
            plan.tiles, packed.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f'vft_conv_tf32x3 failed to launch: CUDA error {rc}')
    conv_tf32x3.launches += 1
    if groups > 1:
        conv_tf32x3.grouped_launches += 1
    return y


conv_tf32x3.launches = 0
# of them, the grouped convolutions'
conv_tf32x3.grouped_launches = 0


@functools.lru_cache(maxsize=None)
def export_op():
    """The convolution as the ``torch.library`` op ``vft::conv_tf32x3``,
    registered on first use: its CUDA implementation launches the kernel
    (counted in ``launches``; a weight packed in the graph, or packed at
    the launch where ``packed`` is None), its fake implementation gives
    the output's shape. ``padding`` is the (lo, hi) pairs flattened."""
    @torch.library.custom_op('vft::conv_tf32x3', mutates_args=(),
                             device_types='cuda')
    def conv_tf32x3_op(x: torch.Tensor, weight: torch.Tensor,
                       packed: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], stride: List[int],
                       padding: List[int], groups: int = 1) -> torch.Tensor:
        pairs = list(zip(padding[0::2], padding[1::2]))
        _check(x, weight, stride, pairs, bias, packed, groups)
        return _launch(x, weight, packed, bias, stride, padding, groups)

    def fake(x, weight, packed, bias, stride, padding, groups=1):
        pairs = list(zip(padding[0::2], padding[1::2]))
        out = _out_extent(x, weight, stride, pairs)
        return x.new_empty((x.shape[0], *out, weight.shape[0]))

    conv_tf32x3_op.register_fake(fake)
    return conv_tf32x3_op


# -- the mma.sync yardstick ---------------------------------------------------

MMA_O_PAD = 128     # output channels of the yardstick's matrix: a multiple of this


def pack_weight_mma(weight: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The yardstick's operand: ``(O, I, *k)`` → a ``(K_pad, O_pad)``
    row-major fp32 matrix and its K per tap ``c_pad``. K runs over the
    taps (row-major over ``*k``) and, in each tap, over the input
    channels: padded to a multiple of 32 per tap where ``I % 4 == 0``,
    unpadded otherwise; the whole K is padded to a multiple of 32 and O
    to a multiple of 128 with zeros."""
    O, I = weight.shape[:2]
    taps = math.prod(weight.shape[2:])
    w = weight.reshape(O, I, taps).permute(2, 1, 0)          # (taps, I, O)
    c_pad = _round_up(I, K_CHUNK) if I % 4 == 0 else I
    w = F.pad(w, (0, 0, 0, c_pad - I)).reshape(taps * c_pad, O)
    k = taps * c_pad
    return (F.pad(w, (0, _round_up(O, MMA_O_PAD) - O, 0,
                      _round_up(k, K_CHUNK) - k)).contiguous(), c_pad)


def conv_tf32x3_mma(x: torch.Tensor, weight: torch.Tensor,
                    stride: IntOrTuple = 1, padding: Padding = 0,
                    bias: Optional[torch.Tensor] = None,
                    packed: Optional[Tuple[torch.Tensor, int]] = None
                    ) -> torch.Tensor:
    """The same convolution through the ``mma.sync`` design
    (``vft_conv_tf32x3_mma``): CUDA tensors only, not counted in
    ``conv_tf32x3.launches``. ``packed`` is :func:`pack_weight_mma`'s
    pair, made at the call where None."""
    _check(x, weight, stride, padding, bias)
    if x.device.type != 'cuda':
        raise ValueError(f'the mma.sync yardstick runs on the card only; got '
                         f'{x.device}')
    n = weight.ndim - 2
    pads = [p for pair in _pad_pairs(padding, n) for p in pair]
    out, (t, h, w), geo = _geometry(x, weight, list(_tuple(stride, n)), pads)
    matrix, c_pad = pack_weight_mma(weight) if packed is None else packed
    y = torch.empty((x.shape[0], *out, weight.shape[0]), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_conv_tf32x3_mma(
            x.data_ptr(), matrix.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.shape[0], t, h, w, x.shape[-1], *geo, c_pad, matrix.shape[0],
            matrix.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f'vft_conv_tf32x3_mma failed to launch: CUDA '
                           f'error {rc}')
    return y
