"""A depthwise convolution in plain fp32 FMAs: a CUDA kernel, its plain
PyTorch version and the tile plan between them.

On the TPU the JAX package leaves the timm CNNs' depthwise convolutions
(ConvNeXt's 7×7; EfficientNet's and MobileNetV3's 3×3 and 5×5, stride 1
and 2) to XLA as ``feature_group_count=C`` convolutions
(``video_features_tpu/ops/nn.py:71-79``), under ``precision=mixed`` and
``high`` at the ambient ``high``. With one input channel per group a
GEMM's K is only the taps, so the tensor cores are the wrong tool
(``ops/conv_tf32x3.py``'s grouped mode would do 8× the products in its
narrowest tile, three times over): under those two lanes the clip and timm
families send every convolution with one input and one output channel per
group here (``ops/nn.py::conv`` inside ``conv_route``). Exact fp32
products and fp32 sums: fp32-class, closer to the reference than 3xTF32.
It replaces no Pallas kernel: XLA did this arithmetic on the TPU.

Kernel (``csrc/dwconv_f32.cu``, CUDA C++ for sm_90a): channels-last ``(N,
H, W, C)``, weight ``(C, 1, kh, kw)`` with kw ≤ 7, a stride (1 or 2 along
W) and a zero padding per edge on each axis, an optional bias; each output
the sum of its taps in row-major order by ``fmaf``, then the bias.
A block stages its input patch and taps in shared memory once (16-byte
copies along C); each thread then computes a strip of :data:`STRIP`
adjacent output columns for 4 channels, reading each tap row's taps and
input row once into registers and reusing them across the taps and the
strip. The taps are read tap-major (:func:`pack_taps`),
packed once for the weight's life (``ops/weight_packs.py``;
``dwconv_f32.packs`` counts the packs made). :func:`dw_plan` shapes each
call's blocks to its map. Bound by bytes: the input, the output and the
weights once, at 3.35 TB/s.

The wrapper launches the kernel on a CUDA tensor (or raises) and takes the
plain version (``ops/nn.py::library_conv`` with ``groups=C``) only for a
CPU tensor; ``dwconv_f32.launches`` counts one per launch.
:func:`dwconv_f32_staged` launches the kernel's earlier design
(``csrc/dwconv_f32_staged.cu``), a yardstick on no path whose bytes the
kernel's equal.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from video_features_torch.ops.nn import (
    IntOrTuple, Padding, _pad_pairs, _tuple, library_conv,
)

STRIP = 7                # output columns per thread: csrc/dwconv_f32.cu::kStrip
MAX_KW = 7               # the widest kernel row the kernel takes
THREADS = 256            # the most threads a block takes
SMS = 132                # streaming multiprocessors of an H100 SXM
STAGED_TILE = (8, 16, 32)   # the staged yardstick's block: rows, columns, channels
SMEM_OPTIN = 232448      # the most shared memory a block may ask for on an H100


SMEM_BUDGET = 113 * 1024  # a block's patch and taps: two blocks an SM


class DwPlan(NamedTuple):
    """One call's blocks: ``cg`` channel groups of 4 by ``rows`` output
    rows by each of a row's ``strips`` strips of :data:`STRIP` columns;
    ``blocks`` of them in all, each staging ``smem`` bytes of input patch
    and taps."""
    cg: int
    rows: int
    strips: int
    blocks: int
    smem: int


def is_depthwise(x: torch.Tensor, weight: torch.Tensor, groups: int) -> bool:
    """Whether a convolution has one input and one output channel per
    group: a 2-D ``(N, H, W, C)`` input, ``weight`` ``(C, 1, kh, kw)``,
    ``groups`` = C > 1."""
    return (weight.ndim == 4 and x.ndim == 4 and groups > 1
            and weight.shape[1] == 1 and weight.shape[0] == groups
            and x.shape[-1] == groups)


def patch_bytes(rows: int, cg: int, strips: int, kh: int, kw: int,
                sh: int, sw: int) -> int:
    """A block's shared memory: its input patch, ``(rows - 1)·sh + kh``
    input rows of ``(strips·7 - 1)·sw + kw`` columns, and its taps, each
    ``cg`` float4s of channels (``csrc/dwconv_f32.cu``)."""
    pr = (rows - 1) * sh + kh
    pc = (strips * STRIP - 1) * sw + kw
    return (pr * pc + kh * kw) * cg * 16


@functools.lru_cache(maxsize=1024)
def dw_plan(n: int, oh: int, ow: int, c: int, kh: int = 7, kw: int = 7,
            sh: int = 1, sw: int = 1, sms: int = SMS) -> DwPlan:
    """The blocks of a call with an ``(n, oh, ow, c)`` output and a
    ``kh × kw`` kernel at strides ``(sh, sw)``; every block takes whole
    output rows. A map of 14 or fewer rows takes the whole map per block
    (its patch staged once, no halo read twice) and then halves its
    channel groups, from 32, until the blocks number at least twice the
    SMs (ConvNeXt-T's 7×7 map at batch 8: 4 groups, 16 channels, a
    block). A wider map takes up to 8 groups and as many rows as
    :data:`THREADS` threads hold, so that its rows share their staged
    input rows, and halves its rows for the same count. Then rows, and
    last channel groups, halve until the patch fits
    :data:`SMEM_BUDGET`."""
    groups = -(-c // 4)
    strips = -(-ow // STRIP)
    small = oh <= 14
    if small:
        rows = oh
        cg = max(1, min(groups, 32, THREADS // (rows * strips)))
    else:
        cg = max(1, min(groups, 8, THREADS // strips))
        rows = max(1, min(oh, THREADS // (cg * strips)))

    def blocks() -> int:
        return n * -(-oh // rows) * -(-groups // cg)

    def smem() -> int:
        return patch_bytes(rows, cg, strips, kh, kw, sh, sw)
    while blocks() < 2 * sms:
        if small and cg > 1:
            cg = -(-cg // 2)
        elif not small and rows > 1:
            rows = -(-rows // 2)
        else:
            break
    while smem() > SMEM_BUDGET and (rows > 1 or cg > 1):
        if rows > 1:
            rows = -(-rows // 2)
        else:
            cg = -(-cg // 2)
    return DwPlan(cg, rows, strips, blocks(), smem())


def smem_bytes(kh: int, kw: int, sh: int, sw: int) -> int:
    """The staged yardstick's shared memory a block: its input patch,
    ``(8 - 1)·sh + kh`` rows of ``(16 - 1)·sw + kw`` pixels of 32
    channels, and its taps."""
    rows, cols, channels = STAGED_TILE
    return ((rows - 1) * sh + kh) * ((cols - 1) * sw + kw) * channels * 4 \
        + kh * kw * channels * 4


def pack_taps(weight: torch.Tensor) -> torch.Tensor:
    """``(C, 1, kh, kw)`` → the kernel's taps ``(kh·kw, 4·⌈C/4⌉)``:
    tap-major, a tap's channels contiguous (zeros past C), so that one
    16-byte load takes a tap of 4 channels."""
    c = weight.shape[0]
    taps = weight.reshape(c, -1).t()
    return torch.nn.functional.pad(taps, (0, -(-c // 4) * 4 - c)).contiguous()


def dwconv_f32_plain(x: torch.Tensor, weight: torch.Tensor,
                     stride: IntOrTuple = 1, padding: Padding = 0,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dwconv_f32`: ``library_conv`` with
    ``groups=C`` in fp32."""
    return library_conv(x, weight, stride, padding, bias, weight.shape[0])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('dwconv_f32')
    lib.vft_dwconv_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                                   + [ctypes.c_void_p])
    lib.vft_dwconv_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _staged_library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('dwconv_f32_staged')
    lib.vft_dwconv_f32_staged.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 12
                                          + [ctypes.c_void_p])
    lib.vft_dwconv_f32_staged.restype = ctypes.c_int
    return lib


def _out_hw(x, weight, strides, pairs) -> Tuple[int, int]:
    return tuple((x.shape[1 + i] + lo + hi - weight.shape[2 + i]) // s + 1
                 for i, ((lo, hi), s) in enumerate(zip(pairs, strides)))


def _check(x, weight, stride, padding, bias) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    if not is_depthwise(x, weight, weight.shape[0] if weight.ndim == 4 else 0):
        raise ValueError(f'a depthwise convolution takes an (N, H, W, C) input '
                         f'and a (C, 1, kh, kw) weight; got x '
                         f'{tuple(x.shape)}, weight {tuple(weight.shape)}')
    tensors = {'x': x, 'weight': weight}
    if bias is not None:
        if tuple(bias.shape) != (weight.shape[0],):
            raise ValueError(f'bias must be ({weight.shape[0]},); got '
                             f'{tuple(bias.shape)}')
        tensors['bias'] = bias
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(
                f'{name} must be a contiguous float32 tensor on {x.device}; '
                f'got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}')
    strides = _tuple(stride, 2)
    pairs = _pad_pairs(padding, 2)
    if len(pairs) != 2 or any(s < 1 for s in strides) \
            or any(lo < 0 or hi < 0 for lo, hi in pairs):
        raise ValueError(f'strides >= 1 and pads >= 0, one per spatial axis; '
                         f'got stride {stride!r}, padding {padding!r}')
    if any(o < 1 for o in _out_hw(x, weight, strides, pairs)):
        raise ValueError(f'empty output for input {tuple(x.shape)} and weight '
                         f'{tuple(weight.shape)}')
    if weight.shape[3] > MAX_KW or strides[1] > 2:
        raise ValueError(f'the depthwise kernel takes kernel rows of at most '
                         f'{MAX_KW} taps and a stride of 1 or 2 along W; got '
                         f'{tuple(weight.shape[2:])} at stride {strides}')
    if x.shape[0] > 65535:
        raise ValueError(f'at most 65535 images a call; got {x.shape[0]}')


def dwconv_f32(x: torch.Tensor, weight: torch.Tensor, stride: IntOrTuple = 1,
               padding: Padding = 0,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The depthwise convolution of channels-last ``x`` ``(N, H, W, C)``
    with ``weight`` ``(C, 1, kh, kw)`` in fp32 FMAs.

    CUDA tensors launch ``vft_dwconv_f32`` (through ``vft::dwconv_f32``
    while ``torch.export`` traces: :func:`export_op`); CPU tensors run
    :func:`dwconv_f32_plain`.
    """
    exporting = torch.compiler.is_exporting()
    if exporting:
        x, weight = x.contiguous(), weight.contiguous()
        bias = None if bias is None else bias.contiguous()
    _check(x, weight, stride, padding, bias)
    if x.device.type == 'cpu':
        return dwconv_f32_plain(x, weight, stride, padding, bias)
    strides = list(_tuple(stride, 2))
    pads = [p for pair in _pad_pairs(padding, 2) for p in pair]
    if exporting:
        return export_op()(x, weight, bias, strides, pads)
    return _launch(x, weight, bias, strides, pads)


def _launch(x, weight, bias, strides: Sequence[int], pads: Sequence[int]):
    pairs = list(zip(pads[0::2], pads[1::2]))
    oh, ow = _out_hw(x, weight, strides, pairs)
    n, h, w, c = x.shape
    from video_features_torch.ops import weight_packs
    from video_features_torch.ops._kernels import current_stream, sms
    index = x.device.index
    plan = dw_plan(n, oh, ow, c, *weight.shape[2:], *strides, sms(index))
    taps, made = weight_packs.packed(weight, ('dwconv_f32',), pack_taps)
    if made:
        dwconv_f32.packs += 1
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), taps.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, w, c, oh, ow, weight.shape[2], weight.shape[3],
            strides[0], strides[1], pairs[0][0], pairs[1][0], plan.cg,
            plan.rows, index)
    if index == torch.cuda.current_device():
        rc = _library().vft_dwconv_f32(*args, current_stream(index))
    else:
        with torch.cuda.device(index):
            rc = _library().vft_dwconv_f32(*args, current_stream(index))
    if rc != 0:
        raise RuntimeError(f'vft_dwconv_f32 failed to launch: CUDA error {rc}')
    dwconv_f32.launches += 1
    return y


dwconv_f32.launches = 0
dwconv_f32.packs = 0


def dwconv_f32_staged(x: torch.Tensor, weight: torch.Tensor,
                      stride: IntOrTuple = 1, padding: Padding = 0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's earlier design (``csrc/dwconv_f32_staged.cu``: 8 rows
    × 16 columns × 32 channels a block, the input patch and taps in shared
    memory), the same function on CUDA tensors: a yardstick that
    ``chip_smoke.py`` and the card's tests time and hold the kernel's
    bytes to, on no path. Counted in its own ``launches``."""
    _check(x, weight, stride, padding, bias)
    if x.device.type != 'cuda':
        raise ValueError('the staged yardstick runs on CUDA tensors only')
    strides = _tuple(stride, 2)
    if smem_bytes(*weight.shape[2:], *strides) > SMEM_OPTIN:
        raise ValueError(f'a {tuple(weight.shape[2:])} depthwise kernel at '
                         f'stride {strides} needs more shared memory a block '
                         f'than the card has')
    pairs = _pad_pairs(padding, 2)
    oh, ow = _out_hw(x, weight, strides, pairs)
    n, h, w, c = x.shape
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _staged_library().vft_dwconv_f32_staged(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, w, c, oh, ow, weight.shape[2], weight.shape[3],
            strides[0], strides[1], pairs[0][0], pairs[1][0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'vft_dwconv_f32_staged failed to launch: CUDA '
                           f'error {rc}')
    dwconv_f32_staged.launches += 1
    return y


dwconv_f32_staged.launches = 0


@functools.lru_cache(maxsize=None)
def export_op():
    """The convolution as the ``torch.library`` op ``vft::dwconv_f32``,
    registered on first use: its CUDA implementation launches the kernel
    (counted in ``launches``), its fake implementation gives the output's
    shape. ``padding`` is the (lo, hi) pairs flattened."""
    @torch.library.custom_op('vft::dwconv_f32', mutates_args=(),
                             device_types='cuda')
    def dwconv_f32_op(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], stride: List[int],
                      padding: List[int]) -> torch.Tensor:
        pairs = list(zip(padding[0::2], padding[1::2]))
        _check(x, weight, stride, pairs, bias)
        return _launch(x, weight, bias, stride, padding)

    def fake(x, weight, bias, stride, padding):
        pairs = list(zip(padding[0::2], padding[1::2]))
        oh, ow = _out_hw(x, weight, stride, pairs)
        return x.new_empty((x.shape[0], oh, ow, x.shape[-1]))

    dwconv_f32_op.register_fake(fake)
    return dwconv_f32_op
