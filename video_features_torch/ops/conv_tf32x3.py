"""A convolution in 3xTF32 on the tensor cores: a CUDA kernel, its plain
PyTorch version and the weight pack between them.

On the TPU the JAX package runs every convolution of the fused RAFT →
I3D step and of the RAFT step with the ambient matmul precision of its
lane, and ``precision=mixed`` and ``high`` mean three bf16 products per
fp32 product there (``video_features_tpu/extract/base.py:177``).
cuDNN and cuBLAS have no three-pass mode, so under those two lanes the
i3d and raft families send every convolution here instead
(``utils/device.py::three_pass_convs``, ``ops/nn.py::conv_route``),
with the libraries' TF32 off for what stays in them.

Kernel (``csrc/conv_tf32x3.cu``, CUDA C++ for sm_90a): an implicit-GEMM
convolution, channels-last, 2-D ``(N, H, W, C)`` or 3-D ``(N, T, H, W,
C)``, a stride and a zero padding per edge for each spatial axis (I3D's
TF-SAME pads are asymmetric, so no ``pad_spatial`` copy is made), groups
= 1, an optional bias, fp32 in and out. Each operand splits into hi =
tf32(x) and lo = tf32(x - hi) (:func:`~video_features_torch.ops.gru.
tf32_split`, ``cvt.rna.tf32.f32``) and every K step accumulates lo·hi +
hi·lo + hi·hi in fp32, as the GRU kernel does: fp32-class results. It
replaces no Pallas kernel: XLA did this arithmetic on the TPU. Bound by
operations at the path's shapes (the source's note).

Weights: :func:`pack_weight` turns torch's ``(O, I, *k)`` into the
kernel's ``(K_pad, O_pad)`` matrix at every call. The wrapper launches
the kernel on a CUDA tensor (or raises) and takes the plain version only
for a CPU tensor; ``conv_tf32x3.launches`` counts one per launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from video_features_torch.ops.nn import (
    IntOrTuple, Padding, _pad_pairs, _tuple, library_conv,
)

K_CHUNK = 32        # K per staged chunk in the kernel
O_PAD = 128         # output channels of the packed matrix: a multiple of this


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def pack_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(O, I, *k)`` → the kernel's ``(K_pad, O_pad)`` row-major matrix
    and its K per tap ``c_pad``. K runs over the taps (row-major over
    ``*k``) and, in each tap, over the input channels: padded to a
    multiple of 32 per tap where ``I % 4 == 0`` (the kernel stages whole
    16-byte channel groups of one tap), unpadded otherwise; the whole K
    is padded to a multiple of 32 and O to a multiple of 128 with zeros."""
    O, I = weight.shape[:2]
    taps = math.prod(weight.shape[2:])
    w = weight.reshape(O, I, taps).permute(2, 1, 0)          # (taps, I, O)
    c_pad = _round_up(I, K_CHUNK) if I % 4 == 0 else I
    w = F.pad(w, (0, 0, 0, c_pad - I)).reshape(taps * c_pad, O)
    k = taps * c_pad
    return (F.pad(w, (0, _round_up(O, O_PAD) - O, 0, _round_up(k, K_CHUNK) - k))
            .contiguous(), c_pad)


def _out_extent(x: torch.Tensor, weight: torch.Tensor, stride,
                padding) -> Tuple[int, ...]:
    """The output's spatial extent, one entry per spatial axis."""
    n = weight.ndim - 2
    return tuple((x.shape[1 + i] + lo + hi - weight.shape[2 + i]) // s + 1
                 for i, ((lo, hi), s) in enumerate(zip(_pad_pairs(padding, n),
                                                       _tuple(stride, n))))


def conv_tf32x3_plain(x: torch.Tensor, weight: torch.Tensor,
                      stride: IntOrTuple = 1, padding: Padding = 0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`conv_tf32x3`: ``ops/nn.py::library_conv``
    in fp32 (true fp32 on the card where the caller's scope keeps cuDNN's
    TF32 off, as the three-pass lane's does)."""
    return library_conv(x, weight, stride, padding, bias)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('conv_tf32x3')
    lib.vft_conv_tf32x3.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 21
                                    + [ctypes.c_void_p])
    lib.vft_conv_tf32x3.restype = ctypes.c_int
    return lib


def _check(x, weight, stride, padding, bias) -> None:
    """Raise on anything the kernel does not take."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    if weight.ndim not in (4, 5) or x.ndim != weight.ndim:
        raise ValueError(f'a 2-D (N, H, W, C) or 3-D (N, T, H, W, C) input '
                         f'with an (O, I, *k) weight of as many spatial '
                         f'axes; got x {tuple(x.shape)}, weight '
                         f'{tuple(weight.shape)}')
    if x.shape[-1] != weight.shape[1]:
        raise ValueError(f'groups=1 only: the input has {x.shape[-1]} '
                         f'channels, the weight takes {weight.shape[1]}')
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


def conv_tf32x3(x: torch.Tensor, weight: torch.Tensor,
                stride: IntOrTuple = 1, padding: Padding = 0,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The convolution of channels-last ``x`` with ``weight`` ``(O, I,
    *k)`` (``ops/nn.py::conv``'s arguments, groups = 1) in 3xTF32.

    CUDA tensors launch ``vft_conv_tf32x3`` (through ``vft::conv_tf32x3``
    while ``torch.export`` traces, one node per convolution:
    :func:`export_op`); CPU tensors run :func:`conv_tf32x3_plain`.
    """
    exporting = torch.compiler.is_exporting()
    if exporting:
        # a trace's layouts are its tracer's: the op takes its inputs
        # contiguous, as the kernel does (a no-op where they are)
        x, weight = x.contiguous(), weight.contiguous()
        bias = None if bias is None else bias.contiguous()
    _check(x, weight, stride, padding, bias)
    if x.device.type == 'cpu':
        return conv_tf32x3_plain(x, weight, stride, padding, bias)
    n = weight.ndim - 2
    strides = list(_tuple(stride, n))
    pads = [p for pair in _pad_pairs(padding, n) for p in pair]
    if exporting:          # a CUDA tensor: the op that launches the kernel
        return export_op()(x, weight, bias, strides, pads)
    return _launch(x, weight, bias, strides, pads)


def _launch(x, weight, bias, strides: Sequence[int], pads: Sequence[int]):
    pairs = list(zip(pads[0::2], pads[1::2]))
    out = _out_extent(x, weight, strides, pairs)
    packed, c_pad = pack_weight(weight)
    y = torch.empty((x.shape[0], *out, weight.shape[0]), dtype=x.dtype,
                    device=x.device)
    if x.ndim == 4:        # 2-D: one time step, one temporal tap
        t, (h, w), (ot, oh, ow) = 1, x.shape[1:3], (1, *out)
        (kt, kh, kw), (st, sh, sw) = (1, *weight.shape[2:]), (1, *strides)
        pt, ph, pw = 0, pairs[0][0], pairs[1][0]
    else:
        (t, h, w), (ot, oh, ow) = x.shape[1:4], out
        (kt, kh, kw), (st, sh, sw) = weight.shape[2:], strides
        pt, ph, pw = (p[0] for p in pairs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_conv_tf32x3(
            x.data_ptr(), packed.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.shape[0], t, h, w, x.shape[-1], ot, oh, ow, weight.shape[0],
            kt, kh, kw, st, sh, sw, pt, ph, pw, c_pad, packed.shape[0],
            packed.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f'vft_conv_tf32x3 failed to launch: CUDA error {rc}')
    conv_tf32x3.launches += 1
    return y


conv_tf32x3.launches = 0


@functools.lru_cache(maxsize=None)
def export_op():
    """The convolution as the ``torch.library`` op ``vft::conv_tf32x3``,
    registered on first use: its CUDA implementation launches the kernel
    (counted in ``launches``), its fake implementation gives the output's
    shape. ``padding`` is the (lo, hi) pairs flattened."""
    @torch.library.custom_op('vft::conv_tf32x3', mutates_args=(),
                             device_types='cuda')
    def conv_tf32x3_op(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor], stride: List[int],
                       padding: List[int]) -> torch.Tensor:
        pairs = list(zip(padding[0::2], padding[1::2]))
        _check(x, weight, stride, pairs, bias)
        return _launch(x, weight, bias, stride, padding)

    def fake(x, weight, bias, stride, padding):
        pairs = list(zip(padding[0::2], padding[1::2]))
        out = _out_extent(x, weight, stride, pairs)
        return x.new_empty((x.shape[0], *out, weight.shape[0]))

    conv_tf32x3_op.register_fake(fake)
    return conv_tf32x3_op
