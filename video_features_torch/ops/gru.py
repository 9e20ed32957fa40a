"""One SepConvGRU direction of RAFT's update block: a CUDA kernel, its
plain PyTorch version, and the weight repack between them.

RAFT's SepConvGRU runs two directions per refinement iteration, a 1×5
pass (axis 'w') then a 5×1 pass (axis 'h'). In the layout of
``models/raft.py::fuse_gru_params`` (the context input's share is
precomputed into ``zr_term`` and ``q_term``) one direction is, with
``h`` and ``motion`` of 128 channels each::

    zr  = sigmoid(conv5([h, motion], w_zr) + zr_term);  z, r = split(zr)
    q   = tanh(conv5([r·h, motion], w_q) + q_term)
    out = (1 - z)·h + z·q

``conv5`` sums 5 taps at offsets -2..+2 along the axis, zeros outside
the image (the convs' ``padding``).

Kernel (``csrc/gru_direction.cu``, CUDA C++ for sm_90a):
:func:`gru_direction` replaces ``tools/gru_kernel_experiment.py::
pallas_direction`` (``_kernel``). It is two register-blocked fp32
implicit GEMMs (zr with a sigmoid epilogue that writes z and r·h; q with
the tanh and blend epilogue), bound by operations: 2.58 ms per direction
at the main path's batch-8 shape on the H100's fp32 rate. The source's
note gives the design.

Weights: :func:`pack_direction` turns the conv weights (O, I, kh, kw),
I = [h | motion], into the kernel's tap layout (5, I, O), once per RAFT
forward; :func:`gru_direction_plain` reads them back into conv weights.
The wrapper launches the kernel on a CUDA tensor (or raises) and takes
the plain version only for a CPU tensor; ``gru_direction.launches``
counts one per direction (two CUDA launches).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from video_features_torch.ops.nn import conv

HIDDEN = 128
TAPS = 5
AXES = ('w', 'h')
PADS = {'w': [(0, 0), (2, 2)], 'h': [(2, 2), (0, 0)]}   # the convs' padding


def pack_direction(zr_weight: torch.Tensor, q_weight: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv weights (O, I, 1, 5) or (O, I, 5, 1) → tap layout (5, I, O),
    contiguous: ``(w_zr (5, 256, 256), w_q (5, 256, 128))``."""
    return tuple(w.reshape(w.shape[0], w.shape[1], TAPS).permute(2, 1, 0)
                 .contiguous() for w in (zr_weight, q_weight))


def _conv_weight(taps: torch.Tensor, axis: str) -> torch.Tensor:
    """Tap layout (5, I, O) → conv weight (O, I, 1, 5) ('w') or
    (O, I, 5, 1) ('h')."""
    w = taps.permute(2, 1, 0)
    return (w.unsqueeze(2) if axis == 'w' else w.unsqueeze(3)).contiguous()


def gru_direction_plain(h: torch.Tensor, motion: torch.Tensor,
                        w_zr: torch.Tensor, w_q: torch.Tensor,
                        zr_term: torch.Tensor, q_term: torch.Tensor,
                        axis: str) -> torch.Tensor:
    """Plain version of :func:`gru_direction`: the JAX package's
    ``sep_conv_gru`` direction body (``video_features_tpu/models/
    raft.py::sep_conv_gru``) through ``ops.nn.conv``."""
    pad = PADS[axis]
    zr = torch.sigmoid(conv(torch.cat([h, motion], -1),
                            _conv_weight(w_zr, axis), padding=pad) + zr_term)
    z, r = torch.chunk(zr, 2, dim=-1)
    q = torch.tanh(conv(torch.cat([r * h, motion], -1),
                        _conv_weight(w_q, axis), padding=pad) + q_term)
    return (1 - z) * h + z * q


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('gru_direction')
    lib.vft_gru_direction.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.vft_gru_direction.restype = ctypes.c_int
    return lib


def _check(h, motion, w_zr, w_q, zr_term, q_term, axis) -> None:
    """Raise on anything the kernel does not take."""
    if axis not in AXES:
        raise ValueError(f'axis must be one of {AXES}; got {axis!r}')
    if h.ndim != 4 or h.shape[-1] != HIDDEN:
        raise ValueError(f'h must be (B, H, W, {HIDDEN}); got {tuple(h.shape)}')
    pix = tuple(h.shape[:3])
    want = {'h': pix + (HIDDEN,), 'motion': pix + (HIDDEN,),
            'w_zr': (TAPS, 2 * HIDDEN, 2 * HIDDEN),
            'w_q': (TAPS, 2 * HIDDEN, HIDDEN),
            'zr_term': pix + (2 * HIDDEN,), 'q_term': pix + (HIDDEN,)}
    got = {'h': h, 'motion': motion, 'w_zr': w_zr, 'w_q': w_q,
           'zr_term': zr_term, 'q_term': q_term}
    for name, t in got.items():
        if t.dtype != torch.float32 or tuple(t.shape) != want[name] \
                or not t.is_contiguous() or t.device != h.device:
            raise ValueError(
                f'{name} must be a contiguous float32 {want[name]} tensor on '
                f'{h.device}; got {t.dtype} {tuple(t.shape)} on {t.device}, '
                f'contiguous={t.is_contiguous()}')
    if h.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {h.device}')


def gru_direction(h: torch.Tensor, motion: torch.Tensor, w_zr: torch.Tensor,
                  w_q: torch.Tensor, zr_term: torch.Tensor,
                  q_term: torch.Tensor, axis: str) -> torch.Tensor:
    """One GRU direction → the new h (B, H, W, 128).

    CUDA tensors launch ``vft_gru_direction``; CPU tensors run
    :func:`gru_direction_plain`.
    """
    _check(h, motion, w_zr, w_q, zr_term, q_term, axis)
    if h.device.type == 'cpu':
        return gru_direction_plain(h, motion, w_zr, w_q, zr_term, q_term, axis)
    out = torch.empty_like(h)
    z = torch.empty_like(h)          # scratch: the z gate
    rh = torch.empty_like(h)         # scratch: r·h, the q GEMM's input
    B, H, W, _ = h.shape
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_gru_direction(
            h.data_ptr(), motion.data_ptr(), w_zr.data_ptr(), w_q.data_ptr(),
            zr_term.data_ptr(), q_term.data_ptr(), z.data_ptr(),
            rh.data_ptr(), out.data_ptr(), B, H, W, int(axis == 'h'), stream)
    if rc != 0:
        raise RuntimeError(f'vft_gru_direction failed to launch: CUDA error {rc}')
    gru_direction.launches += 1
    return out


gru_direction.launches = 0
