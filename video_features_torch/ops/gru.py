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
pallas_direction`` (``_kernel``). It is two implicit GEMMs (zr with a
sigmoid epilogue that writes z and r·h; q with the tanh and blend
epilogue) on the tensor cores (``wgmma``) in 3xTF32: each operand splits
into a TF32 hi and lo part and three TF32 products (lo·hi, hi·lo, hi·hi)
accumulate in fp32, which keeps fp32-class results under
``precision=highest`` (the Hopper form of the Pallas kernel's bf16_3x).
Bound by operations: 1.05 ms per direction at the main path's batch-8
shape at 3 × the TF32 rate (2.58 ms at the fp32 FMA rate). The source's
note gives the design. ``passes=1`` selects the one-pass kernel
(``gru_tf32_onepass``) for the one-pass precision lanes (``default``,
``tensorfloat32``, ``bfloat16``; ``utils/device.py::LANES``): only the
hi·hi products, the activations rounded to TF32 and the weights' lo
parts not read, a third of the products; its CTAs run in clusters that
share each weight tile by multicast, fed by a producer warp, with one
half of each tap's products in flight while the other is summed.

Weights: :func:`pack_direction` turns the conv weights (O, I, kh, kw),
I = [h | motion], into the kernel's layout, once per RAFT forward:
(hi | lo, 5 taps, 8 slices of 32 input channels, O, 32), K-major, split
into TF32 hi and lo parts, each slice's channels in the kernel's K order
(``K_ORDER``) and stored in the 128-byte swizzle the kernel's ``wgmma``
descriptors read. :func:`unpack_direction` reads it back into
tap weights (hi + lo) for :func:`gru_direction_plain`. The wrapper
launches the kernel on a CUDA tensor (or raises) and takes the plain
version only for a CPU tensor; ``gru_direction.launches`` counts one per
direction (two CUDA launches), and ``gru_direction.launches_by_passes``
the same by pass count.
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
PASSES = (1, 3)     # TF32 products per fp32 product: 1xTF32, 3xTF32
PADS = {'w': [(0, 0), (2, 2)], 'h': [(2, 2), (0, 0)]}   # the convs' padding


SLICE = 32          # input channels per 128-byte row of a packed tile
SWIZZLE = 8         # 16-byte chunks per row, permuted by out channel % 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's ``cvt.rna.tf32.f32``, by bit arithmetic."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): 3xTF32's split."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# K order of a packed 32-channel row: position 8k + c holds channel
# 8·(c % 4) + 2k + c // 4, so that the kernel's thread t finds the fragment
# columns t and t + 4 of all four 8-channel K steps in its own 8
# contiguous channels 8t … 8t + 7
K_ORDER = tuple(8 * (c % 4) + 2 * k + c // 4 for k in range(4) for c in range(8))


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """(..., O, 32) ↔ the 128-byte swizzle: 16-byte chunk j of row n is
    stored at chunk j ^ (n % 8). The permutation is its own inverse."""
    n = t.shape[-2]
    rows = torch.arange(n, device=t.device)[:, None]
    chunks = torch.arange(SWIZZLE, device=t.device)[None, :] ^ (rows % SWIZZLE)
    u = t.reshape(*t.shape[:-1], SWIZZLE, SLICE // SWIZZLE)
    return u[..., rows, chunks, :].reshape(t.shape)


def _pack(w: torch.Tensor) -> torch.Tensor:
    O, I = w.shape[:2]
    taps = w.reshape(O, I, TAPS).permute(2, 0, 1).float()     # (5, O, I)
    parts = torch.stack(tf32_split(taps.contiguous()))       # (2, 5, O, I)
    parts = parts.reshape(2, TAPS, O, I // SLICE, SLICE).permute(0, 1, 3, 2, 4)
    return _swizzle(parts[..., list(K_ORDER)]).contiguous()


def pack_direction(zr_weight: torch.Tensor, q_weight: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv weights (O, I, 1, 5) or (O, I, 5, 1) → the kernel's layout
    (2, 5, I/32, O, 32) (see the module's note), contiguous:
    ``(w_zr (2, 5, 8, 256, 32), w_q (2, 5, 8, 128, 32))``."""
    return _pack(zr_weight), _pack(q_weight)


def unpack_parts(packed: torch.Tensor) -> torch.Tensor:
    """A :func:`pack_direction` tensor → its TF32 parts (2, 5, O, I):
    hi, lo."""
    _, taps, slices, O, _ = packed.shape
    inverse = sorted(range(SLICE), key=K_ORDER.__getitem__)
    return _swizzle(packed)[..., inverse].permute(0, 1, 3, 2, 4).reshape(
        2, taps, O, slices * SLICE)


def unpack_direction(packed: torch.Tensor) -> torch.Tensor:
    """A :func:`pack_direction` tensor → tap weights (5, O, I), hi + lo."""
    hi, lo = unpack_parts(packed)
    return hi + lo


def _conv_weight(taps: torch.Tensor, axis: str) -> torch.Tensor:
    """Tap weights (5, O, I) → conv weight (O, I, 1, 5) ('w') or
    (O, I, 5, 1) ('h')."""
    w = taps.permute(1, 2, 0)
    return (w.unsqueeze(2) if axis == 'w' else w.unsqueeze(3)).contiguous()


def _operand(t: torch.Tensor, passes: int) -> torch.Tensor:
    """A conv operand as the tensor cores read it: as it is in 3xTF32
    (fp32-class), rounded to TF32 in one pass."""
    return t if passes == 3 else tf32_round(t.float()).to(t.dtype)


def gru_direction_convs(h: torch.Tensor, motion: torch.Tensor,
                        conv_zr: torch.Tensor, conv_q: torch.Tensor,
                        zr_term: torch.Tensor, q_term: torch.Tensor,
                        axis: str, passes: int = 3) -> torch.Tensor:
    """The direction through ``ops.nn.conv`` from conv weights (O, I, kh,
    kw): the JAX package's ``sep_conv_gru`` direction body
    (``video_features_tpu/models/raft.py::sep_conv_gru``). ``passes=1``
    convolves the TF32-rounded inputs and weights (in the inputs' dtype)
    with the same epilogues."""
    pad = PADS[axis]
    w_zr, w_q = _operand(conv_zr, passes), _operand(conv_q, passes)
    zr = torch.sigmoid(conv(_operand(torch.cat([h, motion], -1), passes),
                            w_zr, padding=pad) + zr_term)
    z, r = torch.chunk(zr, 2, dim=-1)
    q = torch.tanh(conv(_operand(torch.cat([r * h, motion], -1), passes),
                        w_q, padding=pad) + q_term)
    return (1 - z) * h + z * q


def gru_direction_plain(h: torch.Tensor, motion: torch.Tensor,
                        w_zr: torch.Tensor, w_q: torch.Tensor,
                        zr_term: torch.Tensor, q_term: torch.Tensor,
                        axis: str, passes: int = 3) -> torch.Tensor:
    """Plain version of :func:`gru_direction`: the packed weights read back
    through :func:`gru_direction_convs`, hi + lo (:func:`unpack_direction`)
    for ``passes=3``, the hi parts alone for ``passes=1``."""
    if passes not in PASSES:
        raise ValueError(f'passes must be one of {PASSES}; got {passes!r}')

    def weight(packed):
        taps = (unpack_direction(packed) if passes == 3
                else unpack_parts(packed)[0])
        return _conv_weight(taps.to(h.dtype), axis)
    return gru_direction_convs(h, motion, weight(w_zr), weight(w_q), zr_term,
                               q_term, axis, passes)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('gru_direction')
    lib.vft_gru_direction_passes.argtypes = ([ctypes.c_void_p] * 9
                                             + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p])
    lib.vft_gru_direction_passes.restype = ctypes.c_int
    # (width, axis_h, *cluster, *stages, *bm, *smem, *resident): how the
    # one-pass kernel runs a grid (tools/gru_tf32x3_variants.py reads it)
    lib.vft_gru_one_pass_config.argtypes = ([ctypes.c_int] * 2
                                            + [ctypes.POINTER(ctypes.c_int)] * 5)
    lib.vft_gru_one_pass_config.restype = ctypes.c_int
    return lib


def _check(h, motion, w_zr, w_q, zr_term, q_term, axis, passes) -> None:
    """Raise on anything the kernel does not take."""
    if axis not in AXES:
        raise ValueError(f'axis must be one of {AXES}; got {axis!r}')
    if passes not in PASSES:
        raise ValueError(f'passes must be one of {PASSES}; got {passes!r}')
    if h.ndim != 4 or h.shape[-1] != HIDDEN:
        raise ValueError(f'h must be (B, H, W, {HIDDEN}); got {tuple(h.shape)}')
    pix = tuple(h.shape[:3])
    want = {'h': pix + (HIDDEN,), 'motion': pix + (HIDDEN,),
            'w_zr': (2, TAPS, 2 * HIDDEN // SLICE, 2 * HIDDEN, SLICE),
            'w_q': (2, TAPS, 2 * HIDDEN // SLICE, HIDDEN, SLICE),
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
                  q_term: torch.Tensor, axis: str,
                  passes: int = 3) -> torch.Tensor:
    """One GRU direction → the new h (B, H, W, 128), in ``passes`` TF32
    products per fp32 product (3: 3xTF32; 1: one pass).

    CUDA tensors launch ``vft_gru_direction_passes``; CPU tensors run
    :func:`gru_direction_plain`.
    """
    _check(h, motion, w_zr, w_q, zr_term, q_term, axis, passes)
    if h.device.type == 'cpu':
        return gru_direction_plain(h, motion, w_zr, w_q, zr_term, q_term,
                                   axis, passes)
    out = torch.empty_like(h)
    z = torch.empty_like(h)          # scratch: the z gate
    rh = torch.empty_like(h)         # scratch: r·h, the q GEMM's input
    B, H, W, _ = h.shape
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_gru_direction_passes(
            h.data_ptr(), motion.data_ptr(), w_zr.data_ptr(), w_q.data_ptr(),
            zr_term.data_ptr(), q_term.data_ptr(), z.data_ptr(),
            rh.data_ptr(), out.data_ptr(), B, H, W, int(axis == 'h'), passes,
            stream)
    if rc != 0:
        raise RuntimeError(f'vft_gru_direction_passes failed to launch: CUDA '
                           f'error {rc}')
    gru_direction.launches += 1
    gru_direction.launches_by_passes[passes] += 1
    return out


gru_direction.launches = 0
gru_direction.launches_by_passes = {p: 0 for p in PASSES}
