"""A batched GEMM in 3xTF32 on the tensor cores: a CUDA kernel, its plain
PyTorch version and the tile plan between them.

On the TPU the JAX package runs every linear and every attention product
of every family with the ambient matmul precision of its lane, and
``precision=mixed`` and ``high`` mean three bf16 products per fp32 product
there (``video_features_tpu/extract/base.py:166-177``; the linears
``ops/nn.py:145-147``, the attention products ``ops/attention.py:39,41``
and ``models/clip.py:82-105,132,162``). cuBLAS has no three-pass mode, so
under those two lanes the clip and timm families send every linear,
attention product and raw matmul here (``ops/nn.py::linear`` and
``::matmul`` inside ``conv_route``), with cuBLAS's TF32 off for what stays
in torch. It replaces no Pallas kernel: XLA did this arithmetic on the TPU.

Kernel (``csrc/gemm_tf32x3.cu``, CUDA C++ for sm_90a,
``gemm_tf32x3_wgmma<WGS, BN>``): ``C[b] = alpha · A[b] · op(B[b]) (+
bias)``, fp32 in and out. A is ``(*batch, M, K)`` with K contiguous; B is
``(*batch, N, K)`` (the linears' ``(O, I)`` weight, ``QKᵀ``'s K) or, with
``b_kn``, ``(*batch, K, N)`` (``PV``'s V, CLIP's ``x @ proj``); up to two
batch axes of any strides (the heads of a ``(B, N, H, D)`` view need no
copy), and a two-dimensional B is shared by every batch entry. Each
operand splits into hi = tf32(x) and lo = tf32(x - hi) in the kernel
(:func:`~video_features_torch.ops.gru.tf32_split`, ``cvt.rna.tf32.f32``)
and every 32-K chunk accumulates lo·hi + hi·lo + hi·hi on ``wgmma`` into a
fresh accumulator that is then added to the running fp32 sum: the
arithmetic of ``ops/conv_tf32x3.py``, the same error class. No weight is
packed on the host: the kernel reads both operands as fp32 at each call
and its consumers split B, K-major in the 128-byte swizzle, as
:func:`split_positions` writes out. Bound by operations at the linears,
by bytes at the attention products (the source's note gives the design).

The wrapper launches the kernel on a CUDA tensor (or raises) and takes the
plain version (``torch.matmul`` in fp32) only for a CPU tensor;
``gemm_tf32x3.launches`` counts one per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

K_CHUNK = 32              # K per staged chunk: one 128-byte row of a split tile
GEMM_WIDTHS = (16, 32, 64, 128)     # the kernel's tile widths (wgmma's N)
TILE_COST = 16            # columns of work a tile costs beyond its width
SMS = 132                 # streaming multiprocessors of an H100 SXM


class Plan(NamedTuple):
    """One call's tiling: ``bm`` rows by ``bn`` columns per block, ``tiles``
    blocks along N."""
    bm: int
    bn: int
    tiles: int


def gemm_plan(batch: int, m: int, n: int, sms: int = SMS) -> Plan:
    """The tile of a call: the :data:`GEMM_WIDTHS` width whose tiles pad N
    least, each tile costing :data:`TILE_COST` columns more (197 → 2 ×
    128, 50 → 64, 32 → 32, 768 → 6 × 128); 128 rows per block, or 64
    where M fits in 64 rows or 128-row blocks would leave SMs idle."""
    if n < 1:
        raise ValueError(f'N must be >= 1; got {n}')
    bn = min(GEMM_WIDTHS, key=lambda w: (-(-n // w) * (w + TILE_COST), -w))
    tiles = -(-n // bn)
    bm = 128 if m > 64 and batch * -(-m // 128) * tiles >= sms else 64
    return Plan(bm, bn, tiles)


def occupancy(m: int, n: int, plan: Plan) -> float:
    """The share of the tiles' rows × columns that hold output."""
    return m * n / (-(-m // plan.bm) * plan.bm * plan.tiles * plan.bn)


def split_positions(bn: int) -> torch.Tensor:
    """(bn, 32): where the kernel's consumers store natural K position kk
    of row n in a split tile (``csrc/gemm_tf32x3.cu::split_pos``): the
    inverse of ``ops/gru.py::K_ORDER``, then the 128-byte swizzle
    (16-byte chunk j of row n at j ^ (n % 8)). The same layout as
    ``ops/conv_tf32x3.py::pack_weight``'s rows."""
    n = torch.arange(bn)[:, None]
    kk = torch.arange(K_CHUNK)[None, :]
    p = 8 * ((kk % 8) // 2) + (kk % 2) * 4 + kk // 8
    return ((p // 4) ^ (n % 8)) * 4 + p % 4


def gemm_tf32x3_plain(a: torch.Tensor, b: torch.Tensor, b_kn: bool = False,
                      alpha: float = 1.0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`gemm_tf32x3`: ``torch.matmul`` in fp32
    (true fp32 on the card where the caller's scope keeps cuBLAS's TF32
    off, as the three-pass lane's does), then alpha, then the bias."""
    out = a @ (b if b_kn else b.transpose(-1, -2))
    if alpha != 1.0:
        out = out * alpha
    if bias is not None:
        out = out + bias
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('gemm_tf32x3')
    c_ll, c_int = ctypes.c_longlong, ctypes.c_int
    lib.vft_gemm_tf32x3.argtypes = (
        [ctypes.c_void_p] * 4 + [c_int] * 5 + [c_ll, c_ll, c_int, c_ll, c_ll,
                                               c_int]
        + [c_int] * 3 + [ctypes.c_float] + [c_int] * 2 + [ctypes.c_void_p])
    lib.vft_gemm_tf32x3.restype = c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _batch_view(t: torch.Tensor, name: str) -> Tuple[Tuple[int, ...],
                                                     Tuple[int, int, int, int]]:
    """``(batch shape, (b1, b2, s1, s2))``: up to two leading batch axes
    and their strides (one axis: b1 = 1, s1 = 0; none: one entry)."""
    lead = tuple(t.shape[:-2])
    if len(lead) > 2:
        raise ValueError(f'{name} must have at most two batch axes; got '
                         f'{tuple(t.shape)}')
    if len(lead) == 2:
        return lead, (lead[0], lead[1], t.stride(0), t.stride(1))
    if len(lead) == 1:
        return lead, (1, lead[0], 0, t.stride(0))
    return lead, (1, 1, 0, 0)


def _check(a, b, b_kn, bias) -> Tuple[int, int, int]:
    """Raise on anything the kernel does not take; returns (M, N, K)."""
    if a.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {a.device}')
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f'A (*batch, M, K) and B (*batch, N, K) or (*batch, '
                         f'K, N); got A {tuple(a.shape)}, B {tuple(b.shape)}')
    m, k = a.shape[-2:]
    kb, n = b.shape[-2:] if b_kn else b.shape[-2:][::-1]
    if k != kb or k < 1:
        raise ValueError(f'A and B must agree on K >= 1: A {tuple(a.shape)}, '
                         f'B {tuple(b.shape)} ({"K, N" if b_kn else "N, K"})')
    if b.ndim > 2 and tuple(b.shape[:-2]) != tuple(a.shape[:-2]):
        raise ValueError(f'B\'s batch axes {tuple(b.shape[:-2])} must be A\'s '
                         f'{tuple(a.shape[:-2])}, or none (a shared B)')
    _batch_view(a, 'A')
    _batch_view(b, 'B')
    tensors = {'A': a, 'B': b}
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f'bias must be ({n},); got {tuple(bias.shape)}')
        tensors['bias'] = bias
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f'{name} must be a float32 tensor on {a.device}; '
                             f'got {t.dtype} on {t.device}')
        if t.ndim and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f'{name} must be contiguous along its last axis; '
                             f'got strides {t.stride()}')
        if any(s < 0 for s in t.stride()):
            raise ValueError(f'{name} has a negative stride {t.stride()}')
    return m, n, k


def gemm_tf32x3(a: torch.Tensor, b: torch.Tensor, b_kn: bool = False,
                alpha: float = 1.0,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha · a @ op(b) (+ bias)`` in 3xTF32: ``a`` ``(*batch, M, K)``,
    ``b`` ``(*batch, N, K)`` or with ``b_kn`` ``(*batch, K, N)`` (no batch
    axes: shared by every entry), at most two batch axes, each operand
    contiguous along its last axis; returns ``(*batch, M, N)``,
    contiguous.

    CUDA tensors launch ``vft_gemm_tf32x3`` (through ``vft::gemm_tf32x3``
    while ``torch.export`` traces: :func:`export_op`); CPU tensors run
    :func:`gemm_tf32x3_plain`.
    """
    exporting = torch.compiler.is_exporting()
    if exporting:
        # a trace's layouts are its tracer's: the op takes its inputs
        # contiguous (a no-op where they are)
        a, b = a.contiguous(), b.contiguous()
        bias = None if bias is None else bias.contiguous()
    _check(a, b, b_kn, bias)
    if a.device.type == 'cpu':
        return gemm_tf32x3_plain(a, b, b_kn, alpha, bias)
    if exporting:
        return export_op()(a, b, bias, b_kn, float(alpha))
    return _launch(a, b, bias, b_kn, float(alpha))


def _vec(t: torch.Tensor, b1b2s: Tuple[int, int, int, int], row: int,
         inner: int) -> int:
    """Whether the kernel may copy ``t``'s rows 16 bytes at a time: every
    row starts 16-byte aligned and holds a multiple of 4 floats."""
    _, _, s1, s2 = b1b2s
    return int(t.data_ptr() % 16 == 0 and row % 4 == 0 and s1 % 4 == 0
               and s2 % 4 == 0 and inner % 4 == 0)


def _launch(a, b, bias, b_kn: bool, alpha: float):
    m, k = a.shape[-2:]
    n = b.shape[-1] if b_kn else b.shape[-2]
    lead, av = _batch_view(a, 'A')
    _, bv = _batch_view(b, 'B')
    if b.ndim == 2:                  # one B for every batch entry
        bv = (av[0], av[1], 0, 0)
    batch = av[0] * av[1]
    plan = gemm_plan(batch, m, n, _sms(a.device.index))
    lda = a.stride(-2) if m > 1 else k
    ldb = b.stride(-2) if b.shape[-2] > 1 else b.shape[-1]
    c = torch.empty((*lead, m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().vft_gemm_tf32x3(
            a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), c.data_ptr(),
            av[0], av[1], m, n, k, av[2], av[3], lda, bv[2], bv[3], ldb,
            int(b_kn), _vec(a, av, lda, k), _vec(b, bv, ldb, n if b_kn else k),
            alpha, plan.bm, plan.bn, stream)
    if rc != 0:
        raise RuntimeError(f'vft_gemm_tf32x3 failed to launch: CUDA error {rc}')
    gemm_tf32x3.launches += 1
    return c


gemm_tf32x3.launches = 0


@functools.lru_cache(maxsize=None)
def export_op():
    """The GEMM as the ``torch.library`` op ``vft::gemm_tf32x3``,
    registered on first use: its CUDA implementation launches the kernel
    (counted in ``launches``), its fake implementation gives the output's
    shape."""
    @torch.library.custom_op('vft::gemm_tf32x3', mutates_args=(),
                             device_types='cuda')
    def gemm_tf32x3_op(a: torch.Tensor, b: torch.Tensor,
                       bias: Optional[torch.Tensor], b_kn: bool,
                       alpha: float) -> torch.Tensor:
        _check(a, b, b_kn, bias)
        return _launch(a, b, bias, b_kn, alpha)

    def fake(a, b, bias, b_kn, alpha):
        n = b.shape[-1] if b_kn else b.shape[-2]
        return a.new_empty((*a.shape[:-1], n))

    gemm_tf32x3_op.register_fake(fake)
    return gemm_tf32x3_op
