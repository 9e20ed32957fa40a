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
``gemm_tf32x3_ws<WGS, BN, PACKED>``): ``C[b] = alpha · A[b] · op(B[b])
(+ bias)``, fp32 in and out. A is ``(*batch, M, K)`` with K contiguous; B
is ``(*batch, N, K)`` (``QKᵀ``'s K) or, with ``b_kn``, ``(*batch, K, N)``
(``PV``'s V); up to two batch axes of any strides (the heads of a ``(B,
N, H, D)`` view need no copy). A two-dimensional B is a weight shared by
every batch entry (the linears' ``(O, I)`` weight, CLIP's ``(K, N)``
projections): it is split into TF32 hi and lo once for its life
(:func:`weight_pack`, ``ops/conv_tf32x3.py::pack_weight``'s layout at the
call's tile width, cached by ``ops/weight_packs.py``), and each ring
stage takes its tile by one bulk copy. An activation B is split in the
kernel, overlapped with the previous chunk's products. Each operand splits
into hi = tf32(x) and lo = tf32(x - hi)
(:func:`~video_features_torch.ops.gru.tf32_split`, ``cvt.rna.tf32.f32``)
and every 32-K chunk accumulates lo·hi + hi·lo + hi·hi on ``wgmma`` into a
fresh accumulator that is then added to the running fp32 sum: the
arithmetic of ``ops/conv_tf32x3.py``, the same error class. One thread
feeds a ring of stages (A by a TMA tensor map where its strides are
16-byte aligned, else as 16-byte-aligned row supersets copied by every
thread) for one or two warpgroups; no block barrier in the main loop.
Bound by operations at the linears, by bytes at the attention products
(the source's note gives the design).

The wrapper launches the kernel on a CUDA tensor (or raises) and takes the
plain version (``torch.matmul`` in fp32) only for a CPU tensor;
``gemm_tf32x3.launches`` counts one per launch, ``gemm_tf32x3.packs`` the
weight packs made. :func:`gemm_tf32x3_lockstep` launches the kernel's
earlier design (``csrc/gemm_tf32x3_lockstep.cu``), a yardstick on no
path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from video_features_torch.ops import conv_tf32x3, weight_packs

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


@functools.lru_cache(maxsize=4096)
def gemm_plan(batch: int, m: int, n: int, sms: int = SMS) -> Plan:
    """The tile of a call: the :data:`GEMM_WIDTHS` width whose tiles pad N
    least, each tile costing :data:`TILE_COST` columns more (197 → 2 ×
    128, 50 → 64, 32 → 32, 768 → 6 × 128); 128 rows per block, or 64
    where M fits in 64 rows or 128-row blocks would leave SMs idle; and
    where even 64-row tiles leave SMs idle (a projection of a few rows,
    CLIP's 768 → 512 at batch 32), the widest width whose tiles fill
    them, or the narrowest."""
    if n < 1:
        raise ValueError(f'N must be >= 1; got {n}')
    bn = min(GEMM_WIDTHS, key=lambda w: (-(-n // w) * (w + TILE_COST), -w))
    tiles = -(-n // bn)
    bm = 128 if m > 64 and batch * -(-m // 128) * tiles >= sms else 64
    rows = batch * -(-m // bm)
    if rows * tiles < sms:
        bn = next((w for w in GEMM_WIDTHS[::-1] if rows * -(-n // w) >= sms),
                  GEMM_WIDTHS[0])
        tiles = -(-n // bn)
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
    return typed_library(_kernels.load('gemm_tf32x3'))


@functools.lru_cache(maxsize=None)
def _lockstep_library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    return typed_library(_kernels.load('gemm_tf32x3_lockstep'))


def typed_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with its entry points' argument and result types set (a
    build of ``csrc/gemm_tf32x3.cu`` or ``csrc/gemm_tf32x3_lockstep.cu``,
    or of a variant of either)."""
    c_ll, c_int, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    shape = [c_int] * 5 + [c_ll, c_ll, c_int, c_ll, c_ll, c_int]
    for name, tail in (('vft_gemm_tf32x3', [c_int] * 2 + [ctypes.c_float]
                        + [c_int] * 3 + [ptr]),
                       ('vft_gemm_tf32x3_lockstep', [c_int] * 3
                        + [ctypes.c_float] + [c_int] * 2 + [ptr])):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 4 + shape + tail
            fn.restype = c_int
    if hasattr(lib, 'vft_gemm_tf32x3_a_by_tma'):
        lib.vft_gemm_tf32x3_a_by_tma.argtypes = ([ptr] + [c_int] * 4
                                                 + [c_ll, c_ll] + [c_int] * 2)
        lib.vft_gemm_tf32x3_a_by_tma.restype = c_int
    return lib


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


class Geometry(NamedTuple):
    """What :func:`_check` found: the extents, A's batch shape, both
    operands' ``(b1, b2, s1, s2)`` (a shared B's with zero strides) and
    row strides."""
    m: int
    n: int
    k: int
    lead: Tuple[int, ...]
    av: Tuple[int, int, int, int]
    bv: Tuple[int, int, int, int]
    lda: int
    ldb: int


# the geometry of every operand layout checked so far (the path repeats a
# few dozen), keyed on what the checks read
_checked: dict = {}


def _check(a, b, b_kn, bias) -> Geometry:
    """Raise on anything the kernel does not take; returns the call's
    :class:`Geometry`, from :data:`_checked` where these operands' dtypes,
    devices, shapes and strides passed before."""
    key = (a.shape, a.stride(), a.dtype, a.device, b.shape, b.stride(),
           b.dtype, b.device, b_kn,
           None if bias is None else (bias.shape, bias.stride(), bias.dtype,
                                      bias.device))
    geo = _checked.get(key)
    if geo is None:
        geo = _check_operands(a, b, b_kn, bias)
        if len(_checked) < 4096:
            _checked[key] = geo
    return geo


def _check_operands(a, b, b_kn, bias) -> Geometry:
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
    lead, av = _batch_view(a, 'A')
    _, bv = _batch_view(b, 'B')
    if b.ndim == 2:                  # one B for every batch entry
        bv = (av[0], av[1], 0, 0)
    for name, t in (('A', a), ('B', b), ('bias', bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f'{name} must be a float32 tensor on {a.device}; '
                             f'got {t.dtype} on {t.device}')
        if t.ndim and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f'{name} must be contiguous along its last axis; '
                             f'got strides {t.stride()}')
        if any(s < 0 for s in t.stride()):
            raise ValueError(f'{name} has a negative stride {t.stride()}')
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f'bias must be ({n},); got {tuple(bias.shape)}')
    lda = a.stride(-2) if m > 1 else k
    ldb = b.stride(-2) if b.shape[-2] > 1 else b.shape[-1]
    return Geometry(m, n, k, lead, av, bv, lda, ldb)


def gemm_tf32x3(a: torch.Tensor, b: torch.Tensor, b_kn: bool = False,
                alpha: float = 1.0,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha · a @ op(b) (+ bias)`` in 3xTF32: ``a`` ``(*batch, M, K)``,
    ``b`` ``(*batch, N, K)`` or with ``b_kn`` ``(*batch, K, N)`` (no batch
    axes: a weight shared by every entry, pre-split once for its life),
    at most two batch axes, each operand contiguous along its last axis;
    returns ``(*batch, M, N)``, contiguous.

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
    geo = _check(a, b, b_kn, bias)
    if a.device.type == 'cpu':
        return gemm_tf32x3_plain(a, b, b_kn, alpha, bias)
    if exporting:
        return export_op()(a, b, bias, b_kn, float(alpha))
    return _launch(a, b, bias, b_kn, float(alpha), geo)


def weight_pack(weight: torch.Tensor, b_kn: bool, bn: int) -> torch.Tensor:
    """A shared B's operand: ``conv_tf32x3.pack_weight`` of its ``(N, K)``
    form (a ``(K, N)`` weight transposed) at tile width ``bn``, made once
    for the weight's life (:mod:`~video_features_torch.ops.weight_packs`);
    ``gemm_tf32x3.packs`` counts the packs made."""
    pack, made = weight_packs.packed(
        weight, ('gemm_tf32x3', b_kn, bn),
        lambda w: conv_tf32x3.pack_weight(w.t() if b_kn else w, bn=bn))
    if made:
        gemm_tf32x3.packs += 1
    return pack


def _launch(a, b, bias, b_kn: bool, alpha: float,
            geo: Optional[Geometry] = None):
    from video_features_torch.ops._kernels import current_stream, sms
    m, n, k, lead, av, bv, lda, ldb = geo or _check(a, b, b_kn, bias)
    index = a.device.index
    plan = gemm_plan(av[0] * av[1], m, n, sms(index))
    packed = b.ndim == 2
    operand = weight_pack(b, b_kn, plan.bn) if packed else b
    c = torch.empty((*lead, m, n), dtype=a.dtype, device=a.device)
    args = (a.data_ptr(), operand.data_ptr(),
            None if bias is None else bias.data_ptr(), c.data_ptr(),
            av[0], av[1], m, n, k, av[2], av[3], lda, bv[2], bv[3], ldb,
            int(b_kn), int(packed), alpha, plan.bm, plan.bn, index)
    if index == torch.cuda.current_device():
        rc = _library().vft_gemm_tf32x3(*args, current_stream(index))
    else:
        with torch.cuda.device(index):
            rc = _library().vft_gemm_tf32x3(*args, current_stream(index))
    if rc != 0:
        raise RuntimeError(f'vft_gemm_tf32x3 failed to launch: CUDA error {rc}')
    gemm_tf32x3.launches += 1
    return c


gemm_tf32x3.launches = 0
gemm_tf32x3.packs = 0


def a_by_tma(a: torch.Tensor, bm: int = 128) -> bool:
    """Whether the kernel takes ``a``'s rows by its TMA tensor map (16-byte
    aligned base and strides) rather than as cp.async supersets."""
    m, k = a.shape[-2:]
    _, av = _batch_view(a, 'A')
    lda = a.stride(-2) if m > 1 else k
    return bool(_library().vft_gemm_tf32x3_a_by_tma(
        a.data_ptr(), av[0], av[1], m, k, av[2], av[3], lda, bm))


def gemm_tf32x3_lockstep(a: torch.Tensor, b: torch.Tensor, b_kn: bool = False,
                         alpha: float = 1.0,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's earlier design (``csrc/gemm_tf32x3_lockstep.cu``:
    every thread copies, the consumers split B each chunk, one block
    barrier a chunk), the same function on CUDA tensors: a yardstick that
    ``chip_smoke.py`` and the card's tests time and hold beside the
    kernel, on no path. Counted in its own ``launches``."""
    m, n, k, lead, av, bv, lda, ldb = _check(a, b, b_kn, bias)
    if a.device.type != 'cuda':
        raise ValueError('the lockstep yardstick runs on CUDA tensors only')
    from video_features_torch.ops._kernels import sms
    plan = gemm_plan(av[0] * av[1], m, n, sms(a.device.index))
    c = torch.empty((*lead, m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lockstep_library().vft_gemm_tf32x3_lockstep(
            a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), c.data_ptr(),
            av[0], av[1], m, n, k, av[2], av[3], lda, bv[2], bv[3], ldb,
            int(b_kn), _vec(a, av, lda, k), _vec(b, bv, ldb, n if b_kn else k),
            float(alpha), plan.bm, plan.bn,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'vft_gemm_tf32x3_lockstep failed to launch: CUDA '
                           f'error {rc}')
    gemm_tf32x3_lockstep.launches += 1
    return c


gemm_tf32x3_lockstep.launches = 0


def _vec(t: torch.Tensor, b1b2s: Tuple[int, int, int, int], row: int,
         inner: int) -> int:
    """Whether the lockstep design may copy ``t``'s rows 16 bytes at a
    time: every row starts 16-byte aligned and holds a multiple of 4
    floats."""
    _, _, s1, s2 = b1b2s
    return int(t.data_ptr() % 16 == 0 and row % 4 == 0 and s1 % 4 == 0
               and s2 % 4 == 0 and inner % 4 == 0)


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
        return _launch(a, b, bias, b_kn, alpha)

    def fake(a, b, bias, b_kn, alpha):
        n = b.shape[-1] if b_kn else b.shape[-2]
        return a.new_empty((*a.shape[:-1], n))

    gemm_tf32x3_op.register_fake(fake)
    return gemm_tf32x3_op
