"""RAFT's correlation pyramid and its window lookup: two CUDA kernels,
their plain PyTorch versions, and the dispatch between them.

The lookup runs once per GRU iteration (20 per RAFT forward) at every
pyramid level; on the card each iteration launches one lookup kernel
and, in ``ops/gru.py``, the GRU direction kernel twice: those are all
the hand-written kernels RAFT runs. It samples, for each of the
N = B·H8·W8 pixels and each level i (coords scaled by 2⁻ⁱ), the
(2r+1)² = 81 bilinear samples of the pixel's own correlation map around
(x, y), zeros outside the map
(``grid_sample(align_corners=True, padding_mode='zeros')``). Output
element ``i·(2r+1)+j`` of a level samples ``(x + d[i], y + d[j])``, the
reference's dy-major order; the levels concatenate to (B, H8, W8, 324).

Kernels (``csrc/corr_lookup.cu``, CUDA C++ for sm_90a):

* :func:`lookup_corr_lanes` replaces ``video_features_tpu/ops/
  pallas_corr.py::lookup_corr_lanes`` (``_lanes_kernel``), the TPU's
  default. It reads the levels in their natural (N, h, w) layout and
  masks every read outside the map.
* :func:`lookup_corr` replaces ``pallas_corr.py::lookup_corr``
  (``_level_kernel``), selected by ``VFT_RAFT_LOOKUP=pallas``. It reads
  levels zero-padded once per forward by ``2r+3`` (:func:`pad_pyramid`)
  with clamped coordinates, and has no bounds predicates.

Both are bound by bytes on the H100: each call writes N·324·4 bytes and
reads at most the 10×10 patch of every level per pixel, whose 40-byte
rows cost 2–3 32-byte sectors each. Both share one design (see the
source's note): a block loops over groups of 8 pixels; per (pixel,
level) a warp computes the scale, clamp, floors and weights once and
copies the patch into shared memory with ``cp.async`` (the masked kernel
zero-fills cells outside the map through cp.async's source size, so it
needs no padded copy), two groups' copies in flight while a third
blends; each thread blends 9 outputs from shared memory, and the group's
output rows leave as one run of 16-byte streaming stores. The TPU's
(h, w, N') lane transpose, its 128-lane and 32-row padding, and the
one-hot-matmul "slice" are artifacts of the TPU's tiling and are not
carried over; TMA cannot address the levels' rows (strides not multiples
of 16 bytes), and tensor cores have nothing to do at 9 flops per output.

Each kernel's wrapper launches it on a CUDA tensor (or raises) and
takes its plain version only for a CPU tensor; ``launches`` on the
wrapper counts the kernel launches. While ``torch.export`` traces a
program on CUDA tensors, the wrappers call the kernels through the
``torch.library`` ops ``vft::corr_lookup_lanes`` and ``vft::corr_lookup``
instead (:func:`export_ops`), so each lookup is one node of the exported
graph (``analysis/programs.py`` counts them) and the exported program
launches the same kernel, counted alike. The eager path calls the
kernels directly and pays no dispatcher cost.

The pyramid itself (all-pairs GEMM / √D, then three valid 2×2 average
pools) is a batched ``torch.matmul`` and plain pooling, as the JAX
package left it to XLA.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CORR_LEVELS = 4
CORR_RADIUS = 4
LOOKUP_IMPLS = ('auto', 'dense', 'gather', 'pallas', 'lanes')


def _pad(radius: int) -> int:
    return 2 * radius + 3


# -- pyramid -------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       levels: int = CORR_LEVELS) -> List[torch.Tensor]:
    """(B, H, W, D) feature maps → levels (B·H·W, H/2ⁱ, W/2ⁱ), contiguous.

    Level 0 is the all-pairs volume ``f1·f2ᵀ/√D``; each next level is a
    valid 2×2 stride-2 average pool of the one before (an odd trailing
    row or column is dropped).
    """
    B, H, W, D = fmap1.shape
    f1 = fmap1.reshape(B, H * W, D)
    f2 = fmap2.reshape(B, H * W, D)
    corr = torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(D)
    corr = corr.reshape(B * H * W, H, W)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr.unsqueeze(1), 2, 2).squeeze(1)
        pyramid.append(corr)
    return pyramid


def pad_pyramid(pyramid: Sequence[torch.Tensor],
                radius: int = CORR_RADIUS) -> List[torch.Tensor]:
    """Zero-pad every level by ``2r+3`` on each side, once per forward:
    (N, h, w) → (N, h + 2·PAD, w + 2·PAD)."""
    pad = _pad(radius)
    return [F.pad(level, (pad, pad, pad, pad)) for level in pyramid]


# -- plain versions --------------------------------------------------------------

def lookup_corr_lanes_plain(levels: Sequence[torch.Tensor],
                            coords: torch.Tensor,
                            radius: int = CORR_RADIUS) -> torch.Tensor:
    """Plain version of :func:`lookup_corr_lanes`, mirroring
    ``video_features_tpu/models/raft.py::lookup_corr_dense``: per level two
    batched contractions against bilinear weight matrices with two
    nonzeros per row; an index outside the map never matches, which is
    the zeros padding.

    levels: (N, h, w) each; coords: (B, H, W, 2) level-0 (x, y).
    """
    B, H, W, _ = coords.shape
    p1 = 2 * radius + 1
    flat = coords.reshape(-1, 2)
    d = torch.arange(-radius, radius + 1, device=coords.device)
    out = []
    for i, corr in enumerate(levels):
        n, h, w = corr.shape
        c = flat / (2.0 ** i)
        x0 = torch.floor(c[:, 0])
        y0 = torch.floor(c[:, 1])
        fx = c[:, 0] - x0
        fy = c[:, 1] - y0
        xi = x0.long()[:, None] + d[None, :]                 # (N, p1)
        yi = y0.long()[:, None] + d[None, :]

        def weights(base, frac, extent):
            ids = torch.arange(extent, device=coords.device)[None, None, :]
            lo = (ids == base[:, :, None]).to(corr.dtype)
            hi = (ids == (base + 1)[:, :, None]).to(corr.dtype)
            return lo * (1 - frac)[:, None, None] + hi * frac[:, None, None]

        wx = weights(xi, fx, w)                              # (N, p1, w)
        wy = weights(yi, fy, h)                              # (N, p1, h)
        t = torch.bmm(wx, corr.transpose(1, 2))              # (N, p1, h): x blend
        o = torch.bmm(t, wy.transpose(1, 2))                 # (N, p1, p1): y blend
        out.append(o.reshape(n, p1 * p1))
    return torch.cat(out, dim=-1).reshape(B, H, W, -1)


def lookup_corr_plain(padded: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int = CORR_RADIUS) -> torch.Tensor:
    """Plain version of :func:`lookup_corr`: the gather formulation
    (``video_features_tpu/models/raft.py::lookup_corr``) over the padded
    levels of :func:`pad_pyramid`, with the TPU window-slice kernel's
    coordinate clamp and 4-term blend — one (2r+2)² patch per pixel and
    level, no bounds masks."""
    B, H, W, _ = coords.shape
    pad = _pad(radius)
    p1 = 2 * radius + 1
    p2 = p1 + 1
    flat = coords.reshape(-1, 2)
    ar = torch.arange(p2, device=coords.device)
    out = []
    for i, level in enumerate(padded):
        n, hp, wp = level.shape
        h, w = hp - 2 * pad, wp - 2 * pad
        c = flat / (2.0 ** i)
        x = c[:, 0].clamp(-radius - 2.0, w + radius + 1.0)
        y = c[:, 1].clamp(-radius - 2.0, h + radius + 1.0)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx = (x - x0)[:, None, None]
        wy = (y - y0)[:, None, None]
        xs = x0.long() - radius + pad
        ys = y0.long() - radius + pad
        idx = ((ys[:, None] + ar)[:, :, None] * wp
               + (xs[:, None] + ar)[:, None, :])             # (N, p2 y, p2 x)
        patch = torch.gather(level.reshape(n, hp * wp), 1,
                             idx.reshape(n, p2 * p2))
        patch = patch.reshape(n, p2, p2).transpose(1, 2)     # [x, y]
        o = ((1 - wx) * (1 - wy) * patch[:, :p1, :p1]
             + wx * (1 - wy) * patch[:, 1:, :p1]
             + (1 - wx) * wy * patch[:, :p1, 1:]
             + wx * wy * patch[:, 1:, 1:])
        out.append(o.reshape(n, p1 * p1))
    return torch.cat(out, dim=-1).reshape(B, H, W, -1)


# -- kernels ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from video_features_torch.ops import _kernels
    lib = _kernels.load('corr_lookup')
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p])
    for name in ('vft_corr_lookup_masked', 'vft_corr_lookup_padded'):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(levels: Sequence[torch.Tensor], coords: torch.Tensor,
           radius: int, pad: int) -> None:
    """Raise on anything the kernels do not take."""
    if coords.dtype != torch.float32 or coords.ndim != 4 \
            or coords.shape[-1] != 2 or not coords.is_contiguous():
        raise ValueError('coords must be a contiguous float32 (B, H, W, 2) '
                         f'tensor; got {coords.dtype} {tuple(coords.shape)} '
                         f'contiguous={coords.is_contiguous()}')
    if len(levels) != CORR_LEVELS:
        raise ValueError(f'expected {CORR_LEVELS} pyramid levels; got '
                         f'{len(levels)}')
    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    for i, level in enumerate(levels):
        if level.dtype != torch.float32 or level.ndim != 3 \
                or not level.is_contiguous() or level.shape[0] != n \
                or level.device != coords.device \
                or min(level.shape[1:]) <= 2 * pad:
            raise ValueError(
                f'level {i} must be a contiguous float32 (N={n}, h, w) '
                f'tensor on {coords.device} (padded by {pad} per side); got '
                f'{level.dtype} {tuple(level.shape)} on {level.device}, '
                f'contiguous={level.is_contiguous()}')
    if coords.device.type == 'cuda' and radius != CORR_RADIUS:
        raise ValueError(f'the CUDA kernels are built for radius '
                         f'{CORR_RADIUS}; got {radius}')
    if coords.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {coords.device}')


def _launch(name: str, levels: Sequence[torch.Tensor], coords: torch.Tensor,
            pad: int) -> torch.Tensor:
    B, H, W, _ = coords.shape
    p1 = 2 * CORR_RADIUS + 1
    out = torch.empty((B, H, W, CORR_LEVELS * p1 * p1), dtype=torch.float32,
                      device=coords.device)
    dims = []
    for level in levels:
        dims += [level.shape[1] - 2 * pad, level.shape[2] - 2 * pad]
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), name)(
            *[level.data_ptr() for level in levels], *dims,
            coords.data_ptr(), out.data_ptr(), B * H * W, stream)
    if rc != 0:
        raise RuntimeError(f'{name} failed to launch: CUDA error {rc}')
    return out


def _launch_masked(levels: Sequence[torch.Tensor],
                   coords: torch.Tensor) -> torch.Tensor:
    out = _launch('vft_corr_lookup_masked', levels, coords, pad=0)
    lookup_corr_lanes.launches += 1
    return out


def _launch_padded(padded: Sequence[torch.Tensor],
                   coords: torch.Tensor) -> torch.Tensor:
    out = _launch('vft_corr_lookup_padded', padded, coords,
                  pad=_pad(CORR_RADIUS))
    lookup_corr.launches += 1
    return out


def _contiguous(levels: Sequence[torch.Tensor], coords: torch.Tensor):
    """A trace's inputs to a lookup op, contiguous as the kernels take
    them: a trace's layouts are its tracer's (a no-op where they are)."""
    return [level.contiguous() for level in levels], coords.contiguous()


def lookup_corr_lanes(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int = CORR_RADIUS) -> torch.Tensor:
    """Masked lookup over (N, h, w) levels → (B, H, W, 4·(2r+1)²).

    CUDA tensors launch ``vft_corr_lookup_masked`` (through
    ``vft::corr_lookup_lanes`` while exporting); CPU tensors run
    :func:`lookup_corr_lanes_plain`.
    """
    exporting = torch.compiler.is_exporting()
    if exporting:
        levels, coords = _contiguous(levels, coords)
    _check(levels, coords, radius, pad=0)
    if coords.device.type == 'cpu':
        return lookup_corr_lanes_plain(levels, coords, radius)
    if exporting:
        return export_ops().corr_lookup_lanes(levels, coords, radius)
    return _launch_masked(levels, coords)


lookup_corr_lanes.launches = 0


def lookup_corr(padded: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """Lookup over :func:`pad_pyramid` levels → (B, H, W, 4·(2r+1)²).

    CUDA tensors launch ``vft_corr_lookup_padded`` (through
    ``vft::corr_lookup`` while exporting); CPU tensors run
    :func:`lookup_corr_plain`.
    """
    exporting = torch.compiler.is_exporting()
    if exporting:
        padded, coords = _contiguous(padded, coords)
    _check(padded, coords, radius, pad=_pad(radius))
    if coords.device.type == 'cpu':
        return lookup_corr_plain(padded, coords, radius)
    if exporting:
        return export_ops().corr_lookup(padded, coords, radius)
    return _launch_padded(padded, coords)


lookup_corr.launches = 0


@functools.lru_cache(maxsize=None)
def export_ops():
    """The lookups as ``torch.library`` ops, registered on first use:
    ``vft::corr_lookup_lanes`` and ``vft::corr_lookup``. Their CUDA
    implementations launch the kernels (counted in ``launches``); their
    fake implementations give the output's shape, so ``torch.export``
    traces them as single nodes on fake or real CUDA tensors."""
    import types

    def out_like(coords, radius):
        B, H, W, _ = coords.shape
        return coords.new_empty((B, H, W, CORR_LEVELS * (2 * radius + 1) ** 2))

    @torch.library.custom_op('vft::corr_lookup_lanes', mutates_args=(),
                             device_types='cuda')
    def corr_lookup_lanes(levels: List[torch.Tensor], coords: torch.Tensor,
                          radius: int) -> torch.Tensor:
        _check(levels, coords, radius, pad=0)
        return _launch_masked(levels, coords)

    @torch.library.custom_op('vft::corr_lookup', mutates_args=(),
                             device_types='cuda')
    def corr_lookup(padded: List[torch.Tensor], coords: torch.Tensor,
                    radius: int) -> torch.Tensor:
        _check(padded, coords, radius, pad=_pad(radius))
        return _launch_padded(padded, coords)

    corr_lookup_lanes.register_fake(
        lambda levels, coords, radius: out_like(coords, radius))
    corr_lookup.register_fake(
        lambda padded, coords, radius: out_like(coords, radius))
    return types.SimpleNamespace(corr_lookup_lanes=corr_lookup_lanes,
                                 corr_lookup=corr_lookup)


# -- dispatch --------------------------------------------------------------------

def lookup_impl_from_env(environ: Optional[Mapping[str, str]] = None) -> str:
    """The ``VFT_RAFT_LOOKUP`` value (``VFT_RAFT_PALLAS=1`` → 'pallas'),
    read as ``video_features_tpu/models/raft.py::_lookup_impl`` reads it."""
    env = os.environ if environ is None else environ
    if env.get('VFT_RAFT_PALLAS') == '1':
        return 'pallas'
    impl = env.get('VFT_RAFT_LOOKUP', 'auto')
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f'VFT_RAFT_LOOKUP must be one of {LOOKUP_IMPLS}; '
                         f'got {impl!r}')
    return impl


Prep = Callable[[List[torch.Tensor]], List[torch.Tensor]]
Lookup = Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor]


def select_lookup(impl: str, device, plain: bool = False) -> Tuple[Prep, Lookup]:
    """``(prep, lookup)`` for one RAFT forward: ``prep`` runs once on the
    pyramid, ``lookup(prepped, coords)`` once per iteration.

    On the card 'auto' and 'lanes' take the masked kernel and 'pallas'
    the padded one; 'dense' and 'gather' name plain versions, which never
    run on the card's main path, and raise. On the CPU every value runs a
    plain version. ``plain=True`` swaps in the plain version of the
    selected kernel on any device (to compare the two on the card).
    """
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f'lookup impl must be one of {LOOKUP_IMPLS}; got '
                         f'{impl!r}')
    if torch.device(device).type == 'cuda' and impl in ('dense', 'gather'):
        raise ValueError(
            f'VFT_RAFT_LOOKUP={impl!r} names a plain lookup, which does not '
            f"run on the card: use 'auto', 'lanes' or 'pallas'")
    if impl in ('pallas', 'gather'):
        return pad_pyramid, (lookup_corr_plain if plain else lookup_corr)
    return list, (lookup_corr_lanes_plain if plain else lookup_corr_lanes)
