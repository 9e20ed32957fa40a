"""Tensor transforms on the device (port of ``video_features_tpu/ops/
transforms.py``). Layout is channels-last (..., H, W, C).

  * ``resize_bilinear`` and ``resize_bilinear_scale`` are torch's
    ``F.interpolate(mode='bilinear', align_corners=False)`` without
    antialias: two taps per output pixel and axis, blended from the
    float32 weights the JAX package computes (its interpolation matrices
    and ``jax.image.resize``'s grid);
  * ``pil_resize_bilinear_device`` is Pillow's fixed-point BILINEAR
    resample, bit for bit, in int32 multiply-adds over each output
    pixel's tap window, so it is exact on any device and under any
    matmul precision setting.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch


def to_float_zero_one(x: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → float [0, 1] in ``dtype`` (the lane's activation
    dtype: bf16 on the bf16 lane)."""
    return x.to(dtype) / 255.0


def scale_to_pm1(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] → [-1, 1] via 2x/255 - 1; uint8 or float in, float32 out."""
    return x.to(torch.float32) * (2.0 / 255.0) - 1.0


def normalize(x: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """Per-channel (x - mean) / std over the trailing axis."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _scale_taps(in_len: int, out_len: int, scale: float):
    """(lo, hi, w_lo, w_hi) of torch's align_corners=False grid at a
    GIVEN scale: src = (dst + 0.5) / scale - 0.5, clamped to [0, in_len -
    1]; the JAX package's ``_interp_matrix`` holds the same weights."""
    src = np.maximum((np.arange(out_len) + 0.5) / scale - 0.5, 0.0)
    src = np.minimum(src, in_len - 1)
    lo = np.floor(src).astype(np.int64)
    w = (src - lo).astype(np.float32)
    return lo, np.minimum(lo + 1, in_len - 1), np.float32(1.0) - w, w


def _resize_taps(in_len: int, out_len: int):
    """(lo, hi, w_lo, w_hi) of ``jax.image.resize(method='bilinear',
    antialias=False)``'s float32 grid at scale out/in: a triangle kernel
    at the sample position, taps outside the image dropped and the rest
    renormalized (the clamp of torch's grid, in other rounding)."""
    inv = np.float32(1.0 / (out_len / in_len))
    src = (np.arange(out_len, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    lo = np.floor(src).astype(np.int64)
    taps = []
    for i in (lo, lo + 1):
        w = np.maximum(np.float32(0), np.float32(1) - np.abs(src - i.astype(
            np.float32)))
        taps.append((np.clip(i, 0, in_len - 1),
                     np.where((i >= 0) & (i < in_len), w, np.float32(0))))
    total = taps[0][1] + taps[1][1]
    total = np.where(total != 0, total, np.float32(1))
    return (taps[0][0], taps[1][0], taps[0][1] / total, taps[1][1] / total)


def _lerp_axis(x: torch.Tensor, dim: int, lo, hi, w_lo, w_hi) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[dim] = len(lo)

    def dev(a):     # the weights in x's dtype: a bf16 input stays bf16
        t = torch.from_numpy(a).to(x.device)
        return t.to(x.dtype) if t.is_floating_point() else t
    return (x.index_select(dim, dev(lo)) * dev(w_lo).reshape(shape)
            + x.index_select(dim, dev(hi)) * dev(w_hi).reshape(shape))


def resize_bilinear_scale(x: torch.Tensor, size: Tuple[int, int],
                          scale: float) -> torch.Tensor:
    """Bilinear resize of float (..., H, W, C) to (..., *size, C) whose
    sampling grid uses the GIVEN scale, as torch's ``F.interpolate(...,
    scale_factor=s, recompute_scale_factor=False)`` does; the grid then
    differs from out/in on the axis whose size was floored."""
    h, w = x.shape[-3], x.shape[-2]
    x = _lerp_axis(x, x.ndim - 3, *_scale_taps(h, size[0], scale))
    return _lerp_axis(x, x.ndim - 2, *_scale_taps(w, size[1], scale))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of float (..., H, W, C) to (..., *size, C):
    half-pixel centers, no antialias (``F.interpolate(size=...,
    align_corners=False)``); an axis already at its size is left as is."""
    for dim, out_len in ((x.ndim - 3, size[0]), (x.ndim - 2, size[1])):
        if x.shape[dim] != out_len:
            x = _lerp_axis(x, dim, *_resize_taps(x.shape[dim], out_len))
    return x


PIL_PRECISION_BITS = 32 - 8 - 2   # Pillow Resample.c PRECISION_BITS


def _pil_taps(in_size: int, out_size: int):
    """Pillow's fixed-point BILINEAR coefficients per output pixel, as
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` of Resample.c
    compute them (a triangle filter widened by the scale when
    downscaling, window [xmin, xmax) from ``int(center ± support + 0.5)``,
    weights normalized in double, then ``int(±0.5 + k·2^22)``): (taps,
    out) int64 source indices and (taps, out) int32 coefficients, a
    window shorter than the widest padded with coefficient 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale              # bilinear support = 1.0 · filterscale
    ss = 1.0 / filterscale
    windows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = np.maximum(0.0, 1.0 - np.abs((np.arange(xmin, xmax) - center + 0.5)
                                         * ss))
        tot = k.sum()
        if tot != 0.0:
            k = k / tot
        windows.append((xmin, np.floor(np.where(
            k < 0, -0.5 + k * (1 << PIL_PRECISION_BITS),
            0.5 + k * (1 << PIL_PRECISION_BITS)))))
    taps = max(len(k) for _, k in windows)
    idx = np.zeros((taps, out_size), np.int64)
    coeff = np.zeros((taps, out_size), np.int32)
    for xx, (xmin, k) in enumerate(windows):
        idx[:, xx] = xmin              # padding taps: coefficient 0
        idx[:len(k), xx] += np.arange(len(k))
        coeff[:len(k), xx] = k
    return idx, coeff


def _pil_resample_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """One Pillow 8bpc pass over ``dim`` of int32 pixel values:
    ``clip8(2^21 + Σ pixel·coeff) >> 22``. The accumulator stays below
    255·2^22 + 2^21 < 2^31."""
    idx, coeff = _pil_taps(x.shape[dim], out_size)
    shape = [1] * x.ndim
    shape[dim] = out_size
    idx = torch.from_numpy(idx).to(x.device)
    coeff = torch.from_numpy(coeff).to(x.device)
    acc = torch.full((), 1 << (PIL_PRECISION_BITS - 1), dtype=torch.int32,
                     device=x.device)
    for t in range(idx.shape[0]):
        acc = acc + x.index_select(dim, idx[t]) * coeff[t].reshape(shape)
    out = torch.clamp(acc >> PIL_PRECISION_BITS, 0, 255)
    out = torch.where(acc >= (1 << PIL_PRECISION_BITS << 8), 255, out)
    return torch.where(acc <= 0, 0, out)


def pil_resize_bilinear_device(x: torch.Tensor,
                               size: Tuple[int, int]) -> torch.Tensor:
    """BIT-EXACT Pillow bilinear resize on the tensor's device: (..., H,
    W, C) uint8-valued (uint8, or float holding integers) → (..., oh, ow,
    C) uint8.

    ``PIL.Image.resize(size, BILINEAR)``: the horizontal pass first, then
    the vertical one, with a uint8 intermediate between them. Integer
    arithmetic throughout, so no TF32 or matmul precision setting
    reaches it.
    """
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = size
    x = x.to(torch.int32)
    if ow != w:
        x = _pil_resample_axis(x, x.ndim - 2, ow)
    if oh != h:
        x = _pil_resample_axis(x, x.ndim - 3, oh)
    return x.to(torch.uint8)


def center_crop(x: torch.Tensor, size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Center crop of (..., H, W, C) with torch CenterCrop's offsets."""
    if isinstance(size, int):
        size = (size, size)
    th, tw = size
    h, w = x.shape[-3], x.shape[-2]
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return x[..., i:i + th, j:j + tw, :]


def flow_to_uint8_levels(x: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """Flow [-bound, bound] → quantized [0, 255] levels, kept as float.

    The kinetics-i3d recipe ``round(128 + 255/(2·bound)·x)``: the offset
    is 128, not 127.5, so zero flow lands on level 128. ``torch.round``
    rounds half to even like ``jnp.round``, and exactly saturated
    positive flow gives 256.0, which is kept unclipped as the reference
    does.
    """
    x = torch.clamp(x, -bound, bound)
    return torch.round(128.0 + x * (255.0 / (2.0 * bound)))
