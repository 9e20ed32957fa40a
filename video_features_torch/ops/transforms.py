"""Tensor transforms of the I3D path (port of ``video_features_tpu/
ops/transforms.py``: ``scale_to_pm1``, ``center_crop``,
``flow_to_uint8_levels``). Layout is channels-last (..., H, W, C)."""
from __future__ import annotations

from typing import Tuple, Union

import torch


def scale_to_pm1(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] → [-1, 1] via 2x/255 - 1; uint8 or float in, float32 out."""
    return x.to(torch.float32) * (2.0 / 255.0) - 1.0


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
