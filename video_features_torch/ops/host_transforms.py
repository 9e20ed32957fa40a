"""Host-side PIL frame resize and center crop (copy of
``video_features_tpu/ops/host_transforms.py``: ``pil_edge_resize_geometry``,
``resize_pil``, ``center_crop_host``).

uint8 in, uint8 out. PIL is imported inside :func:`resize_pil` only, so
the package imports on machines without it.
"""
from __future__ import annotations

import numpy as np


def pil_edge_resize_geometry(h: int, w: int, size: int,
                             to_smaller_edge: bool = True):
    """(oh, ow) of a PIL edge resize, or None when it is a no-op: the
    matched edge already equals ``size``; the other side is
    ``int(size * other / edge)`` (truncation, PIL convention)."""
    if (w <= h and w == size) or (h <= w and h == size):
        return None
    if (w < h) == to_smaller_edge:
        return int(size * h / w), size
    return size, int(size * w / h)


def resize_pil(frame: np.ndarray, size: int,
               to_smaller_edge: bool = True,
               interpolation: str = 'bilinear') -> np.ndarray:
    """PIL edge resize of one HWC uint8 frame, aspect preserved."""
    from PIL import Image

    modes = {'bilinear': Image.BILINEAR, 'bicubic': Image.BICUBIC}
    h, w = frame.shape[:2]
    geom = pil_edge_resize_geometry(h, w, size, to_smaller_edge)
    if geom is None:
        return frame
    oh, ow = geom
    return np.asarray(Image.fromarray(frame).resize((ow, oh),
                                                    modes[interpolation]))


def center_crop_host(frame: np.ndarray, size: int) -> np.ndarray:
    """HWC center crop with torchvision's offsets: ``int(round(...))``,
    which rounds half to even."""
    h, w = frame.shape[:2]
    i = int(round((h - size) / 2.0))
    j = int(round((w - size) / 2.0))
    return frame[i:i + size, j:j + size]
