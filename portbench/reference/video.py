"""Plain frame source: every frame of a file through ``cv2.VideoCapture``
as RGB uint8, and PIL's bilinear short-side resize."""
from __future__ import annotations

from typing import Optional

import numpy as np


def decode(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB, every frame in order."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise ValueError(f'no frame decoded from {path}')
    return np.stack(frames)


def short_side_size(h: int, w: int, size: int) -> Optional[tuple]:
    """(out_h, out_w) of PIL's short-side resize, or None when the short
    side already is ``size``; the long side truncates."""
    if min(h, w) == size:
        return None
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def resize_short_side(frames: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image
    geom = short_side_size(frames.shape[1], frames.shape[2], size)
    if geom is None:
        return frames
    oh, ow = geom
    return np.stack([np.asarray(Image.fromarray(f).resize((ow, oh),
                                                          Image.BILINEAR))
                     for f in frames])
