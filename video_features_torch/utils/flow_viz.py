"""Optical-flow → RGB visualization (Middlebury color wheel); a copy of
``video_features_tpu/utils/flow_viz.py`` (numpy only).

The Baker et al. "A Database and Evaluation Methodology for Optical
Flow" color coding: a 55-entry hue wheel (RY/YG/GC/CB/BM/MR segments),
flow vectors normalized by the maximum radius, angle → wheel position,
magnitude → saturation.
"""
from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint-range RGB color wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col:col + RY, 0] = 255
    wheel[col:col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Per-pixel wheel lookup for normalized flow components in [-1, 1]."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    out = np.zeros(u.shape + (3,), np.uint8)
    for ch in range(3):
        col0 = wheel[k0, ch] / 255.0
        col1 = wheel[k1, ch] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])   # saturate with magnitude
        col[~idx] = col[~idx] * 0.75               # out-of-range
        out[..., 2 - ch if convert_to_bgr else ch] = np.floor(255 * col)
    return out


def flow_to_image(flow_uv: np.ndarray, clip_flow: float = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8, normalized by the max radius."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, 'expected (H, W, 2) flow'
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = np.sqrt(u ** 2 + v ** 2).max()
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    return flow_uv_to_colors(u, v, convert_to_bgr)
