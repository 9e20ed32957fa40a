"""The clips a traffic mix plays: smooth moving patterns (a periodic
low-pass texture panned across the frame, with a second texture's patch
moving against it), written with cv2's MJPG writer. A corpus depends
only on its spec, never on a run's seed, and is made once per checkout
under ``portbench/.corpus/<name>-<digest>/``; ``manifest.json`` is
written last, so a corpus without it is made again."""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

CORPUS_ROOT = Path(__file__).resolve().parents[1] / '.corpus'


def digest(spec: dict) -> str:
    return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:12]


def _texture(rng: np.random.RandomState, h: int, w: int, cutoff: float) -> np.ndarray:
    """(h, w, 3) float in [0, 1]: white noise low-passed in the Fourier
    domain, so it tiles (the pan wraps without a seam)."""
    noise = rng.standard_normal((3, h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    keep = np.exp(-(fx ** 2 + fy ** 2) / (2 * cutoff ** 2))
    tex = np.real(np.fft.ifft2(np.fft.fft2(noise) * keep))
    tex = (tex - tex.mean()) / (tex.std() + 1e-12)
    return np.clip(0.5 + 0.18 * tex, 0.0, 1.0).transpose(1, 2, 0)


def clip_frames(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8: the background pans at a constant velocity of
    up to 4 px a frame, and a square a third of the frame's height moves
    across it at another."""
    rng = np.random.RandomState(seed)
    bg = _texture(rng, h, w, 0.02)
    fg = _texture(rng, h, w, 0.05)
    side = max(h // 3, 8)
    v_bg = rng.uniform(-4, 4, size=2)
    v_fg = rng.uniform(-6, 6, size=2)
    p0 = rng.uniform(0, 1, size=2) * (h - side, w - side)
    out = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        dy, dx = np.round(v_bg * t).astype(int)
        frame = np.roll(bg, (dy, dx), axis=(0, 1))
        y, x = (p0 + v_fg * t).astype(int)
        y, x = y % (h - side), x % (w - side)
        frame[y:y + side, x:x + side] = fg[y:y + side, x:x + side]
        out[t] = (frame * 255.0 + 0.5).astype(np.uint8)
    return out


def write_mjpg(path: Path, frames: np.ndarray, fps: float) -> None:
    import cv2
    h, w = frames.shape[1:3]
    tmp = path.with_suffix('.part.avi')
    writer = cv2.VideoWriter(str(tmp), cv2.VideoWriter_fourcc(*'MJPG'),
                             float(fps), (w, h))
    if not writer.isOpened():
        raise RuntimeError(f'cv2 cannot write MJPG at {w}x{h}: {tmp}')
    try:
        for f in frames:
            writer.write(np.ascontiguousarray(f[..., ::-1]))   # RGB → BGR
    finally:
        writer.release()
    os.replace(tmp, path)


def ensure(spec: dict, root: Path = CORPUS_ROOT) -> List[Dict]:
    """The corpus of ``spec`` ({"name", "seed", "fps", "clips": [[frames,
    height, width], ...]}), made if missing: [{"path", "frames", "height",
    "width"}] in spec order."""
    where = root / f'{spec["name"]}-{digest(spec)}'
    manifest = where / 'manifest.json'
    if not manifest.exists():
        where.mkdir(parents=True, exist_ok=True)
        for i, (n, h, w) in enumerate(spec['clips']):
            write_mjpg(where / f'clip_{i:03d}.avi',
                       clip_frames(int(spec['seed']) * 1000 + i, n, h, w),
                       spec['fps'])
        manifest.write_text(json.dumps(spec['clips']))
    return [{'path': str(where / f'clip_{i:03d}.avi'), 'frames': n,
             'height': h, 'width': w}
            for i, (n, h, w) in enumerate(spec['clips'])]
