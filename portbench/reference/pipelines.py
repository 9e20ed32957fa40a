"""What each configuration's timed path computes, written plainly from
the frames of a file: the fused two-stream I3D features (rgb‖flow) of
video_features' i3d extractor, and the RAFT flow fields of its raft
extractor. Run with TF32 off (:func:`fp32_scope`)."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import i3d, raft, video


@contextmanager
def fp32_scope():
    """TF32 off for cuBLAS and cuDNN, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Crop the last two axes with torchvision's CenterCrop offsets."""
    h, w = x.shape[-2:]
    i = int(round((h - size) / 2.0))
    j = int(round((w - size) / 2.0))
    return x[..., i:i + size, j:j + size]


def quantize_flow(flow: torch.Tensor, bound: float = 20.0) -> torch.Tensor:
    """kinetics-i3d's flow input: clamp to ±bound, round to the uint8
    levels round(128 + 255/(2·bound)·x), then 2x/255 - 1."""
    levels = torch.round(128.0 + flow.clamp(-bound, bound) * (255.0 / (2 * bound)))
    return levels * (2.0 / 255.0) - 1.0


def padded_pairs_flow(sd_raft, frames: torch.Tensor, iters: int) -> torch.Tensor:
    """(T, 3, H, W) uint8 → (T-1, 2, H', W') flow on the frames
    replicate-padded to multiples of 8 (the pad kept)."""
    pads = raft.pad_amounts(*frames.shape[-2:])
    padded = F.pad(frames.float(), pads, mode='replicate')
    return raft.flows(sd_raft, padded, iters)


def i3d_raft_windows(weights: Dict[str, dict], frames: np.ndarray,
                     windows: Iterable[int], stack: int, step: int,
                     iters: int, crop: int, device) -> np.ndarray:
    """Features of the given windows of one video's resized frames
    (T, H, W, 3): (len(windows), 2048), rgb then flow. Window k spans
    frames [k·step, k·step + stack + 1): the rgb stream takes its first
    ``stack`` frames, the flow stream the ``stack`` flows between them."""
    rows: List[np.ndarray] = []
    with fp32_scope():
        for k in windows:
            w = torch.from_numpy(frames[k * step:k * step + stack + 1]).to(device)
            w = w.permute(0, 3, 1, 2)                        # (S+1, 3, H, W)
            rgb = center_crop(w[:-1], crop).float() * (2.0 / 255.0) - 1.0
            rgb_feat = i3d.features(weights['rgb'],
                                    rgb.permute(1, 0, 2, 3)[None])
            flow = center_crop(padded_pairs_flow(weights['raft'], w, iters), crop)
            flow_feat = i3d.features(weights['flow'],
                                     quantize_flow(flow).permute(1, 0, 2, 3)[None])
            rows.append(torch.cat([rgb_feat, flow_feat], dim=1)[0].cpu().numpy())
    return np.stack(rows)


def raft_pair_flows(sd_raft, frames: np.ndarray, pairs: List[int], iters: int,
                    device, block: int = 8) -> np.ndarray:
    """Flows (len(pairs), 2, H, W) from frame p to p + 1 for each p of
    ``pairs`` in one video's frames (T, H, W, 3), padded to multiples of
    8 and unpadded; ``block`` pairs at a time."""
    out = []
    with fp32_scope():
        for i in range(0, len(pairs), block):
            idx = list(pairs[i:i + block])
            first = torch.from_numpy(frames[idx]).to(device).permute(0, 3, 1, 2)
            second = torch.from_numpy(frames[[p + 1 for p in idx]]).to(device)
            second = second.permute(0, 3, 1, 2)
            l, r, t, b = raft.pad_amounts(*first.shape[-2:])
            flow = raft.pair_flows(sd_raft, F.pad(first.float(), (l, r, t, b), mode='replicate'),
                                   F.pad(second.float(), (l, r, t, b), mode='replicate'),
                                   iters)
            h, w = flow.shape[-2:]
            out.append(flow[:, :, t:h - b, l:w - r].cpu().numpy())
    return np.concatenate(out)


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||; inf where either holds a non-finite value."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float('inf')
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def decode_resized(path: str, short_side) -> np.ndarray:
    frames = video.decode(path)
    return frames if short_side is None else video.resize_short_side(frames, short_side)
