"""Work counted from shapes: ``torch.utils.flop_counter.FlopCounterMode``
(2 FLOPs per multiply-add) over the plain reference on the ``meta``
device, once per shape, whatever the program runs instead. RAFT's
loop-invariant context terms count once per pair, as the reference
hoists them; the mask head once per pair, after the loop."""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import i3d, raft, video


def _meta_sd(leaves):
    return {name: torch.empty(shape, device='meta') for name, shape, _ in leaves}


def _count(fn, *args) -> float:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


@lru_cache(maxsize=None)
def raft_parts(h: int, w: int, iters: int) -> Tuple[float, float, float]:
    """(fnet per frame, cnet per frame, refine per pair) at a padded
    (h, w) frame."""
    sd = _meta_sd(raft.leaves())
    frame = torch.empty(1, 3, h, w, device='meta')
    fnet = _count(raft.encoder, sd, 'fnet', frame, False)
    cnet = _count(raft.encoder, sd, 'cnet', frame, True)
    fmap = torch.empty(1, 256, h // 8, w // 8, device='meta')
    refine = _count(raft.refine, sd, fmap, fmap, fmap, iters)
    return fnet, cnet, refine


@lru_cache(maxsize=None)
def i3d_window(modality: str, frames: int, crop: int) -> float:
    sd = _meta_sd(i3d.leaves(modality))
    x = torch.empty(1, 3 if modality == 'rgb' else 2, frames, crop, crop,
                    device='meta')
    return _count(i3d.features, sd, x)


def padded(h: int, w: int) -> Tuple[int, int]:
    l, r, t, b = raft.pad_amounts(h, w)
    return h + t + b, w + l + r


def frame_size(cell) -> Tuple[int, int]:
    """(h, w) of the frames the program's RAFT sees in ``cell``: the
    corpus's first clip, resized to the configuration's short side."""
    _, h, w = cell.traffic['corpus']['clips'][0]
    short = cell.config_file.get('short_side')
    return (video.short_side_size(h, w, short) or (h, w)) if short else (h, w)
