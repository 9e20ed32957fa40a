"""The fused two-stream I3D configuration: its comparison and its work.

Compared: the largest rel L2 of one window's rgb half and of its flow
half over every window of the picked videos, and the count of windows
whose rows are missing or misshapen in any video of the sample."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.reference import pipelines, work


def compare(cell, sample: list, weights, device) -> Dict[str, float]:
    """``sample``: [{"clip", "file", "picked"}] of the videos the window
    delivered rows of."""
    p = cell.config_file['program']
    stack, step = int(p['stack_size']), int(p['step_size'])
    crop, iters = int(cell.config_file['crop']), int(p['raft_iters'])
    short = cell.config_file['short_side']
    missing, worst = 0, {'rgb_rel_l2': 0.0, 'flow_rel_l2': 0.0}
    for item in sample:
        want = max((item['clip']['frames'] - stack - 1) // step + 1, 0)
        try:
            feats = np.load(item['file'])
        except (OSError, ValueError):
            missing += want
            continue
        if feats.shape != (want, 2048):
            missing += want
            continue
        if not item['picked']:
            continue
        frames = pipelines.decode_resized(item['clip']['path'], short)
        ref = pipelines.i3d_raft_windows(weights, frames, range(want), stack,
                                         step, iters, crop, device)
        for k in range(want):
            worst['rgb_rel_l2'] = max(
                worst['rgb_rel_l2'], pipelines.rel_l2(feats[k, :1024], ref[k, :1024]))
            worst['flow_rel_l2'] = max(
                worst['flow_rel_l2'], pipelines.rel_l2(feats[k, 1024:], ref[k, 1024:]))
    return dict(worst, missing_windows=float(missing))


def flops(cell) -> Tuple[float, Dict[str, float]]:
    """A window: RAFT's encoders over its stack + 1 frames, the stack's
    pairs refined, both towers. The refinement range is one call per
    step of ``batch`` windows' pairs; the towers' range one call per
    tower and step (the two towers' mean)."""
    p = cell.config_file['program']
    fnet, cnet, refine = work.raft_parts(*work.padded(*work.frame_size(cell)),
                                         int(p['raft_iters']))
    batch, stack = int(p['batch_size']), int(p['stack_size'])
    crop = int(cell.config_file['crop'])
    towers = work.i3d_window('rgb', stack, crop) + work.i3d_window('flow', stack, crop)
    per_window = (stack + 1) * fnet + stack * (cnet + refine) + towers
    return per_window, {'portbench.raft_update': batch * stack * refine,
                        'portbench.i3d_towers': batch * towers / 2}
