"""The RAFT flow configuration: its comparison and its work.

Compared: the largest rel L2 of one flow field over the pairs drawn in
the sample's videos, and the count of flows missing or misshapen."""
from __future__ import annotations

from typing import Dict, Tuple

from portbench.reference import pipelines, work


def compare(cell, sample: list, weights, device) -> Dict[str, float]:
    """``sample``: [{"clip", "frames_out", "pairs", "flows"}] per video,
    ``flows`` the program's fields at ``pairs``."""
    iters = int(cell.config_file['program']['raft_iters'])
    missing, worst = 0, 0.0
    for item in sample:
        frames = pipelines.decode_resized(item['clip']['path'],
                                          cell.config_file['short_side'])
        flows = item['flows']
        if item['frames_out'] != len(frames) - 1 or \
                flows.shape[1:] != (2,) + frames.shape[1:3]:
            missing += len(frames) - 1
            continue
        ref = pipelines.raft_pair_flows(weights['raft'], frames, item['pairs'],
                                        iters, device)
        for k in range(len(ref)):
            worst = max(worst, pipelines.rel_l2(flows[k], ref[k]))
    return {'flow_rel_l2': worst, 'missing_flows': float(missing)}


def flops(cell) -> Tuple[float, Dict[str, float]]:
    """A flow field: a step of ``batch`` pairs encodes ``batch`` + 1
    frames with the feature net and ``batch`` with the context net, and
    refines each pair; the refinement range is one call per step."""
    p = cell.config_file['program']
    fnet, cnet, refine = work.raft_parts(*work.padded(*work.frame_size(cell)),
                                         int(p['raft_iters']))
    batch = int(p['batch_size'])
    per_flow = ((batch + 1) * fnet + batch * (cnet + refine)) / batch
    return per_flow, {'portbench.raft_update': batch * refine}
