"""Sequence-parallel (ring) attention over a mesh axis (port of
``video_features_tpu/parallel/ring.py``).

:func:`sequence_sharded_attention` takes global (B, S, H, D) tensors and
a mesh, splits the sequence over the devices of the ``time`` axis, runs
:func:`video_features_torch.ops.attention.ring_attention` over the
shards, and gathers the result on the first device.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from video_features_torch.ops.attention import ring_attention
from video_features_torch.parallel.mesh import TIME_AXIS, Mesh


def axis_devices(mesh: Mesh, axis: str = TIME_AXIS) -> List:
    """The devices along ``axis`` of the mesh's first row or column."""
    return list(mesh.devices[0, :] if axis == TIME_AXIS else mesh.devices[:, 0])


def sequence_sharded_attention(mesh: Mesh, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, axis: str = TIME_AXIS,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with q, k, v sequence-split over ``mesh[axis]``; the
    axis size must divide S. Returns (B, S, H, D) on ``q``'s device."""
    devices = axis_devices(mesh, axis)
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(f'sequence length {q.shape[1]} does not split over '
                         f'{n} devices of the {axis!r} axis')

    def shards(t):
        return [c.to(d) for c, d in zip(t.chunk(n, dim=1), devices)]

    out = ring_attention(shards(q), shards(k), shards(v), scale=scale)
    return torch.cat([o.to(q.device) for o in out], dim=1)
