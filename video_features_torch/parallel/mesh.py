"""Device meshes for sharded extraction (port of
``video_features_tpu/parallel/mesh.py``).

A mesh is a ``(data, time)`` grid of devices of this process:

  * ``data`` — data parallelism over window or frame batches: one
    replica of the params per device, each host batch split into one
    shard per device (:func:`replicate`, :func:`split_batch`);
  * ``time`` — sequence parallelism: ViT's token axis as a ring over the
    devices (``parallel/ring.py``).

The JAX package compiles one XLA program over the mesh; here one process
drives each device's replica from the host and reads each shard back,
so inference needs no collective and no process group. Several hosts
(or several processes on one) share a worklist instead
(``parallel/worklist.py``). A device may appear in the grid more than
once only when a caller passes such a list (two shards on one card).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

DATA_AXIS = 'data'
TIME_AXIS = 'time'


class Mesh:
    """A ``(data, time)`` grid of devices: ``devices`` is the object
    array, ``shape`` ``{'data': d, 'time': t}``."""

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        self.shape: Dict[str, int] = {DATA_AXIS: int(devices.shape[0]),
                                      TIME_AXIS: int(devices.shape[1])}

    def data_devices(self) -> List[Any]:
        """The first device of each data shard, in shard order."""
        return list(self.devices[:, 0])


def factor_mesh_shape(n: int, time_parallel: Optional[int] = None
                      ) -> Tuple[int, int]:
    """Split ``n`` devices into (data, time) axis sizes; the time axis
    defaults to 2 when ``n`` is even and above 1, else 1."""
    if time_parallel is None:
        time_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n % time_parallel != 0:
        raise ValueError(f'{n} devices do not factor into time={time_parallel}')
    return n // time_parallel, time_parallel


def make_mesh(n_devices: Optional[int] = None,
              time_parallel: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A (data, time) mesh over ``devices`` (default: every local CUDA
    device). ``n_devices=0`` (or None) spans every given device; an
    over-ask raises with the device counts named."""
    if devices is None:
        from video_features_torch.utils.device import local_devices
        devices = local_devices('cuda')
    devices = list(devices)
    if n_devices is not None and n_devices != 0:
        if n_devices > len(devices):
            raise ValueError(
                f'requested {n_devices} devices, have {len(devices)}')
        devices = devices[:n_devices]
    shape = factor_mesh_shape(len(devices), time_parallel)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape))


def round_batch_to_data_axis(batch_size: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh's data-axis size ≥ ``batch_size`` —
    the global batch a data-parallel extractor steps at."""
    d = mesh.shape[DATA_AXIS]
    return -(-batch_size // d) * d


def plan_device_batch(capacity: int, mesh: Mesh) -> int:
    """Global packed batch for a data-parallel mesh: ``capacity`` window
    slots PER device shard (the per-device batch the family's step was
    tuned for), so the packer plans ``capacity × ndev`` slots and every
    device runs at its single-chip batch shape. Raises a clear error —
    not a downstream XLA shape error — when the plan can't fill a shard.
    """
    ndev = mesh.shape[DATA_AXIS]
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError(
            f'mesh-sharded packed batch planning needs capacity >= 1 per '
            f'device shard (got capacity={capacity} over {ndev} '
            f'data-parallel devices): capacity × ndev is the global device '
            f'batch — raise batch_size or lower mesh_devices')
    return capacity * ndev


def shard_error(batch: int, mesh: Mesh) -> Optional[str]:
    """Why a GLOBAL batch of ``batch`` rows cannot shard over the mesh's
    data axis, or None when it can (the non-raising form of
    :func:`require_shardable`)."""
    ndev = mesh.shape[DATA_AXIS]
    if batch % ndev != 0 or batch // ndev < 1:
        return (
            f'packed batch {batch} cannot shard over {ndev} data-parallel '
            f'devices: the global batch must be a positive multiple of the '
            f'device count (capacity × ndev planning — see '
            f'plan_device_batch)')
    return None


def require_shardable(batch: int, mesh: Mesh) -> int:
    """Validate that a GLOBAL batch splits evenly over the data axis,
    raising a named error instead of letting ``device_put`` fail with an
    XLA sharding/shape error. Returns the per-shard capacity."""
    err = shard_error(batch, mesh)
    if err is not None:
        raise ValueError(err)
    return batch // mesh.shape[DATA_AXIS]


def move(value: Any, device) -> Any:
    """``value`` on ``device``: a tensor, a params tree (nested mappings),
    an ``nn.Module`` (copied unless it is there already), or None."""
    import torch
    if value is None:
        return None
    if isinstance(value, torch.nn.Module):
        first = next(value.parameters(), None)
        if first is not None and first.device == torch.device(device):
            return value
        import copy
        return copy.deepcopy(value).to(device)
    if isinstance(value, dict):
        return {k: move(v, device) for k, v in value.items()}
    return value.to(device)


def replicate(params: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``params`` per data shard, on that shard's device (a
    device listed twice shares one copy's tensors)."""
    return [move(params, dev) for dev in mesh.data_devices()]


def split_batch(batch, mesh: Mesh) -> list:
    """A host batch's rows in one contiguous block per data shard, in
    shard order (:func:`require_shardable` first)."""
    per = require_shardable(len(batch), mesh)
    return [batch[i * per:(i + 1) * per] for i in range(mesh.shape[DATA_AXIS])]
