"""Data parallelism over this process's devices (port of
``video_features_tpu/parallel/pipeline.py::setup_data_parallel``).

The JAX package compiles one program over a data mesh; here the params
are copied once per device and each host batch is split into one shard
per device, each launched on its own replica and read back on its own
streams (``extract/base.py``). Inference needs no collective: the JAX
program's replicated output is a gather to the host, which is what the
shards' readbacks, concatenated in shard order, are.

RAFT's pairs are not spread over a ``time`` axis as the JAX package
spreads them (a layout of XLA's): each window's pairs are independent,
so whole windows per device give the same per-window result.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, List, Tuple

from video_features_torch.parallel.mesh import (
    Mesh, make_mesh, replicate, round_batch_to_data_axis, split_batch,
)


def setup_data_parallel(device, batch_size: int, params: Any
                        ) -> Tuple[Mesh, int, List[Any], Callable]:
    """``(mesh, global_batch, replicas, split)``: a data-only mesh over
    this process's devices of ``device``'s kind
    (``utils/device.py::local_devices``), ``batch_size`` rounded up to
    fill the data axis, one copy of ``params`` per device, and the
    callable that splits a host batch into its per-device shards."""
    from video_features_torch.utils.device import local_devices
    mesh = make_mesh(devices=local_devices(device), time_parallel=1)
    return (mesh, round_batch_to_data_axis(batch_size, mesh),
            replicate(params, mesh), partial(split_batch, mesh=mesh))
