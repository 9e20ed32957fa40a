"""Several processes over one worklist: the ``multihost`` runtime (port of
``video_features_tpu/parallel/distributed.py``).

The JAX package brings up ``jax.distributed`` (a coordinator service on
process 0); here :func:`initialize` brings up a ``torch.distributed``
process group on the gloo backend:

  * ``tcp://<coordinator_address>`` when the coordinator keys are given
    (``coordinator_address=host0:port num_processes=N process_id=<rank>``
    on every process; process 0 hosts the rendezvous);
  * ``env://`` when ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are set (the counterpart of the
    JAX package's pod autodetection);
  * otherwise a warning and a one-process run.

Each process then takes its interleaved shard of the worklist
(``parallel/worklist.py``) and runs it on its own device(s); no tensor
crosses processes. The only traffic is the final :func:`barrier`, which
holds every process until all are done. Gloo lets two processes share
one card. ``torch.distributed`` is imported inside the functions.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

# the rendezvous: how long a process waits for the others to join (the
# JAX package's coordinator waits 300 s too)
RENDEZVOUS_TIMEOUT_S = 300.0
# the final barrier: one process may draw much longer videos than another
BARRIER_TIMEOUT_S = 7 * 24 * 3600.0
ENV_KEYS = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> None:
    """Join the process group (a no-op if one is up). With the coordinator
    keys, a rendezvous that cannot complete within ``timeout_s`` raises;
    with none and no ``torchrun`` environment, a warning and a
    one-process run (``process_count()`` is 1, the shard the whole
    list)."""
    from datetime import timedelta
    if is_initialized():
        return
    dist = _dist()
    keys = {'coordinator_address': coordinator_address,
            'num_processes': num_processes, 'process_id': process_id}
    if any(v is not None for v in keys.values()):
        missing = [k for k, v in keys.items() if v is None]
        if missing:
            raise ValueError(
                f'multihost with coordinator_address needs {", ".join(keys)} '
                f'together; missing: {", ".join(missing)}')
        dist.init_process_group(
            'gloo', init_method=f'tcp://{coordinator_address}',
            world_size=int(num_processes), rank=int(process_id),
            timeout=timedelta(seconds=timeout_s))
        return
    if all(k in os.environ for k in ENV_KEYS):
        dist.init_process_group('gloo', init_method='env://',
                                timeout=timedelta(seconds=timeout_s))
        return
    warnings.warn('multihost: no cluster environment detected — '
                  'continuing as a single-process run')


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return _dist().get_world_size() if is_initialized() else 1


def barrier(name: str = 'extraction_done',
            timeout_s: float = BARRIER_TIMEOUT_S) -> None:
    """Hold every process here until all have arrived (a no-op without a
    process group); a process that never arrives raises after
    ``timeout_s``, naming ``name``."""
    from datetime import timedelta
    if process_count() <= 1:
        return
    try:
        _dist().monitored_barrier(timeout=timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f'multihost barrier {name!r} failed: {e}') from e


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()
