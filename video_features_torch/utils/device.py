"""Device resolution and the matmul precision lanes.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A
request for a GPU on a machine without one raises; the port never falls
back to the CPU.

Precision: ``precision`` takes the JAX package's seven values
(:data:`PRECISIONS`). On the card a value decides two things
(:data:`LANES`): whether cuDNN and cuBLAS may run float32 convolutions
and matmuls in TF32 (about three decimal digits), and how many TF32
products the GRU direction kernel (``csrc/gru_direction.cu``) issues per
fp32 one: 3 (3xTF32, fp32-class) or 1.

  * ``highest``, ``float32``: TF32 off, the kernel in 3xTF32. ``float32``
    is the JAX package's name for ``highest``: the same bytes.
  * ``high``, ``mixed``: TF32 on, the kernel in 3xTF32. ``mixed`` is the
    JAX package's ambient ``high`` with no pins; the libraries have no
    three-pass mode, so only the hand kernel keeps JAX's three passes.
  * ``default``, ``tensorfloat32``, ``bfloat16``: TF32 on, the kernel in
    1xTF32 (one-pass modes in JAX).

The two library flags are process-wide torch settings, read when a
kernel is launched on the host, so :func:`precision_scope` sets them
around each step's dispatch and restores them after: two extractors on
different lanes in one process each run on their own. Extractors never
set them for the whole process; :func:`set_precision` does, for scripts
that call the models and kernels directly.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

import torch

PRECISIONS = ('default', 'high', 'highest', 'mixed', 'bfloat16',
              'tensorfloat32', 'float32')

# precision → (TF32 in cuDNN and cuBLAS, TF32 products per fp32 product
# in the GRU direction kernel)
LANES: Dict[str, Tuple[bool, int]] = {
    'highest': (False, 3), 'float32': (False, 3),
    'high': (True, 3), 'mixed': (True, 3),
    'default': (True, 1), 'tensorfloat32': (True, 1), 'bfloat16': (True, 1),
}


def resolve_device(device) -> torch.device:
    """``'cuda'``, ``'cuda:N'`` or ``'cpu'`` → a ``torch.device``.

    Raises when a GPU is asked for and none is present, naming the
    ``device`` key so the caller knows how to run on the CPU instead.
    """
    name = 'cuda' if device is None else str(device).strip().lower()
    if name == 'cpu':
        return torch.device('cpu')
    if name == 'cuda' or name.startswith('cuda:'):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device={device!r} but no CUDA device is available. The '
                f'port does not fall back to the CPU: set `device=cpu` to '
                f'run there.')
        dev = torch.device(name)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise ValueError(
                f'device={device!r} but this host has only '
                f'{torch.cuda.device_count()} CUDA device(s)')
        return dev
    raise ValueError(
        f"device must be 'cuda', 'cuda:N' or 'cpu'; got {device!r}")


def local_devices(device) -> List[torch.device]:
    """This process's devices of ``device``'s kind, the counterpart of the
    JAX package's ``jax_devices_all``: ``[cuda:0 … cuda:n-1]`` for a CUDA
    device, ``[cpu]`` for the CPU. The mesh knobs (``mesh_devices``,
    ``data_parallel``, ``sequence_parallel``) resolve against it."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def lane(precision: str) -> Tuple[bool, int]:
    """``(tf32, gru_passes)`` of a precision value; an unknown value
    raises ``ValueError`` naming ``precision``."""
    try:
        return LANES[precision]
    except KeyError:
        raise ValueError(f'precision must be one of {PRECISIONS}; got '
                         f'{precision!r}') from None


def gru_passes(precision: str) -> int:
    """TF32 products per fp32 product in the GRU direction kernel."""
    return lane(precision)[1]


def set_precision(precision: str = 'highest') -> None:
    """Set cuDNN's and cuBLAS's TF32 flags for ``precision`` for the whole
    process, with no restore: for scripts that call the models and
    kernels outside an extractor."""
    tf32 = lane(precision)[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextmanager
def precision_scope(precision: str) -> Iterator[None]:
    """Set cuDNN's and cuBLAS's TF32 flags for ``precision`` (see
    :data:`LANES`) and restore both on exit, also when the body raises."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_precision(precision)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
