"""Device resolution and the float32 precision policy.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A
request for a GPU on a machine without one raises; the port never falls
back to the CPU.

Precision: ``precision='highest'`` means true float32 on the card. cuDNN
runs float32 convolutions in TF32 by default (``torch.backends.cudnn.
allow_tf32`` is True), which keeps about three decimal digits and drifts
the features at the 1e-3 level, so :func:`set_precision` switches TF32
off for both cuDNN and cuBLAS. These two flags are process-wide torch
settings.
"""
from __future__ import annotations

import torch

PRECISIONS = ('highest',)


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


def set_precision(precision: str = 'highest') -> None:
    """Apply the float32 policy: TF32 off for cuBLAS and cuDNN."""
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}; got '
                         f'{precision!r} (faster precision modes are not '
                         f'ported yet)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
