"""Per-output-channel symmetric int8 weight quantization (the
``compute_dtype=int8`` lane), port of ``video_features_tpu/ops/quant.py``
in torch's layout.

Conv and linear weights are quantized once, when loaded, and
dequantized inside each step (:func:`dequantize_tree`: ``q.float() *
scale``), so the params are int8 on the card (a quarter of the float32
bytes) and the step computes in float32 under the ambient ``precision``.

  * scale = amax / 127 per output channel; an all-zero channel gets
    scale 1.0; q = clip(rint(w / scale), -127, 127);
  * eligible: ``.weight`` tensors of ndim >= 2 (the output channel is
    axis 0 in torch's layout, conv (O, I, *spatial) and linear (O, I))
    and CLIP's ``in_proj_weight`` (3E, E), along axis 0 as well; not the
    ``no_transpose`` gather tables and no ``*embedding*.weight``;
    everything else stays float32;
  * a pinned table ``<ckpt>.int8-scales.npz`` beside a checkpoint (flat
    dot names → (O,) float32 scales, ``__meta_*`` entries dropped) is
    consumed verbatim; names it lacks use the derived scales.

The JAX package quantizes after its transplant moved the output channel
last; this module's ``q`` and ``scale`` are the same bytes with the
channel axis first.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

QMAX = 127


class QuantizedTensor:
    """An int8 weight ``q`` (torch layout) and its float32 per-output-
    channel ``scale`` in broadcast shape (O, 1, ..., 1). Models never see
    one: :func:`dequantize_tree` expands it at the top of each step."""

    __slots__ = ('q', 'scale')

    def __init__(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        self.q, self.scale = q, scale

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale

    def to(self, device) -> 'QuantizedTensor':
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __repr__(self) -> str:
        return (f'QuantizedTensor(q={tuple(self.q.shape)}, '
                f'scale={tuple(self.scale.shape)})')


def derive_scale(w: torch.Tensor) -> torch.Tensor:
    """amax / 127 over every axis but 0, in broadcast shape; 1.0 for an
    all-zero channel."""
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    scale = (amax / float(QMAX)).to(torch.float32)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_tensor(w: torch.Tensor,
                    scale: Optional[Any] = None) -> QuantizedTensor:
    """Quantize one float weight along axis 0 with the derived scales or
    with ``scale`` (a table's flat (O,) entry)."""
    w = w.to(torch.float32)
    if w.ndim < 2:
        raise ValueError(f'per-channel quantization needs ndim >= 2; got '
                         f'shape {tuple(w.shape)}')
    if scale is None:
        scale = derive_scale(w)
    else:
        scale = torch.as_tensor(np.asarray(scale, np.float32)).reshape(
            (-1,) + (1,) * (w.ndim - 1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return QuantizedTensor(q, scale)


def is_eligible(name: str, value: Any, skip: Iterable[str] = ()) -> bool:
    """True for a dot-named float leaf this lane quantizes (see the
    module's note)."""
    if name in skip or not isinstance(value, torch.Tensor) \
            or value.ndim < 2 or not value.is_floating_point():
        return False
    if name.endswith('in_proj_weight'):
        return True
    if not (name.endswith('.weight') or name == 'weight'):
        return False
    parts = name.split('.')
    return not (len(parts) >= 2 and 'embedding' in parts[-2])


def quantize_flat(flat: Mapping[str, torch.Tensor], *,
                  skip: Iterable[str] = (),
                  scales: Optional[Mapping[str, Any]] = None
                  ) -> Dict[str, Any]:
    """int8-quantize every eligible weight of a flat (dot-named) params
    dict; other float leaves become float32, integer leaves stay."""
    skip = frozenset(skip)
    scales = scales or {}
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        if is_eligible(name, value, skip):
            out[name] = quantize_tensor(value, scales.get(name))
        elif isinstance(value, torch.Tensor) and value.is_floating_point():
            out[name] = value.to(torch.float32)
        else:
            out[name] = value
    return out


def dequantize_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Every :class:`QuantizedTensor` of a nested params tree as its
    float32 tensor; other leaves as they are."""
    return {k: (dequantize_tree(v) if isinstance(v, Mapping)
                else v.dequantize() if isinstance(v, QuantizedTensor) else v)
            for k, v in tree.items()}


def scale_table_path(checkpoint_path: str) -> str:
    """``<ckpt>.int8-scales.npz``: the checkpoint's pinned scale table."""
    return f'{checkpoint_path}.int8-scales.npz'


def load_scale_table(path: str) -> Dict[str, np.ndarray]:
    """A scale table (``__meta_*`` entries dropped); ``{}`` when there is
    no file."""
    if not os.path.exists(path):
        return {}
    with np.load(path) as data:
        return {k: data[k] for k in data.files if not k.startswith('__meta_')}
