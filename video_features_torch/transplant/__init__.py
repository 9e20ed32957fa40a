"""Weights into the port's parameter trees.

The port's params are nested dicts of float32 torch tensors whose keys
split the torch state_dict names on '.' and whose weights keep torch's
layout: conv (O, I, *spatial), linear (O, I).

* :func:`params_from_torch` takes a torch state_dict: it strips
  DataParallel ``module.`` prefixes and drops ``num_batches_tracked``.
* :func:`params_from_jax` takes the JAX package's nested numpy params
  (conv ``(*spatial, I, O)``, linear ``(I, O)``) and transposes them
  back, so both packages can compute with identical numbers; leaves the
  JAX transplant kept in torch layout are named in ``no_transpose``.
* :func:`load_checkpoint` reads a ``.pt``/``.pth`` state_dict (or a
  pickled model), or a ``.npz`` archive in the JAX package's
  transplanted layout;
* :func:`to_lane` casts a params tree once for its ``compute_dtype``
  lane: bf16 floating leaves, or int8-quantized conv and linear weights
  (``ops/quant.py``).

:mod:`.hf` re-keys ``transformers`` checkpoints into the timm and OpenAI
CLIP layouts these functions load.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

Params = Dict[str, Any]


def nest(flat: Mapping[str, Any]) -> Params:
    """{'a.b.c': x} → {'a': {'b': {'c': x}}}."""
    tree: Params = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('.')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def flatten(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
    """{'a': {'b': {'c': x}}} → {'a.b.c': x}, the inverse of :func:`nest`:
    a params tree as a ``state_dict`` for an ``nn.Module``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(flatten(value, f'{prefix}{key}.'))
        else:
            flat[f'{prefix}{key}'] = value
    return flat


def _tensor(value: Any) -> torch.Tensor:
    """float32 for floating leaves; integer leaves (BEiT's
    ``relative_position_index``, a gather index) become ``torch.long``,
    whatever width the source stored (the JAX package's device arrays
    hold int32)."""
    t = value.detach().cpu() if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.array(value))
    return t.to(torch.float32) if t.is_floating_point() else t.to(torch.long)


def params_from_torch(state_dict: Mapping[str, Any]) -> Params:
    """torch state_dict (tensors or numpy arrays) → the port's params."""
    flat = {}
    for name, value in state_dict.items():
        if name.endswith('num_batches_tracked'):
            continue
        if name.startswith('module.'):
            name = name[len('module.'):]
        flat[name] = _tensor(value)
    return nest(flat)


def _from_jax_leaf(name: str, arr: np.ndarray,
                   keep: bool = False) -> torch.Tensor:
    arr = np.asarray(arr)
    if name == 'weight' and not keep:
        if arr.ndim >= 3:            # (*spatial, I, O) → (O, I, *spatial)
            axes = (arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2))
            arr = arr.transpose(axes)
        elif arr.ndim == 2:          # (I, O) → (O, I)
            arr = arr.T
    # ascontiguousarray makes a 0-d leaf (CLIP's logit_scale) 1-d: reshape back
    return _tensor(np.ascontiguousarray(arr).reshape(arr.shape))


def params_from_jax(tree: Mapping[str, Any],
                    no_transpose: Iterable[str] = (),
                    prefix: str = '') -> Params:
    """The JAX package's nested params → the port's params.
    ``no_transpose`` names the dot-joined leaves that the JAX transplant
    left in torch layout (CLIP's ``token_embedding.weight``, a gather
    table), which stay as they are."""
    no_transpose = frozenset(no_transpose)
    return {k: (params_from_jax(v, no_transpose, f'{prefix}{k}.')
                if isinstance(v, Mapping)
                else _from_jax_leaf(k, v, f'{prefix}{k}' in no_transpose))
            for k, v in tree.items()}


def load_checkpoint(path: str, no_transpose: Iterable[str] = (),
                    weights_only: bool = True) -> Params:
    """``.npz`` (JAX transplanted layout, dot-joined keys; see
    :func:`params_from_jax` for ``no_transpose``) or a torch
    ``.pt``/``.pth`` state_dict (optionally under a 'state_dict' key).
    ``weights_only=False`` also unpickles whole models (OpenAI's CLIP
    archives) and takes their ``state_dict()``."""
    if str(path).endswith('.npz'):
        with np.load(path) as data:
            return params_from_jax(nest({k: data[k] for k in data.files}),
                                   no_transpose)
    ckpt = torch.load(path, map_location='cpu', weights_only=weights_only)
    if hasattr(ckpt, 'state_dict'):
        ckpt = ckpt.state_dict()
    if isinstance(ckpt, dict) and 'state_dict' in ckpt:
        ckpt = ckpt['state_dict']
    return params_from_torch(ckpt)


def to_lane(tree: Params, compute_dtype: str, no_transpose: Iterable[str] = (),
            scales: Optional[Mapping[str, Any]] = None) -> Params:
    """The params of a ``compute_dtype`` lane: float32 as they are;
    ``bfloat16`` with every floating leaf cast to bf16; ``int8`` with the
    eligible weights quantized (``ops/quant.py::quantize_flat``, a pinned
    scale table's ``scales`` consumed verbatim) and the other floating
    leaves float32."""
    if compute_dtype == 'float32':
        return tree
    if compute_dtype == 'bfloat16':
        return nest({k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                     for k, v in flatten(tree).items()})
    if compute_dtype == 'int8':
        from video_features_torch.ops.quant import quantize_flat
        return nest(quantize_flat(flatten(tree), skip=no_transpose,
                                  scales=scales))
    raise ValueError(f'unknown compute_dtype {compute_dtype!r}')


def float32_params(tree: Params) -> Params:
    """A lane's params as float32 (int8 weights dequantized, bf16 leaves
    cast up), for the surfaces outside the step (``show_pred``)."""
    from video_features_torch.ops.quant import dequantize_tree
    return {k: (float32_params(v) if isinstance(v, Mapping)
                else v.float() if v.is_floating_point() else v)
            for k, v in dequantize_tree(tree).items()}


def to_device(tree: Mapping[str, Any], device) -> Params:
    """Move every tensor of a params tree to ``device``."""
    return {k: (to_device(v, device) if isinstance(v, Mapping)
                else v.to(device))
            for k, v in tree.items()}
