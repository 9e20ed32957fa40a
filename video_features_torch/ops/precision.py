"""The ``compute_dtype`` lanes (port of ``video_features_tpu/ops/
precision.py``'s tables and checks).

``compute_dtype`` is orthogonal to ``precision`` (``utils/device.py``):
``precision`` sets how float32 arithmetic runs on the card, while
``compute_dtype`` changes what is stored:

  * ``bfloat16``: params are cast to bf16 once, when loaded, and
    activations flow bf16 through the whole step, with float32 islands
    where the JAX package has them (batch, instance and layer norm,
    softmax, average and global pooling; ``ops/nn.py``);
  * ``int8``: conv and linear weights are quantized per output channel,
    symmetric, when loaded (``ops/quant.py``) and dequantized inside each
    step; activations stay float32, so the drift is pure weight rounding.

Features leave the step as float32 (:func:`features_to_f32`) on every
lane. The bounds, the accepting families (``registry.BF16_FEATURES``,
``registry.INT8_FEATURES``) and the refusals are the JAX package's,
measured there on random weights (XLA on the CPU); a test derives this
copy from it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

COMPUTE_DTYPES = ('float32', 'bfloat16', 'int8')
FP8_NAMES = ('float8', 'fp8', 'float8_e4m3fn', 'float8_e5m2')

# feature rel L2 of the bf16 lane against the float32 lane on the same
# inputs and weights: the JAX package's bounds (about 3x its measured drift)
BF16_REL_L2_BOUNDS: Dict[str, float] = {
    'r21d': 1.5e-2, 's3d': 2e-2, 'resnet': 2e-2, 'clip': 3e-2, 'timm': 5e-2,
    'vggish': 2.5e-2,
}

# the same for the int8 lane
INT8_REL_L2_BOUNDS: Dict[str, float] = {
    'resnet': 5e-2, 'clip': 3.5e-2, 'timm': 7.5e-2,
}

# the JAX package's reasons for its refusals (its figures, measured on a
# TPU; the port has not measured i3d or raft in either lane)
_JAX_FIGURES = ' (the JAX package\'s figures, measured there on a TPU)'
INT8_REFUSALS: Dict[str, str] = {
    'i3d': ('the fused RAFT->quantize->I3D flow path already measures '
            '1.24e-2 drift under bf16 against the <=1e-3 parity bound, and '
            'int8 weight rounding is a coarser perturbation through the '
            'same flow uint8-quantization cliff' + _JAX_FIGURES),
    'raft': ('raw flow output compounds weight-rounding error across 20 '
             'GRU refinement iterations (the corr/iter sub-graphs measure '
             '>=4.4e-3 under fast passes) against the <=1e-3 parity '
             'bound' + _JAX_FIGURES),
}
BF16_REFUSALS: Dict[str, str] = {
    'i3d': ('the fused RAFT->quantize->I3D flow path measures 1.24e-2 '
            'feature drift under 1-pass bf16 against the <=1e-3 parity '
            'bound: the flow uint8-quantization cliff amplifies bf16 '
            'error' + _JAX_FIGURES),
    'raft': ('raw flow output compounds bf16 error across 20 GRU '
             'refinement iterations (corr/iter sub-graphs measure '
             '>=4.4e-3 under fast passes) against the <=1e-3 parity '
             'bound' + _JAX_FIGURES),
}


class ComputeDtypeError(ValueError):
    """A family refused, or does not know, the requested compute_dtype."""


def check_compute_dtype(feature_type: Optional[str],
                        compute_dtype: str) -> str:
    """The value, when known and admitted for ``feature_type``; else a
    :class:`ComputeDtypeError` naming ``compute_dtype`` and echoing the
    requested value."""
    if compute_dtype in FP8_NAMES:
        raise ComputeDtypeError(
            f'compute_dtype must be one of {COMPUTE_DTYPES}; got '
            f'{compute_dtype!r}: fp8 storage is not supported, the precision '
            f'lanes end at int8 weight quantization (compute_dtype=int8)')
    if compute_dtype not in COMPUTE_DTYPES:
        raise ComputeDtypeError(f'compute_dtype must be one of '
                                f'{COMPUTE_DTYPES}; got {compute_dtype!r}')
    if compute_dtype != 'float32' and feature_type is not None:
        from video_features_torch.registry import BF16_FEATURES, INT8_FEATURES
        if compute_dtype == 'bfloat16':
            accepted, refusals, name = (BF16_FEATURES, BF16_REFUSALS,
                                        'registry.BF16_FEATURES')
        else:
            accepted, refusals, name = (INT8_FEATURES, INT8_REFUSALS,
                                        'registry.INT8_FEATURES')
        if feature_type not in accepted:
            why = refusals.get(
                feature_type,
                f'{feature_type} has no measured {compute_dtype} parity '
                f'bound: a family joins {name} only with a pinned bound')
            raise ComputeDtypeError(
                f'compute_dtype={compute_dtype} is refused for '
                f'feature_type={feature_type}: {why}')
    return compute_dtype


def activation_dtype(compute_dtype: str) -> torch.dtype:
    """The dtype a step's activations run in: bf16 on the bf16 lane,
    float32 on the others (the int8 lane dequantizes to float32)."""
    return torch.bfloat16 if compute_dtype == 'bfloat16' else torch.float32


def rel_l2(reference, candidate) -> float:
    """||candidate - reference||2 / ||reference||2, in float64."""
    a = np.asarray(reference, np.float64).ravel()
    b = np.asarray(candidate, np.float64).ravel()
    return float(np.linalg.norm(b - a)) / max(float(np.linalg.norm(a)), 1e-30)


def features_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Features leave the step as float32 whatever lane computed them;
    float32 input is returned as it is."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)
