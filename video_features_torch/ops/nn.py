"""Functional NN building blocks, channels-last at the public functions.

Port of ``video_features_tpu/ops/nn.py``. Images are NHWC and videos
NDHWC, as in the JAX package, so tests compare like with like. Weights
keep torch's layout (O, I, *spatial). Each function moves the channel
axis to position 1 only around the ``torch.nn.functional`` call; on a
contiguous channels-last tensor that is a strided view, which cuDNN
takes as its channels-last memory format without a copy.

Numerics follow the JAX functions:
  * conv: torch symmetric int padding, or explicit per-edge (lo, hi)
    pairs (TF-SAME for I3D), applied as a zero pad before the call;
  * batch norm is inference-only with running statistics, computed as
    ``(x - mean) * rsqrt(var + eps) * weight + bias``;
  * max pool pads with ``-inf`` (ceil mode and TF-SAME become explicit
    high-side pads); avg pool is valid (no padding);
  * layer norm is over the trailing axis with torch's biased variance;
  * linear keeps torch's (O, I) weight; adaptive average pooling is the
    global mean over the spatial dims.

The bf16 lane (``compute_dtype=bfloat16``) has float32 islands where the
JAX package has them: batch norm, instance norm, layer norm, softmax, average
and global pooling take a bf16 input, compute in float32 (params cast up
too) and return bf16. The JAX package's group norm has no counterpart
here: no ported model uses it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOrTuple = Union[int, Sequence[int]]
Padding = Union[IntOrTuple, Sequence[Tuple[int, int]]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) != n:
        raise ValueError(f'expected {n} values, got {v}')
    return v


def _pad_pairs(padding: Padding, n: int):
    """Normalize padding to explicit (lo, hi) pairs, one per spatial dim."""
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if padding and isinstance(padding[0], (tuple, list)):
        return [tuple(p) for p in padding]
    return [(p, p) for p in padding]


def pad_spatial(x: torch.Tensor, pairs, value: float = 0.0) -> torch.Tensor:
    """Constant-pad the spatial dims of a channels-last tensor."""
    spec = [0, 0]                       # F.pad runs from the last dim: C
    for lo, hi in reversed(list(pairs)):
        spec += [lo, hi]
    if not any(spec):
        return x
    return F.pad(x, spec, value=value)


def conv(x: torch.Tensor, weight: torch.Tensor, stride: IntOrTuple = 1,
         padding: Padding = 0, bias: Optional[torch.Tensor] = None,
         groups: int = 1) -> torch.Tensor:
    """N-D convolution, channels-last. weight: (O, I // groups, *spatial);
    ``groups`` > 1 is a grouped convolution (ResNeXt's 3×3)."""
    n = weight.ndim - 2
    pairs = _pad_pairs(padding, n)
    if all(lo == hi for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x, pad = pad_spatial(x, pairs), 0
    out = _CONV[n](x.movedim(-1, 1), weight, bias, _tuple(stride, n), pad,
                   1, groups)
    return out.movedim(1, -1)


def _f32(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in p.items()}


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm over the trailing channel axis; ``p``
    holds torch-named entries (weight, bias, running_mean, running_var),
    the affine pair optional."""
    if x.dtype == torch.bfloat16:
        return batch_norm(x.float(), _f32(p), eps).to(x.dtype)
    out = (x - p['running_mean']) * torch.rsqrt(p['running_var'] + eps)
    if 'weight' in p:
        out = out * p['weight']
    if 'bias' in p:
        out = out + p['bias']
    return out


def instance_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the spatial dims (torch InstanceNorm2d: biased
    variance, affine optional, no running statistics)."""
    if x.dtype == torch.bfloat16:
        return instance_norm(x.float(), _f32(p), eps).to(x.dtype)
    dims = tuple(range(1, x.ndim - 1))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if 'weight' in p:
        out = out * p['weight']
    if 'bias' in p:
        out = out + p['bias']
    return out


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float) -> torch.Tensor:
    """LayerNorm over the trailing axis (biased variance), ``p`` holding
    weight and bias; a float32 island for a bf16 input."""
    if x.dtype == torch.bfloat16:
        return layer_norm(x.float(), _f32(p), eps).to(x.dtype)
    return F.layer_norm(x, x.shape[-1:], p['weight'], p['bias'], eps)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense layer over the trailing axis; ``p['weight']`` is (O, I)."""
    return F.linear(x, p['weight'], p.get('bias'))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax``; a bf16 input is exponentiated and summed in
    float32 and the result cast back."""
    if x.dtype == torch.bfloat16:
        return torch.softmax(x.float(), dim=dim).to(x.dtype)
    return torch.softmax(x, dim=dim)


def max_pool(x: torch.Tensor, window: IntOrTuple,
             stride: Optional[IntOrTuple] = None,
             padding: Padding = 0) -> torch.Tensor:
    """Max pooling over the spatial dims; padding is ``-inf``."""
    n = x.ndim - 2
    window = _tuple(window, n)
    stride = window if stride is None else _tuple(stride, n)
    x = pad_spatial(x, _pad_pairs(padding, n), value=float('-inf'))
    return _MAX_POOL[n](x.movedim(-1, 1), window, stride).movedim(1, -1)


def avg_pool(x: torch.Tensor, window: IntOrTuple,
             stride: Optional[IntOrTuple] = None) -> torch.Tensor:
    """Valid average pooling."""
    if x.dtype == torch.bfloat16:
        return avg_pool(x.float(), window, stride).to(x.dtype)
    n = x.ndim - 2
    window = _tuple(window, n)
    stride = window if stride is None else _tuple(stride, n)
    return _AVG_POOL[n](x.movedim(-1, 1), window, stride).movedim(1, -1)


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool to 1 in every spatial dim: (B, *spatial, C) → (B, C)."""
    if x.dtype == torch.bfloat16:
        return adaptive_avg_pool(x.float()).to(x.dtype)
    return x.mean(dim=tuple(range(1, x.ndim - 1)))


def ceil_mode_padding(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Torch ceil_mode pooling → (0, extra) high-side padding."""
    out_ceil = -(-(in_size - kernel) // stride) + 1
    needed = (out_ceil - 1) * stride + kernel - in_size
    return 0, max(0, needed)
