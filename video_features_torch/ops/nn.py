"""Functional NN building blocks, channels-last at the public functions.

Port of ``video_features_tpu/ops/nn.py``. Images are NHWC and videos
NDHWC, as in the JAX package, so tests compare like with like. Weights
keep torch's layout (O, I, *spatial). Each function moves the channel
axis to position 1 only around the ``torch.nn.functional`` call; on a
contiguous channels-last tensor that is a strided view, which cuDNN
takes as its channels-last memory format without a copy.

Numerics follow the JAX functions:
  * conv: torch symmetric int padding, or explicit per-edge (lo, hi)
    pairs (TF-SAME for I3D), applied as a zero pad before the call
    (:func:`library_conv`); inside :func:`conv_route` every
    :func:`conv`, grouped ones included, goes to the hand 3xTF32 kernel
    instead (``ops/conv_tf32x3.py``, every family under
    ``precision=high`` and ``mixed``), a depthwise one (one input and one
    output channel per group) to the hand fp32 kernel
    (``ops/dwconv.py``), or to their plain versions; a weight used by
    several calls is packed for the 3xTF32 kernel once
    (:func:`route_weight`);
  * linear and matmul: ``F.linear`` and ``@``; inside a
    :func:`conv_route` with ``products`` (the clip and timm families on
    that lane) they go to the hand 3xTF32 GEMM (``ops/gemm_tf32x3.py``)
    or to its plain version, operands read in place where their last
    axis is contiguous (``matmul.copies`` counts those copied);
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

from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

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


# where conv() goes in this context: None (torch.nn.functional, cuDNN on
# the card), 'kernel' (ops/conv_tf32x3.py::conv_tf32x3, a depthwise one
# ops/dwconv.py::dwconv_f32) or 'plain' (their plain versions); and where
# linear() and matmul() go: None (torch, cuBLAS on the card), 'kernel'
# (ops/gemm_tf32x3.py::gemm_tf32x3) or 'plain'; per thread and per task,
# so two serve workers on two lanes route apart
_CONV_ROUTE: ContextVar[Optional[str]] = ContextVar('vft_conv_route',
                                                    default=None)
_PRODUCT_ROUTE: ContextVar[Optional[str]] = ContextVar('vft_product_route',
                                                       default=None)
CONV_ROUTES = ('kernel', 'plain')


@contextmanager
def conv_route(route: Optional[str], products: bool = False) -> Iterator[None]:
    """Send every :func:`conv` in the body to the 3xTF32 convolution or,
    depthwise, the fp32 one (``'kernel'``), to their plain versions
    (``'plain'``), or to :func:`library_conv` (None); with ``products``
    every :func:`linear` and :func:`matmul` too, to the 3xTF32 GEMM or its
    plain version (without, they stay in torch). Restores the routes found
    on exit."""
    if route is not None and route not in CONV_ROUTES:
        raise ValueError(f'route must be one of {CONV_ROUTES} or None; got '
                         f'{route!r}')
    token = _CONV_ROUTE.set(route)
    products_token = _PRODUCT_ROUTE.set(route if products else None)
    try:
        yield
    finally:
        _PRODUCT_ROUTE.reset(products_token)
        _CONV_ROUTE.reset(token)


def conv_route_active() -> bool:
    """Whether :func:`conv` is routed to the 3xTF32 convolution (or its
    plain version) in this context."""
    return _CONV_ROUTE.get() is not None


def three_pass_route(enabled: bool, plain: bool = False,
                     products: bool = False):
    """A model forward's route: :func:`conv_route` to the hand kernels
    (their plain versions when ``plain``), the products too with
    ``products`` (clip and timm), when ``enabled`` (the lane's
    ``three_pass_convs``), else the route found."""
    if not enabled:
        return nullcontext()
    return conv_route('plain' if plain else 'kernel', products)


def route_weight(weight: torch.Tensor):
    """``weight`` as this context's :func:`conv` should take it when it is
    used by several calls: packed once for the 3xTF32 kernel
    (``ops/conv_tf32x3.py::prepack``) on the ``'kernel'`` route, else as
    it is."""
    if _CONV_ROUTE.get() != 'kernel':
        return weight
    from video_features_torch.ops import conv_tf32x3 as k
    return k.prepack(weight.contiguous())


def conv(x: torch.Tensor, weight, stride: IntOrTuple = 1,
         padding: Padding = 0, bias: Optional[torch.Tensor] = None,
         groups: int = 1) -> torch.Tensor:
    """N-D convolution, channels-last. weight: (O, I // groups, *spatial),
    or :func:`route_weight`'s packed form of it; ``groups`` > 1 is a
    grouped convolution (ResNeXt's 3×3). Inside a :func:`conv_route` it
    runs ``ops/conv_tf32x3.py``, or ``ops/dwconv.py`` for one input and
    one output channel per group (a geometry a kernel cannot take raises
    there, never falls back), else :func:`library_conv`."""
    route = _CONV_ROUTE.get()
    plain = weight if isinstance(weight, torch.Tensor) else weight.weight
    if route is None:
        return library_conv(x, plain, stride, padding, bias, groups)
    from video_features_torch.ops import dwconv
    if dwconv.is_depthwise(x, plain, groups):
        fn = dwconv.dwconv_f32 if route == 'kernel' else dwconv.dwconv_f32_plain
        return fn(x.contiguous(), plain.contiguous(), stride, padding,
                  None if bias is None else bias.contiguous())
    from video_features_torch.ops import conv_tf32x3 as k
    if route == 'plain':
        fn, weight = k.conv_tf32x3_plain, plain.contiguous()
    else:
        fn = k.conv_tf32x3
        if weight is plain:
            weight = plain.contiguous()
    return fn(x.contiguous(), weight, stride, padding,
              None if bias is None else bias.contiguous(), groups)


def library_conv(x: torch.Tensor, weight: torch.Tensor,
                 stride: IntOrTuple = 1, padding: Padding = 0,
                 bias: Optional[torch.Tensor] = None,
                 groups: int = 1) -> torch.Tensor:
    """:func:`conv` through ``torch.nn.functional`` (cuDNN on the card),
    whatever the route."""
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
    """Dense layer over the trailing axis; ``p['weight']`` is (O, I).
    Inside a products route: the 3xTF32 GEMM on ``x`` flattened to rows
    (copied where its rows do not flatten in place) and the (O, I) weight,
    bias in its epilogue."""
    route = _PRODUCT_ROUTE.get()
    if route is None:
        return F.linear(x, p['weight'], p.get('bias'))
    lead = x.shape[:-1]
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        x = _copied(x)
    try:
        rows = x.view(-1, x.shape[-1])
    except RuntimeError:                 # rows not flattenable in place
        rows = _copied(x).view(-1, x.shape[-1])
    out = _gemm(route, rows, p['weight'], False, 1.0, p.get('bias'))
    return out.view(*lead, out.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor,
           alpha: Optional[float] = None) -> torch.Tensor:
    """``a @ b``, times ``alpha`` where given. Inside a products route:
    the 3xTF32 GEMM with alpha in its epilogue, ``b`` read in its own
    layout, ``(K, N)`` where its last axis is contiguous and ``(N, K)``
    where it is a transposed view (``k.transpose(-1, -2)``: no copy), a
    batch of up to two axes; other operands are copied once
    (``matmul.copies``)."""
    route = _PRODUCT_ROUTE.get()
    if route is None:
        out = a @ b
        return out if alpha is None else out * alpha
    if a.shape[-1] > 1 and a.stride(-1) != 1:
        a = _copied(a)
    if b.ndim > 2 and tuple(b.shape[:-2]) != tuple(a.shape[:-2]):
        b = b.expand(*a.shape[:-2], *b.shape[-2:])
    if b.shape[-1] == 1 or b.stride(-1) == 1:
        kn, operand = True, b
    elif b.stride(-2) == 1:
        kn, operand = False, b.transpose(-1, -2)
    else:
        kn, operand = True, _copied(b)
    return _gemm(route, a, operand, kn, 1.0 if alpha is None else alpha, None)


# copies made for the GEMM's operands on the products route (an operand
# not contiguous along its last axis: Mixer's token mix reads a transposed
# activation)
matmul.copies = 0


def _copied(t: torch.Tensor) -> torch.Tensor:
    matmul.copies += 1
    return t.contiguous()


def _gemm(route: str, a, b, b_kn: bool, alpha: float, bias):
    from video_features_torch.ops import gemm_tf32x3 as g
    fn = g.gemm_tf32x3 if route == 'kernel' else g.gemm_tf32x3_plain
    return fn(a, b, b_kn, alpha, bias)


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
