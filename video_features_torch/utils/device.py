"""Device resolution and the matmul precision lanes.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A
request for a GPU on a machine without one raises; the port never falls
back to the CPU.

Precision: ``precision`` takes the JAX package's seven values
(:data:`PRECISIONS`). On the card a value decides three things
(:data:`LANES`, :func:`three_pass_convs`): whether cuDNN and cuBLAS may
run float32 convolutions and matmuls in TF32 (about three decimal
digits), how many TF32 products the GRU direction kernel
(``csrc/gru_direction.cu``) issues per fp32 one: 3 (3xTF32, fp32-class)
or 1, and whether every convolution of the step runs in the hand 3xTF32
convolution (``csrc/conv_tf32x3.cu``), and for clip and timm every
linear and product in the hand 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``) and
every depthwise convolution in the fp32 one (``csrc/dwconv_f32.cu``).

  * ``highest``, ``float32``: TF32 off, the GRU kernel in 3xTF32.
    ``float32`` is the JAX package's name for ``highest``: the same bytes.
  * ``high``, ``mixed``: the JAX package's three passes (``mixed`` is its
    ambient ``high`` with no pins). cuDNN and cuBLAS have no three-pass
    mode, so in every family (``registry.THREE_PASS_FEATURES``) every
    convolution goes to the 3xTF32 convolution (ResNeXt's and RegNet's
    grouped 3×3 included), in clip and timm
    (``registry.THREE_PASS_PRODUCT_FEATURES``) every linear, attention
    product and raw matmul to the 3xTF32 GEMM and every depthwise
    convolution to the fp32 one, and the libraries keep TF32 off for the
    rest (the six convolutional families' correlation volume, upsample
    einsum, linear heads and vggish's 12288 → 4096 → 4096 → 128 stack,
    the softmaxes and norms: true fp32); the GRU kernel in 3xTF32. On the
    bf16 lane (``compute_dtype=bfloat16``) everything stays in the
    libraries (bf16 operands have no low part to add).
  * ``default``, ``tensorfloat32``, ``bfloat16``: TF32 on, the GRU
    kernel in 1xTF32 (one-pass modes in JAX).

The two library flags are process-wide torch settings, read when a
kernel is launched on the host, so :func:`precision_scope` sets them
around each step's dispatch and restores them after. Because they are
process-wide, only one TF32 setting is in force at a time: scopes that
ask for the same setting overlap across threads, and a scope that asks
for the other one waits until every open scope has exited (the serve
daemon runs one worker thread per warm-pool entry, so two lanes do
dispatch at once). While it waits, new scopes of the setting in force
wait behind it, so the two settings take turns. A scope covers only the
host's launch of a step; :func:`scope_wait_stats` reports how many
scopes waited and the longest wait. Extractors never set the flags for the whole process;
:func:`set_precision` does, for scripts that call the models and kernels
directly.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PRECISIONS = ('default', 'high', 'highest', 'mixed', 'bfloat16',
              'tensorfloat32', 'float32')

# precision → (TF32 in cuDNN and cuBLAS, TF32 products per fp32 product
# in the GRU direction kernel); where three_pass_convs holds (high and
# mixed on every family's float32 activations) the libraries' TF32 is off
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


def three_pass_convs(precision: str, feature_type: Optional[str],
                     compute_dtype: Optional[str] = None) -> bool:
    """Whether every convolution of ``feature_type``'s step (and for clip
    and timm every linear and product) runs in the hand kernels under
    ``precision`` (and the libraries with TF32 off): ``high`` and
    ``mixed`` in ``registry.THREE_PASS_FEATURES``, on float32 activations
    (not ``compute_dtype=bfloat16``)."""
    from video_features_torch.registry import (
        THREE_PASS_FEATURES, THREE_PASS_PRECISIONS,
    )
    lane(precision)
    return (precision in THREE_PASS_PRECISIONS
            and feature_type in THREE_PASS_FEATURES
            and compute_dtype != 'bfloat16')


def library_tf32(precision: str, feature_type: Optional[str] = None,
                 compute_dtype: Optional[str] = None) -> bool:
    """Whether cuDNN and cuBLAS may run TF32 for ``feature_type``'s step
    under ``precision`` (:data:`LANES`, off where :func:`three_pass_convs`
    holds; ``feature_type`` None: the value's own lane)."""
    return lane(precision)[0] and not three_pass_convs(
        precision, feature_type, compute_dtype)


def set_precision(precision: str = 'highest') -> None:
    """Set cuDNN's and cuBLAS's TF32 flags for ``precision`` for the whole
    process, with no restore: for scripts that call the models and
    kernels outside an extractor."""
    tf32 = lane(precision)[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


# the TF32 setting in force across threads: `_held` is the flags every
# open scope asked for (None when no scope is open), `_open` the number of
# open scopes, `_saved` the flags from before the first of them,
# `_waiting` the outermost scopes waiting for each setting, `_turn` the
# setting whose waiters go next once the open scopes have all closed
_scope_cond = threading.Condition()
_held: Optional[Tuple[bool, bool]] = None
_open = 0
_saved: Tuple[bool, bool] = (False, False)
_waiting: Dict[Tuple[bool, bool], int] = {}
_turn: Optional[Tuple[bool, bool]] = None
# scopes that had to wait, and the longest wait in seconds
_wait_stats = {'waits': 0, 'longest_wait_s': 0.0}
# this thread's open scopes, innermost last
_scope_local = threading.local()


def _flags() -> Tuple[bool, bool]:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _may_enter(want: Tuple[bool, bool]) -> bool:
    """Whether an outermost scope asking for ``want`` may enter now:
    while the other setting has waiters, new scopes of the one in force
    queue behind them, so the two settings take turns."""
    other = sum(n for flags, n in _waiting.items() if flags != want)
    if _held is None:
        return _turn in (None, want) or not _waiting.get(_turn)
    return _held == want and not other


def scope_wait_stats(reset: bool = False) -> Dict[str, float]:
    """``{'waits': n, 'longest_wait_s': s}``: how many outermost scopes
    waited for the other TF32 setting to clear, and the longest such
    wait, since the process started or the last ``reset``."""
    with _scope_cond:
        out = dict(_wait_stats)
        if reset:
            _wait_stats.update(waits=0, longest_wait_s=0.0)
    return out


@contextmanager
def precision_scope(precision: str, feature_type: Optional[str] = None,
                    compute_dtype: Optional[str] = None) -> Iterator[None]:
    """Set cuDNN's and cuBLAS's TF32 flags for ``precision`` in
    ``feature_type``'s step (:func:`library_tf32`) and restore both on
    exit, also when the body raises.

    One TF32 setting is in force in the process at a time. A scope whose
    setting is the one in force enters at once, from any thread, unless a
    scope of the other setting is waiting: then it waits too, so the
    settings take turns and neither starves the other. A scope with the
    other setting waits until every open scope has exited. The first
    scope to enter sets the flags, the last to leave restores those it
    found. A scope nested on the same thread re-enters with the same
    setting and raises ``RuntimeError`` with the other one (waiting there
    would wait for itself)."""
    global _held, _open, _saved, _turn
    tf32 = library_tf32(precision, feature_type, compute_dtype)
    want = (tf32, tf32)
    stack = getattr(_scope_local, 'stack', None)
    if stack is None:
        stack = _scope_local.stack = []
    if stack and stack[-1] != want:
        raise RuntimeError(
            f'precision_scope({precision!r}) nested in a scope with TF32 '
            f'{"off" if tf32 else "on"} on the same thread: one TF32 setting '
            f'is in force at a time')
    with _scope_cond:
        if not stack and not _may_enter(want):
            t0 = time.perf_counter()
            _waiting[want] = _waiting.get(want, 0) + 1
            try:
                while not _may_enter(want):
                    _scope_cond.wait()
            finally:
                _waiting[want] -= 1
                # a waiter that leaves by an exception hands its turn on
                _scope_cond.notify_all()
            waited = time.perf_counter() - t0
            _wait_stats['waits'] += 1
            _wait_stats['longest_wait_s'] = max(
                _wait_stats['longest_wait_s'], waited)
        if _held is None:
            _saved = _flags()
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = want
            _held = want
            _turn = None
        _open += 1
    stack.append(want)
    try:
        yield
    finally:
        stack.pop()
        with _scope_cond:
            _open -= 1
            if not _open:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _saved
                _held = None
                _turn = next((flags for flags, n in _waiting.items()
                              if n and flags != want), None)
                _scope_cond.notify_all()
