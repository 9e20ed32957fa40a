"""Weights packed once for their life: a cache of a kernel's operand made
from a weight tensor, held beside the weight and freed with it.

A hand kernel that reads a weight pre-split (``ops/gemm_tf32x3.py``: hi
and lo TF32 parts, K-major, swizzled) would pay the pack at every call
otherwise, a dozen small launches per weight (per-call packs make the
convolutional families' three-pass lane 2.2-2.9x slower than ``highest``,
PERF.md). The cache
keeps one pack per (weight object, key), in a map keyed by the weight's
``id`` whose entries die with the weight (a ``weakref`` callback), never
by a data pointer alone (a freed pointer is reused). Each hit is checked
against the weight's fingerprint, ``(_version, data_ptr, shape, stride,
device)``, so an in-place update (``copy_``, ``mul_``, a ``load_state_dict``
into it) makes the pack anew.

A tensor made under ``torch.inference_mode`` has no version counter: it may
be updated in place inside inference mode with nothing to show it. Such a
weight is packed at every call and never cached (right, and slow; the
extractors' weights are made outside inference mode).
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

_lock = threading.Lock()
# (id(weight), key) -> (weakref to the weight, its fingerprint, the pack)
_entries: Dict[Tuple[int, Hashable], Tuple[weakref.ref, tuple, torch.Tensor]] = {}


def fingerprint(t: torch.Tensor) -> Optional[tuple]:
    """What a pack of ``t`` depends on besides its bytes' identity: its
    version counter, storage pointer, shape, strides and device. None
    for an inference tensor (no version counter)."""
    if t.is_inference():
        return None
    return (t._version, t.data_ptr(), t.shape, t.stride(), t.device)


def packed(weight: torch.Tensor, key: Hashable,
           make: Callable[[torch.Tensor], torch.Tensor]
           ) -> Tuple[torch.Tensor, bool]:
    """``(make(weight), True)`` the first time ``weight`` is asked for
    under ``key`` or after it changed in place, ``(that pack, False)``
    while it stands; an inference tensor is made every time."""
    fp = fingerprint(weight)
    if fp is None:
        return make(weight), True
    ident = (id(weight), key)
    hit = _entries.get(ident)          # one dict read: atomic without the lock
    if hit is not None and hit[0]() is weight and hit[1] == fp:
        return hit[2], False
    pack = make(weight)
    ref = weakref.ref(weight, functools.partial(_drop, ident))
    with _lock:
        _entries[ident] = (ref, fp, pack)
    return pack, True


def _drop(ident, ref) -> None:
    with _lock:
        entry = _entries.get(ident)
        if entry is not None and entry[0] is ref:
            del _entries[ident]


def live() -> int:
    """Packs held (their weights alive)."""
    with _lock:
        return len(_entries)


def device_bytes(device_type: str = 'cuda') -> int:
    """Bytes the live packs hold on ``device_type``."""
    with _lock:
        packs = [e[2] for e in _entries.values()]
    return sum(p.numel() * p.element_size() for p in packs
               if p.device.type == device_type)
