"""The seam between the executable store and the kernel libraries: load
a library from the store, or build it and publish it.

:func:`ensure_library` is the one path every consumer goes through:
``ops/_kernels.py::load`` when a store is attached to the process (an
extractor's first step, ``BaseExtractor.aot_warm``, the serve daemon's
boot), and the tests. It names the library by its identity
(``ops/_kernels.py::library_identity``: the source's sha256, the
``NVCC_FLAGS`` and the nvcc release line), adds the runtime environment,
and then either

  * **loads** the library a previous process published: the stored
    bytes are checked against the sha256 the store's manifest recorded
    before anything writes or loads them (a ``.so`` with flipped bytes
    can load and then crash at launch, so it is never handed to
    ``dlopen``), written atomically to the library's own file in the
    build directory, and loaded with ``ctypes``; or
  * **compiles**: builds the library with ``nvcc`` (or finds it already
    built, as a JAX compile may hit XLA's cache) and publishes its bytes
    so every later process loads instead.

The store key (``aot.store.exec_digest``) is the library's program sha
and lane plus the torch and CUDA versions, the platform, the device
kind, the compute capability, the host ISA and the payload version.
Unlike the JAX key it carries no device ids: a JAX executable binds its
devices, a kernel library does not (each kernel sets its shared-memory
attribute per device ordinal at launch). A changed component is a silent
miss; when the store holds the same program under another environment,
a structured event names the drifted component.
"""
from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from video_features_torch.aot.store import ExecStore, exec_digest, log_aot_error
from video_features_torch.obs.events import event

# bump when the payload framing changes incompatibly (the payload is the
# library's bytes as nvcc wrote them)
PAYLOAD_VERSION = 1
# the environment components a drift event may name
DRIFT_KEYS = ('torch', 'cuda', 'platform', 'device_kind', 'capability',
              'machine', 'lane', 'payload_v')


def runtime_environment() -> Dict[str, Any]:
    """The environment components of the store key, read from the
    current CUDA device (on a host without one, the CPU's)."""
    import platform as _host

    import torch
    if torch.cuda.is_available():
        index = torch.cuda.current_device()
        platform, kind = 'gpu', torch.cuda.get_device_name(index)
        capability = list(torch.cuda.get_device_capability(index))
    else:
        platform, kind, capability = 'cpu', _host.processor() or 'cpu', None
    return {'torch': torch.__version__, 'cuda': torch.version.cuda,
            'platform': platform, 'device_kind': kind,
            'capability': capability, 'machine': _host.machine(),
            'payload_v': PAYLOAD_VERSION}


def _toolchain(toolchain):
    if toolchain is not None:
        return toolchain
    from video_features_torch.ops import _kernels
    return _kernels


def library_identity(name: str, toolchain=None) -> Dict[str, str]:
    """Library ``name``'s identity (``program_sha`` and its parts), from
    ``toolchain`` (default ``ops/_kernels.py``, which needs nvcc)."""
    return _toolchain(toolchain).library_identity(name)


def _install(target: Path, payload: bytes) -> None:
    """The library's file, written atomically unless it already holds
    these bytes: two processes racing one entry write identical bytes,
    and each replace is whole."""
    try:
        if target.read_bytes() == payload:
            return
    except OSError:
        pass
    from video_features_torch.utils.output import atomic_write
    target.parent.mkdir(parents=True, exist_ok=True)
    atomic_write(str(target), lambda f: f.write(payload))


def ensure_library(store: ExecStore, name: str, *, lane: str,
                   feature_type: str = '?', toolchain=None,
                   ) -> Tuple[ctypes.CDLL, str]:
    """Load library ``name`` from ``store``, or build and publish it.

    Returns ``(handle, path)`` with ``path`` 'loaded' or 'compiled'. A
    failed build or a failed load raises, as without a store; a failed
    publish is reported and the built library is used. ``toolchain``
    (default ``ops/_kernels.py``) gives ``library_identity(name)``,
    ``library_path(name, identity)`` and ``build(name)``.
    """
    tc = _toolchain(toolchain)
    identity = library_identity(name, tc)
    components: Dict[str, Any] = {'program_sha': identity['program_sha'],
                                  'lane': lane}
    components.update(runtime_environment())
    digest = exec_digest(components)
    corrupt = []

    def on_corrupt(where: str) -> None:
        corrupt.append(where)
        event(logging.WARNING,
              'stored executable failed its sha256 check; evicted and '
              'recompiling', subsystem='aot', feature_type=feature_type,
              program=name, lane=lane, store=where)

    blob = store.fetch(digest, on_corrupt=on_corrupt)
    if blob is not None:
        target = Path(tc.library_path(name, identity))
        _install(target, blob)
        return ctypes.CDLL(str(target)), 'loaded'
    if not corrupt:
        _report_environment_miss(store, identity['program_sha'], components,
                                 feature_type, name, lane)
    path = Path(tc.build(name)[0])
    lib = ctypes.CDLL(str(path))
    try:
        store.put(digest, path.read_bytes(),
                  meta={'feature_type': feature_type, 'program': name,
                        **components})
    except Exception:
        log_aot_error(f'publish for {feature_type}/{name}')
    return lib, 'compiled'


def _report_environment_miss(store: ExecStore, program_sha: str,
                             components: Dict[str, Any],
                             feature_type: str, name: str,
                             lane: str) -> None:
    """A miss for a library the store holds under another environment
    (torch or CUDA upgraded, another card, another host ISA) is the
    invalidation working as designed, but an operator reading "boot
    stopped being compile-free" needs the reason named: a structured
    event with the drifted components. Never raises; silent for a cold
    store."""
    try:
        for meta in store.metas_for(program_sha):
            drift = {k: (meta.get(k), components.get(k)) for k in DRIFT_KEYS
                     if meta.get(k) != components.get(k)}
            if drift:
                event(logging.INFO,
                      'executable present under a different runtime '
                      'environment — recompiling (silent-miss '
                      'invalidation)', subsystem='aot',
                      feature_type=feature_type, program=name, lane=lane,
                      drift={k: {'stored': a, 'live': b}
                             for k, (a, b) in drift.items()})
                return
    except Exception:
        # vft-lint: ok=swallowed-exception — best-effort diagnostics
        # best-effort diagnostics on the build path; the miss itself is
        # already being handled
        pass
