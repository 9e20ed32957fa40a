"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/video_features_torch/lib<name>-<hash>.so`` beside
the package, then loaded with ``ctypes``. The hash names the library's
identity (:func:`library_identity`): the source's bytes, ``NVCC_FLAGS``
and the nvcc release, so an edited source, a changed flag or another
toolkit builds anew instead of loading a stale library.
``compilation_cache_dir`` (:func:`configure_build_dir`) moves the
libraries to ``<dir>/gpu/``. Nothing is built when a module is imported:
the first launch builds, or a caller (``chip_smoke.py``) builds ahead
with :func:`build`. Each ``nvcc`` run is recorded (:func:`build_record`):
the run manifest's ``compile`` section is the builds made during its run.

With an executable store attached (:func:`attach_store`, from
``BaseExtractor.configure_aot``), :func:`load` goes through
``aot/runtime.py::ensure_library``: a library published by an earlier
process is loaded from the store, with no ``nvcc`` run. Without one it
builds (or finds the library built) and loads it, as it always did.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# the library lane of the executable store's key: the architecture the
# libraries are built for
LIBRARY_LANE = 'sm_90a'


BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'video_features_torch'
# compilation_cache_dir's values that keep BUILD_DIR: the JAX package's
# default (its XLA cache) and null
DEFAULT_CACHE_DIRS = ('~/.cache/video_features_tpu/xla', None)
_build_dir: Optional[Path] = None

# the nvcc builds this process ran: kernel → {'count', 'total_s'}
_builds: Dict[str, Dict[str, float]] = {}
_builds_lock = threading.Lock()

# the executable store :func:`load` goes through (None: build and load),
# and the family that attached it, for the store's records
_store: Any = None
_store_feature_type = '?'
# how each library in this process was loaded: name → {'path': 'loaded' |
# 'compiled' | 'built', 'program_sha', 'identity', 'file'}
_resident: Dict[str, Dict[str, Any]] = {}
_load_lock = threading.Lock()


def build_record() -> Dict[str, Dict[str, float]]:
    """A copy of the process's build table: per kernel source, how many
    ``nvcc`` builds ran and their wall seconds. A library found built
    is not a build."""
    with _builds_lock:
        return {k: dict(v) for k, v in _builds.items()}


def configure_build_dir(compilation_cache_dir: Optional[str]) -> Path:
    """Point the builds at ``compilation_cache_dir``: the JAX package's
    default or null keep :data:`BUILD_DIR`, another value names
    ``<dir>/gpu``. Process-wide; the last caller wins."""
    global _build_dir
    _build_dir = (None if compilation_cache_dir in DEFAULT_CACHE_DIRS
                  else Path(os.path.expanduser(str(compilation_cache_dir))) / 'gpu')
    return build_dir()


def build_dir() -> Path:
    """Where the libraries are built and looked for."""
    return BUILD_DIR if _build_dir is None else _build_dir


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cuda.exists():
        return str(cuda)
    raise RuntimeError('nvcc not found (looked on PATH and in CUDA_HOME or '
                       '/usr/local/cuda): the CUDA kernels cannot be built')


@functools.lru_cache(maxsize=None)
def _release_of(nvcc: str) -> str:
    proc = subprocess.run([nvcc, '--version'], capture_output=True, text=True)
    lines = [ln.strip() for ln in proc.stdout.splitlines() if 'release' in ln]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f'{nvcc} --version gave no release line '
                           f'({proc.returncode}): {proc.stdout}{proc.stderr}')
    return lines[0]


def nvcc_release() -> str:
    """``nvcc --version``'s release line (``Cuda compilation tools,
    release 12.4, V12.4.131``), read once per compiler."""
    return _release_of(_nvcc())


def library_identity(name: str) -> Dict[str, str]:
    """What a library's bytes depend on: the sha256 of ``csrc/<name>.cu``,
    the flags and the nvcc release, and ``program_sha``, the sha256 of the
    three (the executable store's program identity)."""
    parts = {'source_sha256': hashlib.sha256(
                 (CSRC / f'{name}.cu').read_bytes()).hexdigest(),
             'flags': ' '.join(NVCC_FLAGS), 'nvcc': nvcc_release()}
    program_sha = hashlib.sha256(
        json.dumps(parts, sort_keys=True).encode()).hexdigest()
    return {'library': name, **parts, 'program_sha': program_sha}


def library_path(name: str, identity: Optional[Dict[str, str]] = None) -> Path:
    """The library's file in the build directory, named by its identity."""
    identity = identity or library_identity(name)
    return build_dir() / f'lib{name}-{identity["program_sha"][:12]}.so'


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless already built; returns the
    library's path and the compiler's report ('' when it was built
    before)."""
    src = CSRC / f'{name}.cu'
    out = library_path(name)
    if out.exists():
        return out, ''
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed ({proc.returncode}) for {src}:\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)           # atomic: concurrent builders never see half a file
    with _builds_lock:
        rec = _builds.setdefault(name, {'count': 0, 'total_s': 0.0})
        rec['count'] += 1
        rec['total_s'] += time.perf_counter() - t0
    return out, proc.stdout + proc.stderr


def attach_store(store, feature_type: str = '?') -> None:
    """Send :func:`load` through ``store`` (an ``aot.store.ExecStore``;
    None detaches). Process-wide, the last caller wins; a library already
    loaded keeps how it was loaded."""
    global _store, _store_feature_type
    with _load_lock:
        _store, _store_feature_type = store, feature_type


def resident(name: str) -> Optional[Dict[str, Any]]:
    """How library ``name`` was loaded in this process (None: not yet):
    ``path`` is 'loaded' (from the store), 'compiled' (built or found
    built, then published) or 'built' (no store attached)."""
    with _load_lock:
        rec = _resident.get(name)
        return dict(rec) if rec is not None else None


@functools.lru_cache(maxsize=None)
def sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, read once."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(index: int) -> int:
    """The raw pointer of CUDA device ``index``'s current stream, for a
    kernel's entry point (without making a ``torch.cuda.Stream`` where
    torch offers the raw call)."""
    import torch
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    return raw(index) if raw is not None else \
        torch.cuda.current_stream(index).cuda_stream


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, loaded once per process: through the
    attached executable store, else built (or found built) here."""
    with _load_lock:
        store, feature_type = _store, _store_feature_type
        identity = library_identity(name)
        if store is None:
            path = build(name)[0]
            lib, how = ctypes.CDLL(str(path)), 'built'
        else:
            from video_features_torch.aot.runtime import ensure_library
            lib, how = ensure_library(store, name, lane=LIBRARY_LANE,
                                      feature_type=feature_type)
            path = library_path(name, identity)
        _resident[name] = {'path': how, 'program_sha': identity['program_sha'],
                           'identity': identity, 'file': str(path)}
        return lib
