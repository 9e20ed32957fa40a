"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/video_features_torch/lib<name>-<hash>.so`` beside
the package (the hash is of the source, so an edited source rebuilds),
then loaded with ``ctypes``. Nothing is built when a module is imported:
the first launch builds, or a caller (``chip_smoke.py``) builds ahead
with :func:`build`. Each ``nvcc`` run is recorded (:func:`build_record`):
the run manifest's ``compile`` section is the builds made during its run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'video_features_torch'

# the nvcc builds this process ran: kernel → {'count', 'total_s'}
_builds: Dict[str, Dict[str, float]] = {}
_builds_lock = threading.Lock()


def build_record() -> Dict[str, Dict[str, float]]:
    """A copy of the process's build table: per kernel source, how many
    ``nvcc`` builds ran and their wall seconds. A library found built
    is not a build."""
    with _builds_lock:
        return {k: dict(v) for k, v in _builds.items()}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cuda.exists():
        return str(cuda)
    raise RuntimeError('nvcc not found (looked on PATH and in CUDA_HOME or '
                       '/usr/local/cuda): the CUDA kernels cannot be built')


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless already built; returns the
    library's path and the compiler's report ('' when it was built
    before)."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f'lib{name}-{digest}.so'
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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, loaded once per process."""
    return ctypes.CDLL(str(build(name)[0]))
