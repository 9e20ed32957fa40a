"""ctypes binding for the native libav re-encoder (``vf_reencode_fps`` in
``native/vfdecode.cc``), the port's own copy of the re-encode part of
``video_features_tpu/io/native.py``.

The shared library is built on first use by the repository's
``native/Makefile`` (g++ and pkg-config's libav packages). A host
without them has no library, and :func:`available` says so; the loader
then retimes by index resampling.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[2] / 'native'
LIB_PATH = NATIVE_DIR / 'libvfdecode.so'

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    try:
        proc = subprocess.run(['make', '-C', str(NATIVE_DIR)],
                              capture_output=True, timeout=120)
        return proc.returncode == 0 and LIB_PATH.exists()
    except (OSError, subprocess.TimeoutExpired):
        return False


def _bind(lib: ctypes.CDLL) -> None:
    lib.vf_last_error.restype = ctypes.c_char_p
    lib.vf_last_error.argtypes = []
    lib.vf_reencode_fps.restype = ctypes.c_int
    lib.vf_reencode_fps.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_double]


def load_library() -> Optional[ctypes.CDLL]:
    """The bound library, built if needed; None when it cannot be built
    or loaded. ``make`` runs every time (a no-op when the library is
    fresh); a prebuilt library is still tried when make fails."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        if not _build() and not LIB_PATH.exists():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
            _bind(lib)
        except (OSError, AttributeError):   # libav missing, or a stale library
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def reencode_fps_native(video_path: str, tmp_path: str,
                        extraction_fps: float) -> str:
    """Constant-frame-rate re-encode to ``extraction_fps`` without the
    ffmpeg binary: libav's fps filter (nearest rounding) and libx264 at
    the ffmpeg CLI's defaults, written to
    :func:`~video_features_torch.io.video.reencode_out_path`.

    The encode runs in a short-lived subprocess (``io/reencode_cli.py``):
    libx264's rate control can decide differently after other work in the
    same process, and a fresh process encodes identically every time, as
    the ffmpeg CLI does. Raises ``RuntimeError`` when it fails."""
    from video_features_torch.io.video import reencode_out_path

    if load_library() is None:      # build once here; the child only loads
        raise RuntimeError('native re-encode library unavailable')
    os.makedirs(tmp_path, exist_ok=True)
    new_path = reencode_out_path(video_path, tmp_path)
    # run the entry point by file path with this checkout first on the
    # path, so the child imports this package whatever the caller's cwd
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name('reencode_cli.py')),
         str(video_path), new_path, repr(float(extraction_fps))],
        capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f'native re-encode failed: {proc.stderr.strip()}')
    return new_path
