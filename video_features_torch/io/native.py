"""ctypes binding for the native libav service (``native/vfdecode.cc``),
the port's own copy of ``video_features_tpu/io/native.py``:

  * :class:`NativeFrameDecoder` and :func:`get_video_props_native`, the
    in-process video decoder (``decode_backend=native``, and ``auto``
    where the library loads);
  * :func:`read_audio_native`, the in-process audio decoder and
    resampler (vggish's ``audio_backend=native``);
  * :func:`reencode_fps_native`, the constant-frame-rate re-encoder
    behind ``extraction_fps`` when there is no ffmpeg binary.

The shared library is built on first use by the repository's
``native/Makefile`` (g++ and pkg-config's libav packages). A host
without them has no library, and :func:`available` says so.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / 'native'
LIB_PATH = NATIVE_DIR / 'libvfdecode.so'

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False

# frames decoded per C call: amortizes the call, bounds memory
# (CHUNK × H × W × 3 bytes)
CHUNK = 32
# audio samples decoded per C call
AUDIO_CHUNK = 1 << 18


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
    lib.vf_open.restype = ctypes.c_void_p
    lib.vf_open.argtypes = [ctypes.c_char_p]
    lib.vf_props.restype = None
    lib.vf_props.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.vf_read.restype = ctypes.c_long
    lib.vf_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.vf_rotation.restype = ctypes.c_int
    lib.vf_rotation.argtypes = [ctypes.c_void_p]
    lib.vf_close.restype = None
    lib.vf_close.argtypes = [ctypes.c_void_p]
    lib.vf_audio_open.restype = ctypes.c_void_p
    lib.vf_audio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vf_audio_rate.restype = ctypes.c_int
    lib.vf_audio_rate.argtypes = [ctypes.c_void_p]
    lib.vf_audio_read.restype = ctypes.c_long
    lib.vf_audio_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_long]
    lib.vf_audio_close.restype = None
    lib.vf_audio_close.argtypes = [ctypes.c_void_p]
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


class NativeFrameDecoder:
    """Sequential RGB frame decoder over the native service, the
    protocol of :class:`~video_features_torch.io.video.Cv2FrameDecoder`:
    iterating yields ``(source_index, HWC uint8 RGB frame)``. Frames are
    decoded ``CHUNK`` at a time into a fresh array per chunk, so a
    yielded frame (a view into it) stays valid after the next read.

    :meth:`open` raises ``RuntimeError`` when the library is unavailable
    and ``IOError`` when libav cannot open the file. Width and height are
    the display geometry: the service applies the display-matrix
    rotation, as cv2 does."""

    def __init__(self, path: str):
        self.path = path
        self._handle: Optional[int] = None

    def open(self) -> 'NativeFrameDecoder':
        lib = load_library()
        if lib is None:
            raise RuntimeError('native decode service unavailable')
        handle = lib.vf_open(os.fsencode(self.path))
        if not handle:
            raise IOError(f'vfdecode: {lib.vf_last_error().decode()} ({self.path})')
        self._handle = handle
        fps, n = ctypes.c_double(), ctypes.c_long()
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.vf_props(handle, ctypes.byref(fps), ctypes.byref(n),
                     ctypes.byref(w), ctypes.byref(h))
        self.fps, self.num_frames = fps.value, n.value
        self.width, self.height = w.value, h.value
        self.rotation = lib.vf_rotation(handle)
        return self

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        if self._handle is None:
            self.open()
        lib = load_library()
        idx = 0
        try:
            while True:
                chunk = np.empty((CHUNK, self.height, self.width, 3), np.uint8)
                got = lib.vf_read(self._handle, chunk.ctypes.data, CHUNK)
                if got < 0:
                    raise IOError(f'vfdecode: decode error {got} ({self.path})')
                for i in range(got):
                    yield idx, chunk[i]
                    idx += 1
                if got < CHUNK:
                    return
        finally:
            self.release()

    def release(self) -> None:
        if self._handle is not None:
            load_library().vf_close(self._handle)
            self._handle = None

    def __del__(self):
        self.release()


def get_video_props_native(path: str) -> Optional[dict]:
    """fps, num_frames, height and width from the native service; None
    when the library is unavailable or libav cannot open the file."""
    if not available():
        return None
    dec = NativeFrameDecoder(str(path))
    try:
        dec.open()
    except (IOError, RuntimeError):
        return None
    props = dict(fps=dec.fps, num_frames=dec.num_frames,
                 height=dec.height, width=dec.width)
    dec.release()
    return props


def read_audio_native(path: str, target_sr: int = 0) -> Tuple[np.ndarray, int]:
    """A file's audio track as ``(mono float32 waveform in [-1, 1],
    sample rate)``, resampled by libswresample to ``target_sr`` when it
    is > 0, in process and without temp files.

    Raises ``IOError`` when the file has no audio track (as the ffmpeg
    chain fails on one) and ``RuntimeError`` when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError('native decode service unavailable')
    handle = lib.vf_audio_open(os.fsencode(str(path)), int(target_sr))
    if not handle:
        raise IOError(f'vfdecode audio: {lib.vf_last_error().decode()} ({path})')
    try:
        rate = lib.vf_audio_rate(handle)
        buf = np.empty(AUDIO_CHUNK, np.float32)
        parts = []
        while True:
            n = lib.vf_audio_read(handle, buf.ctypes.data, AUDIO_CHUNK)
            if n < 0:
                raise IOError(f'vfdecode audio: decode error {n} ({path})')
            if n == 0:
                break
            parts.append(buf[:n].copy())
        data = np.concatenate(parts) if parts else np.zeros((0,), np.float32)
        return data, rate
    finally:
        lib.vf_audio_close(handle)
