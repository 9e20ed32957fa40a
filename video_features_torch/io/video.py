"""Video decode and batching (port of ``video_features_tpu/io/video.py``).

Iteration yields ``(batch, times_ms, indices)`` tuples with
``timestamp_ms = index / fps * 1000``; the last batch may be short.
``overlap`` frames are shared between consecutive batches (the flow
families' frame pairing, :func:`batch_frames`). ``transform_workers`` >
1 runs the per-frame transform over a thread pool, in order and ahead
of the consumer (:func:`_parallel_map`; PIL and cv2 release the GIL in
their inner loops): the frames are byte-equal at any worker count.
:func:`prefetch` runs an iterator on a producer thread, which is how
the extractors decode and copy batch k+1 while the card runs batch k.

Frames come from the decoder that ``backend`` names, with the JAX
package's rules: ``native`` is the in-process libav decoder
(``io/native.py``) and raises when its library is unavailable; ``cv2``
is ``cv2.VideoCapture``; ``auto`` takes the native decoder when the
library loads and falls back to cv2 for a file libav cannot open.

``fps`` or ``total`` retimes the video as the reference does, by the
first of these that works:

1. the ``ffmpeg`` binary, a constant-frame-rate re-encode
   (:func:`reencode_video_with_diff_fps`);
2. the native libav re-encoder in a short-lived subprocess
   (``io/native.py``), the same fps filter and libx264 defaults;
3. index resampling (ffmpeg's ``fps=`` filter with 'near' rounding).

A failed re-encode falls back to index resampling with a warning on
stderr. The re-encoded temp file is deleted by :meth:`VideoLoader.close`
unless ``keep_tmp``. cv2 is imported inside the functions that use it,
so the package imports on machines without it.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import (
    Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union,
)

import numpy as np

_REENCODE_SEQ = itertools.count()
DECODE_BACKENDS = ('auto', 'native', 'cv2')
NATIVE_UNAVAILABLE = ('native decode backend unavailable: decode_backend='
                      'native needs native/libvfdecode.so, which did not '
                      'build or load (g++ and the libav development '
                      'packages); use decode_backend=cv2 or auto')


def reencode_out_path(video_path: Union[str, os.PathLike],
                      tmp_path: Union[str, os.PathLike]) -> str:
    """A collision-free re-encode target in ``tmp_path``: the stem, a
    digest of the absolute source path (same-stem sources), and the pid
    and a per-process counter (concurrent opens of one source)."""
    digest = hashlib.sha1(
        os.path.abspath(os.fspath(video_path)).encode()).hexdigest()[:8]
    return os.path.join(
        os.fspath(tmp_path),
        f'{Path(video_path).stem}_{digest}_{os.getpid()}'
        f'_{next(_REENCODE_SEQ)}_new_fps.mp4')


def which_ffmpeg() -> str:
    """Path to an ffmpeg binary, or ''."""
    return shutil.which('ffmpeg') or ''


def reencode_video_with_diff_fps(video_path: str, tmp_path: str,
                                 extraction_fps: float) -> str:
    """Constant-frame-rate re-encode to ``extraction_fps`` with the ffmpeg
    binary. Raises ``RuntimeError`` when ffmpeg exits non-zero or writes
    no output."""
    ffmpeg = which_ffmpeg()
    if not ffmpeg:
        raise RuntimeError('ffmpeg is not installed')
    os.makedirs(tmp_path, exist_ok=True)
    new_path = reencode_out_path(video_path, tmp_path)
    cmd = [ffmpeg, '-hide_banner', '-loglevel', 'panic', '-y', '-i',
           str(video_path), '-filter:v', f'fps=fps={extraction_fps}', new_path]
    rc = subprocess.call(cmd)
    if rc != 0 or not os.path.isfile(new_path):
        raise RuntimeError(
            f'ffmpeg re-encode of {video_path} exited {rc} '
            f'({new_path if os.path.isfile(new_path) else "no output written"})')
    return new_path


def get_video_props(path: Union[str, os.PathLike]) -> Dict[str, float]:
    """fps / num_frames / height / width via cv2."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        return dict(fps=cap.get(cv2.CAP_PROP_FPS),
                    num_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                    height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                    width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    finally:
        cap.release()


def resample_frame_indices(num_src_frames: int, src_fps: float,
                           target_fps: float) -> np.ndarray:
    """Source-frame index per output slot when retiming to ``target_fps``:
    slot k sits at time k/target_fps and takes the nearest source frame."""
    if num_src_frames <= 0:
        return np.zeros((0,), dtype=np.int64)
    duration = num_src_frames / src_fps
    num_out = max(int(round(duration * target_fps)), 1)
    k = np.arange(num_out)
    src_idx = np.round(k * src_fps / target_fps).astype(np.int64)
    return np.clip(src_idx, 0, num_src_frames - 1)


def decode_rgb_frames(path: str) -> Iterator[np.ndarray]:
    """HWC uint8 RGB frames via cv2.VideoCapture. When frame 0 fails to
    decode (a cv2 quirk) decoding continues from the next readable
    frame."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        ok, _ = cap.read()
        if ok:                       # frame 0 decodes: restart from it
            cap.release()
            cap = cv2.VideoCapture(path)
        else:
            print(f'WARNING: first frame of {path} failed to decode; '
                  'continuing from the next readable frame', file=sys.stderr)
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


class Cv2FrameDecoder:
    """Sequential RGB frame decoder over ``cv2.VideoCapture``: iterating
    yields ``(source_index, HWC uint8 RGB frame)``, as
    :class:`~video_features_torch.io.native.NativeFrameDecoder` does."""

    def __init__(self, path: str):
        self.path = path
        self._frames: Optional[Iterator[np.ndarray]] = None

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        self._frames = decode_rgb_frames(self.path)
        try:
            yield from enumerate(self._frames)
        finally:
            self.release()

    def release(self) -> None:
        if self._frames is not None:
            self._frames.close()         # releases the capture
            self._frames = None


Batch = Tuple[List[np.ndarray], List[float], List[int]]


def batch_frames(frames: Iterable[np.ndarray], batch_size: int, fps: float,
                 overlap: int = 0,
                 transform: Optional[Callable] = None) -> Iterator[Batch]:
    """``(frames, times_ms, indices)`` batches of ``batch_size`` frames
    from a frame iterator; frame k is at ``k / fps * 1000`` ms.

    Each batch begins with the last ``overlap`` frames of the one before
    (already transformed), so a batch of ``batch_size`` frames with
    overlap 1 holds ``batch_size - 1`` new frames after the first. A
    batch that would hold only those cached frames is not yielded; the
    last batch may be short. ``transform`` runs once per new frame.
    """
    if batch_size < 1:
        raise ValueError(f'batch_size must be >= 1; got {batch_size}')
    if not 0 <= overlap < batch_size:
        raise ValueError(f'overlap must be in [0, batch_size); got {overlap}')
    batch: List[np.ndarray] = []
    times: List[float] = []
    indices: List[int] = []
    new = 0
    for idx, frame in enumerate(frames):
        batch.append(frame if transform is None else transform(frame))
        times.append(idx / fps * 1000)
        indices.append(idx)
        new += 1
        if len(batch) == batch_size:
            yield batch, times, indices
            keep = len(batch) - overlap
            batch, times, indices = batch[keep:], times[keep:], indices[keep:]
            new = 0
    if new:
        yield batch, times, indices


class VideoLoader:
    """Batched streaming frame iterator.

    Args:
        path: video file path.
        batch_size: frames per yielded batch.
        fps: retime to this frame rate (None keeps the source's).
        total: retime so the whole video yields about ``total`` frames
            (mutually exclusive with ``fps``).
        tmp_path: where a re-encode is written.
        keep_tmp: keep the re-encoded file after :meth:`close`.
        transform: per-frame callable (HWC uint8 RGB → frame).
        overlap: frames shared between consecutive batches.
        transform_workers: threads running ``transform`` (1 = inline).
        backend: the frame decoder, one of :data:`DECODE_BACKENDS`
            (the module docstring has the rules).

    Use it as a context manager, or call :meth:`close`, to delete the
    re-encoded file.
    """

    def __init__(self, path: Union[str, os.PathLike], batch_size: int = 1,
                 fps: Optional[float] = None, total: Optional[int] = None,
                 tmp_path: Union[str, os.PathLike] = 'tmp',
                 keep_tmp: bool = False,
                 transform: Optional[Callable] = None, overlap: int = 0,
                 backend: str = 'auto', transform_workers: int = 1):
        if backend not in DECODE_BACKENDS:
            raise ValueError(f'decode_backend must be one of {DECODE_BACKENDS}; '
                             f'got {backend!r}')
        if batch_size < 1:
            raise ValueError(f'batch_size must be >= 1; got {batch_size}')
        if not 0 <= overlap < batch_size:
            raise ValueError(f'overlap must be in [0, batch_size); got {overlap}')
        if fps is not None and total is not None:
            raise ValueError("'fps' and 'total' are mutually exclusive")
        if transform_workers < 1:
            raise ValueError(f'transform_workers must be >= 1; got '
                             f'{transform_workers}')
        self.path = str(path)
        if not os.path.isfile(self.path):
            raise FileNotFoundError(f'video does not exist: {self.path}')
        self.batch_size = batch_size
        self.transform = transform
        self.transform_workers = transform_workers
        self.overlap = overlap
        self.keep_tmp = keep_tmp
        self.backend = backend
        self._tmp_file: Optional[str] = None
        self._index_map: Optional[np.ndarray] = None
        props = self._probe_props(self.path)
        self.height, self.width = props['height'], props['width']
        self.fps = props['fps']
        if total is not None:
            fps = total * props['fps'] / max(props['num_frames'], 1)
        if fps is None:
            return
        reencoded = self._reencode(fps, str(tmp_path))
        if reencoded is None:
            self.fps = fps
            self._index_map = resample_frame_indices(
                props['num_frames'], props['fps'], fps)
            return
        self.path = self._tmp_file = reencoded
        props = get_video_props(self.path)
        self.fps = props['fps']
        self.height, self.width = props['height'], props['width']

    def _probe_props(self, path: str) -> Dict[str, float]:
        """Stream properties from the native service first (unless the
        backend is cv2), else from cv2: each may demux containers the
        other's build lacks."""
        if self.backend != 'cv2':
            from video_features_torch.io import native
            props = native.get_video_props_native(path)
            if props is not None and props['num_frames'] > 0:
                return props
            if self.backend == 'native' and props is None \
                    and not native.available():
                raise RuntimeError(NATIVE_UNAVAILABLE)
        return get_video_props(path)

    def _make_decoder(self):
        """The frame decoder ``backend`` selects; ``auto`` falls back to
        cv2 for a file the native decoder cannot open."""
        if self.backend != 'cv2':
            from video_features_torch.io import native
            if native.available():
                decoder = native.NativeFrameDecoder(self.path)
                if self.backend == 'native':
                    return decoder
                try:
                    return decoder.open()
                except IOError:
                    pass
            elif self.backend == 'native':
                raise RuntimeError(NATIVE_UNAVAILABLE)
        return Cv2FrameDecoder(self.path)

    def _reencode(self, fps: float, tmp_path: str) -> Optional[str]:
        """The re-encoded file's path from the first backend there is
        (the ffmpeg binary, else the native re-encoder), or None when
        neither is there or the one tried fails."""
        from video_features_torch.io import native
        if which_ffmpeg():
            name, reencode = 'ffmpeg', reencode_video_with_diff_fps
        elif native.available():
            name, reencode = 'native', native.reencode_fps_native
        else:
            return None
        try:
            return reencode(self.path, tmp_path, fps)
        except (RuntimeError, OSError) as e:
            print(f'WARNING: {name} fps re-encode of {self.path} failed ({e}); '
                  'falling back to index resampling', file=sys.stderr)
            return None

    def _retimed_frames(self) -> Iterator[np.ndarray]:
        """Decoded frames in output order, duplicated or dropped by the
        index map; the decoder is released however iteration ends."""
        decoder = self._make_decoder()
        try:
            if self._index_map is None:
                for _, frame in decoder:
                    yield frame
                return
            pos, n = 0, len(self._index_map)
            for src_idx, frame in decoder:
                while pos < n and self._index_map[pos] == src_idx:
                    yield frame
                    pos += 1
                if pos >= n:
                    return
        finally:
            decoder.release()

    def __iter__(self) -> Iterator[Batch]:
        frames, transform = self._retimed_frames(), self.transform
        if transform is not None and self.transform_workers > 1:
            frames = _parallel_map(transform, frames, self.transform_workers)
            transform = None
        return batch_frames(frames, self.batch_size, self.fps, self.overlap,
                            transform)

    def close(self) -> None:
        """Delete the re-encoded file unless ``keep_tmp``; idempotent."""
        if self._tmp_file and not self.keep_tmp:
            try:
                os.remove(self._tmp_file)
            except OSError:
                pass
        self._tmp_file = None

    def __enter__(self) -> 'VideoLoader':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parallel_map(fn: Callable, iterable: Iterable, workers: int) -> Iterator:
    """``map(fn, iterable)`` in order over a pool of ``workers`` threads,
    with at most ``2·workers`` calls in flight ahead of the consumer."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: deque = deque()
        for item in iterable:
            pending.append(pool.submit(fn, item))
            if len(pending) > 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run ``iterable`` on a producer thread, ``depth`` items ahead of
    the consumer. An exception of the producer is raised again at the
    consumer's ``next()``; the producer stops at its next item once the
    consumer is gone (the generator closed or collected)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterable:
                if not put(item):
                    return
            put(end)
        except BaseException as e:      # shipped to the consumer, raised there
            put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def prefetch_across_videos(window_stream: Iterable, max_windows: int) -> Iterator:
    """Decode ahead across video boundaries for the packed loop: the
    cross-video window stream runs on a producer thread with at most
    ``max_windows`` windows buffered, however many videos they span."""
    return prefetch(window_stream, depth=max(int(max_windows), 1))
