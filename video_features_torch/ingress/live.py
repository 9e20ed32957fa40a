"""Live sessions: frames arrive over the network, features stream back
(the port's copy of ``video_features_tpu/ingress/live.py``).

A live session is ONE long-lived ingress request: the client streams
raw frames up in HTTP chunks, the session windows them to the serving
extractor's exact packed geometry (``BaseExtractor.live_window_spec`` —
the same stack/step/host-transform the file path applies), and every
scattered feature row streams back DOWN the same response as its own
chunk, the moment the device loop materializes it. On the scheduler
side the session is just another packed task: its windows pack into the
same device batches as file-backed requests, lulls in frame arrival
surface as FLUSH (partial pools drain, the async loop materializes, the
client sees its windows instead of waiting on future frames), and the
per-video fault-isolation contract holds — a dead client fails exactly
its own session.

Threading: the HANDLER thread reads body chunks and ``push``es frame
batches (bounded queue → TCP backpressure on a fast client); the
DECODE thread runs :meth:`windows`; the DEVICE-LOOP sync thread calls
:meth:`send_window`. ``abort``/generator-close tie the three together
so no thread outlives the session.
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Any, Dict

import numpy as np

from video_features_torch.extract.streaming import FLUSH, stream_windows

_END = object()


class LiveSessionError(RuntimeError):
    pass


# default cap on RAW frame bytes buffered per session between the
# network reader and the windower: a client outpacing extraction stalls
# in push() (TCP backpressure) instead of growing the daemon's RSS — a
# count-based bound alone would admit queue_batches × max-chunk bytes
LIVE_BUFFER_BYTES = 64 << 20


class LiveSession:
    """State + plumbing for one live extraction session."""

    def __init__(self, session_id: str, tenant: str,
                 fps: float = 25.0, idle_flush_s: float = 0.05,
                 queue_batches: int = 32,
                 max_buffer_bytes: int = LIVE_BUFFER_BYTES) -> None:
        self.id = str(session_id)
        self.tenant = tenant
        self.fps = float(fps)
        if self.fps <= 0:
            raise LiveSessionError(f'fps must be > 0; got {fps}')
        self.idle_flush_s = float(idle_flush_s)
        # the scheduler-facing identity: a pseudo-path (nothing exists
        # at it; the task is ephemeral so resume/cache never stat it)
        self.pseudo_path = f'live-{self.id}.live'
        self._q: 'queue.Queue' = queue.Queue(maxsize=max(queue_batches, 1))
        self.max_buffer_bytes = int(max_buffer_bytes)
        self._buf_bytes = 0                # raw frame bytes queued
        self._buf_cv = threading.Condition()
        self._aborted = threading.Event()
        self._input_done = False
        self.done = threading.Event()      # request reached terminal state
        self.request = None                # bound at admission
        self.windows_in = 0                # windows formed from frames
        self.frames_in = 0
        self.windows_streamed = 0          # feature chunks sent back
        self._writer = None                # ingress.http.ResponseWriter
        self._send_lock = threading.Lock()

    # -- admission-side hooks (serve/server.py) ------------------------------

    def bind(self, request) -> None:
        self.request = request

    def attach_writer(self, writer) -> None:
        self._writer = writer

    # -- input side (handler thread) -----------------------------------------

    def push(self, frames: np.ndarray) -> None:
        """Queue one (N, H, W, 3) uint8 frame batch; blocks when the
        session's buffer is full — bounded in BYTES (max_buffer_bytes),
        not just batch count, so backpressure reaches a fast client
        through TCP before the daemon's memory does. Drops silently
        after an abort — the reader drains the wire so the response can
        still flush."""
        nb = int(frames.nbytes)
        self.frames_in += int(len(frames))
        with self._buf_cv:
            # _buf_bytes > 0 guarantees progress for a single batch
            # larger than the whole budget
            while (self._buf_bytes + nb > self.max_buffer_bytes
                   and self._buf_bytes > 0
                   and not self._aborted.is_set()):
                self._buf_cv.wait(0.1)
            if self._aborted.is_set():
                return
            self._buf_bytes += nb
        while not self._aborted.is_set():
            try:
                self._q.put(frames, timeout=0.1)
                return
            except queue.Full:
                continue
        with self._buf_cv:                 # aborted before enqueue
            self._buf_bytes -= nb
            self._buf_cv.notify_all()

    def end_input(self) -> None:
        """The client finished streaming (zero-length chunk): remaining
        buffered windows flush, then the session's task exhausts."""
        if self._input_done:
            return
        self._input_done = True
        while not self._aborted.is_set():
            try:
                self._q.put(_END, timeout=0.1)
                return
            except queue.Full:
                continue

    def abort(self) -> None:
        """Tear the session down (client vanished, server drain): the
        window generator ends, push() stops blocking, and whatever was
        already computed still streams/finalizes."""
        self._aborted.set()
        with self._buf_cv:
            self._buf_cv.notify_all()      # unblock byte-budget waiters
        try:
            self._q.put_nowait(_END)
        except queue.Full:
            pass

    @property
    def aborted(self) -> bool:
        return self._aborted.is_set()

    # -- decode-side window source (runs on the packed decode thread) --------

    def _frame_batches(self, transform):
        """Transformed frame batches off the network queue, with FLUSH
        on every ``idle_flush_s`` lull; ends at end-of-input/abort."""
        while not self._aborted.is_set():
            try:
                item = self._q.get(timeout=self.idle_flush_s)
            except queue.Empty:
                yield FLUSH
                continue
            if item is _END:
                return
            with self._buf_cv:             # raw bytes left the queue
                self._buf_bytes -= int(item.nbytes)
                self._buf_cv.notify_all()
            yield [np.asarray(transform(f) if transform is not None
                              else f) for f in item]

    def windows(self, ex):
        """The task's ``windows_override``: replay the extractor's exact
        packed windowing over the network frame stream. Yields
        ``(window, meta)`` plus FLUSH on arrival lulls (every
        ``idle_flush_s`` without frames), so pooled windows never wait
        on future traffic. Stack families run through THE SAME
        ``stream_windows`` the file-backed path uses (FLUSH passes
        through it), so live and decoded windowing cannot diverge."""
        spec = ex.live_window_spec()
        if spec is None:
            raise LiveSessionError(
                f'{getattr(ex, "feature_type", type(ex).__name__)} does '
                'not support live sessions')
        win, step, transform, timed = spec
        try:
            if timed:
                # frame-wise families: window == frame, meta is the
                # timestamp at the session's declared fps
                idx = 0
                for item in self._frame_batches(transform):
                    if item is FLUSH:
                        yield FLUSH
                        continue
                    for f in item:
                        self.windows_in += 1
                        yield f, idx / self.fps * 1000.0
                        idx += 1
                return

            def loader_protocol():
                # (batch, times, indices) shape stream_windows consumes;
                # FLUSH items ride through bare
                for item in self._frame_batches(transform):
                    yield item if item is FLUSH else (item, None, None)

            for w in stream_windows(loader_protocol(), win, step):
                if w is FLUSH:
                    yield FLUSH
                    continue
                self.windows_in += 1
                yield w, None
        except BaseException:
            # abnormal end ONLY (the scheduler failed/closed the task,
            # an exception mid-windowing): tear the session down so a
            # reader blocked in push() unblocks. A NORMAL end-of-input
            # must NOT abort — windows still pooled in the packer when
            # the client sends its terminator have yet to stream back
            # through send_window, and aborting here would drop them
            # (and fail the task) on every no-idle-lull session.
            self._aborted.set()
            raise

    # -- output side (device-loop sync thread) --------------------------------

    def send_window(self, feats: Dict[str, Any], meta) -> None:
        """Stream one scattered feature row to the client as a chunk:
        one JSON line ``{"window": k, "feats": {key: [floats]}}`` (+
        ``timestamp_ms`` for frame-wise families). Raises on a dead
        client — the scheduler then fails the task, which stops decode
        and ends the session."""
        writer = self._writer
        if writer is None or self._aborted.is_set():
            raise LiveSessionError('live session has no live client')
        row: Dict[str, Any] = {
            'window': self.windows_streamed,
            'feats': {k: np.asarray(v).tolist() for k, v in feats.items()},
        }
        if meta is not None:
            row['timestamp_ms'] = float(meta)
        payload = (json.dumps(row) + '\n').encode('utf-8')
        with self._send_lock:
            writer.write_chunk(payload)
            self.windows_streamed += 1


def decode_frame_chunk(data: bytes, max_frames: int = 1024) -> np.ndarray:
    """One client frame chunk → a (N, H, W, 3) uint8 batch.

    The wire format is a serialized ``.npy`` (``np.save`` bytes,
    ``allow_pickle=False`` — never unpickle network input) holding
    either one HWC frame or an NHWC batch.
    """
    import io
    try:
        arr = np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:
        raise LiveSessionError(f'undecodable frame chunk ({e}); frames '
                               'must be .npy-serialized uint8 arrays')
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise LiveSessionError(
            f'frames must be (H, W, 3) or (N, H, W, 3); got {arr.shape}')
    if arr.dtype != np.uint8:
        raise LiveSessionError(f'frames must be uint8; got {arr.dtype}')
    if len(arr) > max_frames:
        raise LiveSessionError(
            f'frame chunk of {len(arr)} frames exceeds {max_frames}')
    return arr
