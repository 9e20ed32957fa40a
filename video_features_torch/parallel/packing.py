"""The packed corpus loop, batch-major across videos, on one device (port
of ``video_features_tpu/parallel/packing.py``: ``VideoTask``, ``FLUSH``,
``NUDGE``, ``packed_batches``, ``run_packed``).

The per-video loop pads every video's last batch and pays the pipeline's
ramp once per video. Here:

  * a cross-video window stream (``extract.streaming.
    stream_windows_across_videos``) drains windows from one video after
    another on a producer thread (``io.video.prefetch_across_videos``),
    ``decode_ahead`` device batches of windows ahead of the card;
  * the packer (:func:`packed_batches`) fills every batch to capacity,
    one pool per window geometry, so a batch only holds windows of one
    shape; only the last batch of each geometry is padded;
  * the consumer dispatches each batch and keeps up to ``inflight`` of
    them in flight before it reads back the oldest (``sync_oldest``):
    readback, scatter and the output writes of batch k-1 overlap the
    card computing batch k;
  * rows scatter back to their videos, and a video is written as soon
    as its last window lands, through the per-video output contract
    (the resume skip, the same files, the fingerprint sidecar).

A host-side fault fails only the videos it touches: a video that does
not decode is reported and skipped, a batch whose dispatch or readback
raises fails the videos in it (``doom_batch``), and the worklist goes on.
A CUDA error (``extract.base.is_device_fault``) ends the run.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from video_features_torch.utils.tracing import NULL_TRACER, Tracer

# Stream sentinel: "no more input for now, flush the partial pools". A
# dynamic source yields it between bursts; it passes through the
# windower and the prefetch untouched.
FLUSH = object()

# Stream marker: "a video ended without emitting a window" (resume skip,
# too short, failed open). It reaches the consumer as a batchless
# ``(None, [], 0)`` item, so the video finalizes without waiting for a
# batch.
NUDGE = object()


class VideoTask:
    """One video's scheduling and scatter-back state.

    ``emitted`` counts windows the decode side yielded, ``done`` windows
    whose rows have come back; the video is complete when ``exhausted``
    and ``done == emitted``. ``skipped`` (resume) and ``failed`` finalize
    without writing. ``rows`` and ``meta_rows`` hold the scattered rows
    in window order (a video's windows share one pool, which is FIFO);
    ``info`` holds video-level metadata (the frame-wise ``fps``).
    ``out_root`` (None: the extractor's ``output_path``) routes this
    video's files elsewhere.
    """

    __slots__ = ('path', 'video_id', 'out_root', 'rows', 'meta_rows', 'info',
                 'emitted', 'done', 'exhausted', 'failed', 'skipped')

    def __init__(self, path: str, video_id: int = -1,
                 out_root: Optional[str] = None) -> None:
        self.path = str(path)
        self.video_id = video_id
        self.out_root = out_root
        self.rows: Dict[str, List[np.ndarray]] = {}
        self.meta_rows: List = []
        self.info: Dict = {}
        self.emitted = 0
        self.done = 0
        self.exhausted = False
        self.failed = False
        self.skipped = False


def packed_batches(windows: Iterable, batch: int,
                   max_pool_age_s: Optional[float] = None,
                   tracer: Tracer = NULL_TRACER
                   ) -> Iterator[Tuple[Optional[np.ndarray], list, int]]:
    """Group a cross-video ``(task, window, meta)`` stream into full
    batches ``(stacks, provenance, valid)``, provenance being the
    ``(task, meta)`` of the ``valid`` real slots.

    Windows pool per geometry (shape and dtype), each pool holding at
    most ``batch - 1`` windows; a pool flushes when full, and the partial
    pools flush padded (the last window repeated) when the stream ends
    or a ``FLUSH`` arrives. ``FLUSH`` and ``NUDGE`` are forwarded as the
    batchless marker ``(None, [], 0)``. ``max_pool_age_s`` also flushes a
    pool whose oldest window has waited that long, when the next window
    of any geometry arrives.
    """
    pools: Dict[tuple, list] = {}
    ages: Dict[tuple, float] = {}

    def flush(key):
        pool, pools[key] = pools[key], []
        ages.pop(key, None)
        with tracer.stage('pack'):
            wins = [w for _, w, _ in pool]
            wins += [wins[-1]] * (batch - len(wins))
            stacked = np.stack(wins)
        return stacked, [(t, m) for t, _, m in pool], len(pool)

    for item in windows:
        if item is FLUSH or item is NUDGE:
            if item is FLUSH:
                for key in list(pools):
                    if pools[key]:
                        yield flush(key)
            yield None, [], 0
            continue
        task, window, meta = item
        window = np.asarray(window)
        key = (window.shape, window.dtype.str)
        pool = pools.setdefault(key, [])
        if not pool:
            ages[key] = time.monotonic()
        pool.append((task, window, meta))
        if len(pool) == batch:
            yield flush(key)
        if max_pool_age_s is not None:
            now = time.monotonic()
            for k in list(pools):
                if pools[k] and now - ages[k] >= max_pool_age_s:
                    yield flush(k)
    for key in list(pools):
        if pools[key]:
            yield flush(key)


def _admit_task(ex, task: VideoTask) -> bool:
    """The per-video admission gate, run as the decode side reaches the
    video (never as an up-front scan of the worklist): False, with
    ``task.skipped`` set, when its outputs already exist."""
    if ex.is_already_exist(task.path, output_path=task.out_root):
        task.skipped = True
        return False
    return True


def _finalize_task(ex, task: VideoTask) -> None:
    """Write one finished video (unless skipped or failed) through the
    per-video output path, then free its rows. A failed write fails the
    video; a device fault ends the run."""
    from video_features_torch.extract.base import (
        is_device_fault, log_extraction_error,
    )
    try:
        if not (task.failed or task.skipped):
            feats_dict = ex._maybe_concat_streams(ex.packed_result(task))
            with ex.tracer.stage('save'):
                ex.action_on_extraction(feats_dict, task.path,
                                        output_path=task.out_root)
    except Exception as e:
        if is_device_fault(e):
            raise
        task.failed = True
        log_extraction_error(task.path)
    finally:
        task.rows = {}


def run_packed(ex, video_paths: Iterable, batch_size: Optional[int] = None,
               decode_ahead: int = 2, inflight: Optional[int] = None) -> None:
    """Drive one extractor over the whole worklist, batch-major.

    ``video_paths`` yields paths or :class:`VideoTask` objects (with an
    ``out_root``), consumed lazily on the decode thread. ``batch_size``
    (default: ``ex.packed_batch_size()``) is the batch's slot count;
    ``decode_ahead`` bounds the decode lookahead at ``decode_ahead ×
    batch`` windows; ``inflight`` (default: ``ex.inflight``) is how many
    dispatched batches wait before the oldest is read back (1 =
    synchronous; the outputs are the same bytes at any depth).

    The per-video contracts hold: a video whose outputs exist is skipped
    with the same message; the files and their contents are those of the
    per-video loop; a video that fails to decode, compute or save is
    reported with the same message and the worklist goes on.
    """
    from video_features_torch.extract.base import (
        is_device_fault, log_extraction_error,
    )
    from video_features_torch.extract.streaming import (
        stream_windows_across_videos, transfer_batches,
    )
    from video_features_torch.io.video import prefetch_across_videos

    batch = int(batch_size or ex.packed_batch_size())
    depth = max(int(inflight if inflight is not None else ex.inflight), 1)
    tracer = ex.tracer
    # the decode thread appends each task as the source yields it; only
    # this thread deletes (list.append and del are atomic in CPython)
    open_q: List[VideoTask] = []
    n_started = [0]

    def task_stream() -> Iterator:
        for item in video_paths:
            if item is FLUSH:
                yield FLUSH
                continue
            task = item if isinstance(item, VideoTask) else VideoTask(item)
            task.video_id = n_started[0]
            n_started[0] += 1
            open_q.append(task)
            yield task

    def open_windows(task: VideoTask):
        if not _admit_task(ex, task):
            return iter(())
        return ex.packed_windows(task)

    def sweep(final: bool = False) -> None:
        """Write every finished video. Not strictly in worklist order: a
        video whose geometry pool cannot fill yet must not hold up the
        videos behind it. The scan stops at the first video the decode
        side has not reached."""
        i = 0
        while i < len(open_q):
            t = open_q[i]
            if not t.exhausted and t.emitted == 0:
                break
            if t.exhausted and t.done >= t.emitted:
                del open_q[i]
                _finalize_task(ex, t)
            else:
                i += 1
        if final and open_q:
            t = open_q[0]
            raise AssertionError(
                f'packed loop lost windows for {t.path}: {t.done}/'
                f'{t.emitted} scattered, exhausted={t.exhausted}')

    def doom_batch(prov, exc: Exception) -> None:
        """Fail the videos of a batch whose dispatch or readback raised
        (their accounting still advances so the sweep never stalls); a
        device fault ends the run."""
        if is_device_fault(exc):
            raise exc
        for path in sorted({t.path for t, _ in prov}):
            log_extraction_error(path)
        for task, _ in prov:
            task.failed = True
            task.done += 1

    pending: deque = deque()        # (readback, provenance, valid), oldest first

    def sync_oldest() -> None:
        readback, prov, valid = pending.popleft()
        try:
            with tracer.stage('d2h'):
                out = ex.fetch_outputs(readback)
        except Exception as e:
            doom_batch(prov, e)
            sweep()
            return
        tracer.add_occupancy('d2h', valid, batch)
        for i, (task, meta) in enumerate(prov):
            task.done += 1
            if task.failed:
                continue
            for key, arr in out.items():
                task.rows.setdefault(key, []).append(arr[i])
            task.meta_rows.append(meta)
        sweep()

    windows = stream_windows_across_videos(task_stream(), open_windows)
    ahead = prefetch_across_videos(tracer.wrap_iter('decode+preprocess', windows),
                                   decode_ahead * batch)
    for dev, _, prov, valid in transfer_batches(
            packed_batches(ahead, batch, tracer=tracer),
            ex.put_input, tracer=tracer):
        if dev is None:
            # the drain marker: a video ended without a window, or the
            # source is idle; materialize the queue and finalize now
            while pending:
                sync_oldest()
            sweep()
            continue
        try:
            with tracer.stage('model'), torch.inference_mode():
                readback = ex.dispatch(dev)
        except Exception as e:
            doom_batch(prov, e)
            sweep()
            continue
        tracer.add_occupancy('model', valid, batch)
        pending.append((readback, prov, valid))
        while len(pending) >= depth:
            sync_oldest()
    while pending:
        sync_oldest()
    sweep(final=True)
    ex.print_profile(f'packed worklist ({n_started[0]} videos, batch {batch})')
