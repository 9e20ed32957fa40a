"""Streaming window assembly and the asynchronous device loop's two
ends (port of ``video_features_tpu/extract/streaming.py``:
``stream_windows``, ``iter_batched_windows``, ``transfer_batches``,
``overlap_fetch``, ``stream_windows_across_videos``, the frame-wise
window stream ``framewise_segment_windows`` and ``segment_frame_range``;
the stream sentinels ``FLUSH`` and ``NUDGE``).

Frames stream off the decoder through a bounded buffer and a window is
emitted as soon as it completes, so memory is O(window). Window k starts
at ``k·step``; only full windows are emitted (a partial final stack is
dropped, like the reference).

The device loop of every video family runs in three places:

  * a producer thread (:func:`transfer_batches`) decodes, transforms,
    batches, pins and copies batch k+1 to the card while the card runs
    batch k;
  * the consumer thread launches each step and starts its readback into
    pinned host memory on a copy stream
    (``BaseExtractor.dispatch``);
  * :func:`overlap_fetch` waits for a step's readback only ``depth``
    dispatches later, so the host's per-batch work overlaps the card.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from video_features_torch.utils.tracing import NULL_TRACER, Tracer

# Stream sentinel: "no more input for now, flush the partial pools". A
# dynamic source yields it between bursts (the serve daemon's request
# queue) or mid-video (a live session's arrival lull); it passes through
# the windowers and the prefetch untouched. Defined here, in a module the
# decode farm's torch-free workers import, and re-exported by
# ``parallel.packing``.
FLUSH = object()

# Stream marker: "a video ended without emitting a window" (resume skip,
# too short, failed open). It reaches the consumer as a batchless
# ``(None, [], 0)`` item, so the video finalizes without waiting for a
# batch.
NUDGE = object()


def iter_batched_windows(windows: Iterable[np.ndarray],
                         batch: int) -> Iterator[tuple]:
    """Group windows into fixed-size ``(stacks, valid, window_idx)``
    batches: a (batch, ...) array whose tail is padded by repeating the
    last window (mask with ``[:valid]``), plus the index of the batch's
    first window."""
    pending: List[np.ndarray] = []
    window_idx = 0

    def flush():
        valid = len(pending)
        while len(pending) < batch:
            pending.append(pending[-1])
        out = (np.stack(pending), valid, window_idx)
        pending.clear()
        return out, valid

    for window in windows:
        pending.append(window)
        if len(pending) == batch:
            out, valid = flush()
            yield out
            window_idx += valid
    if pending:
        yield flush()[0]


def stream_windows(batches: Iterable, win: int, step: int,
                   frame_range: Optional[Tuple[int, int]] = None
                   ) -> Iterator[np.ndarray]:
    """Yield (win, ...)-shaped frame windows from a loader's batch stream
    of ``(batch, times, indices)`` tuples.

    ``frame_range`` (a segment query) keeps the windows that overlap the
    half-open frame range ``[start_f, end_f)``: window k spans frames
    ``[k·step, k·step + win)``. The stream stops pulling batches once
    the last covered window is out, so decode ends at the range's end
    (frames before the range still decode, and are dropped unstacked).

    A bare :data:`FLUSH` item passes through untouched: a
    live session marks its arrival lulls so, and runs its network frames
    through this same windower.
    """
    buf: List[np.ndarray] = []
    offset = 0          # absolute frame index of buf[0]
    next_start = 0      # absolute start of the next window
    end_f = None
    if frame_range is not None:
        start_f, end_f = frame_range
        if start_f >= end_f:
            return      # an empty range: no window overlaps it
        # the first window that reaches into the range: k·step + win > start_f
        next_start = max(0, (start_f - win) // step + 1) * step
        if next_start >= end_f:
            return
    for item in batches:
        if item is FLUSH:
            yield FLUSH
            continue
        buf.extend(item[0])
        # drop frames the next window can no longer touch
        d = min(next_start - offset, len(buf))
        if d > 0:
            del buf[:d]
            offset += d
        while next_start + win <= offset + len(buf):
            s = next_start - offset
            yield np.stack(buf[s:s + win])
            next_start += step
            if end_f is not None and next_start >= end_f:
                return  # past the range: decode no further
            d = min(next_start - offset, len(buf))
            if d > 0:
                del buf[:d]
                offset += d


def segment_frame_range(segment, fps) -> Optional[Tuple[int, int]]:
    """A ``(start_s, end_s)`` segment as the half-open frame range
    ``[start_f, end_f)`` at the loader's output (retimed) frame rate:
    floor of the start, ceiling of the end, so a window that only touches
    a boundary is covered. None for None."""
    if segment is None:
        return None
    fps = float(fps)
    return (int(math.floor(float(segment[0]) * fps)),
            max(int(math.ceil(float(segment[1]) * fps)), 0))


def framewise_segment_windows(batches: Iterable,
                              frame_range: Optional[Tuple[int, int]]
                              ) -> Iterator[tuple]:
    """Per-frame ``(frame, t_ms)`` windows from a loader's batch stream:
    the frame-wise families' packed window, with its timestamp as the
    window's meta. With a half-open ``frame_range`` (None: every frame),
    frames before it are dropped and decoding stops at its end: the one
    home of the frame-wise boundary rule, for the in-process loaders and
    the decode farm's recipes alike."""
    for batch, times, indices in batches:
        for frame, t_ms, idx in zip(batch, times, indices):
            if frame_range is not None:
                if idx < frame_range[0]:
                    continue
                if idx >= frame_range[1]:
                    return
            yield np.asarray(frame), t_ms


def transfer_batches(items: Iterable[tuple], put: Callable,
                     keep_host: bool = False, tracer: Tracer = NULL_TRACER,
                     depth: int = 2) -> Iterator[tuple]:
    """Overlap the host→device copy with device compute.

    ``items`` yields ``(host_batch, *meta)``; ``put`` places one batch on
    the device (``BaseExtractor.put_input``). The result yields
    ``(device_batch, host_batch | None, *meta)`` from a producer thread
    that runs ``items`` and ``put`` up to ``depth`` batches ahead of the
    consumer: decode, batch assembly and the copy of batch k+1 happen
    while the card runs batch k. ``keep_host`` carries the host array
    along (``show_pred`` reads pixels without a readback). A ``None``
    batch (the packed loop's drain marker) passes through uncopied. The
    copies are timed as the ``h2d`` stage.
    """
    from video_features_torch.io.video import prefetch

    def to_device(item):
        batch = item[0]
        if batch is None:
            return (None, None) + tuple(item[1:])
        with tracer.stage('h2d'):
            dev = put(batch)
        return (dev, batch if keep_host else None) + tuple(item[1:])

    return prefetch(map(to_device, items), depth=max(int(depth), 1))


def overlap_fetch(dispatched: Iterable[tuple], fetch: Callable, depth: int,
                  tracer: Tracer = NULL_TRACER) -> Iterator[tuple]:
    """Defer each step's readback ``depth`` dispatches behind compute.

    ``dispatched`` yields ``(in_flight, *meta)`` as each step is
    launched; items queue until ``depth`` are in flight, then the oldest
    is materialized with ``fetch`` (the ``d2h`` stage) and yielded as
    ``(host_out, *meta)``. ``depth=1`` is the synchronous order: every
    dispatch is followed at once by its fetch. Results come back in
    dispatch order at any depth.
    """
    depth = max(int(depth), 1)
    pending: deque = deque()

    def materialize():
        item = pending.popleft()
        with tracer.stage('d2h'):
            host = fetch(item[0])
        return (host,) + tuple(item[1:])

    for item in dispatched:
        pending.append(item)
        if len(pending) >= depth:
            yield materialize()
    while pending:
        yield materialize()


def stream_windows_across_videos(tasks: Iterable,
                                 open_windows: Callable) -> Iterator:
    """The packed loop's windower: ``(task, window, meta)`` across video
    boundaries, so the packer fills device batches from the whole
    worklist.

    ``tasks`` yields ``parallel.packing.VideoTask`` objects (or the
    ``FLUSH`` sentinel, passed through); ``open_windows(task)`` returns
    the video's ``(window, meta)`` iterator (the extractor's
    ``packed_windows``, or a live session's window source, whose
    mid-video ``FLUSH`` at an arrival lull passes through too). Videos
    drain in order. An exception while
    opening or decoding one video fails that task, is reported as the
    per-video loop reports it, and the stream goes on with the next
    video; its windows already pooled flow on but are never saved. A
    video that ends without a window is followed by ``NUDGE``, so the
    consumer finalizes it without waiting for a batch.
    """
    from video_features_torch.extract.base import (
        is_device_fault, log_extraction_error,
    )
    for task in tasks:
        if task is FLUSH:
            yield FLUSH
            continue
        try:
            for item in open_windows(task):
                if item is FLUSH:
                    yield FLUSH
                    continue
                window, meta = item
                if task.failed:
                    break       # the consumer failed this video: stop decoding it
                task.emitted += 1
                yield task, window, meta
        except Exception as e:
            if is_device_fault(e):
                raise
            task.failed = True
            log_extraction_error(task.path)
        finally:
            task.exhausted = True
        if task.emitted == 0:
            yield NUDGE
