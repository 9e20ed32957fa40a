"""Streaming window assembly and the asynchronous device loop's two
ends (port of ``video_features_tpu/extract/streaming.py``:
``stream_windows``, ``iter_batched_windows``, ``transfer_batches``,
``overlap_fetch``, ``stream_windows_across_videos`` and the frame-wise
window stream).

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

from collections import deque
from typing import Callable, Iterable, Iterator, List

import numpy as np

from video_features_torch.utils.tracing import NULL_TRACER, Tracer


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


def stream_windows(batches: Iterable, win: int,
                   step: int) -> Iterator[np.ndarray]:
    """Yield (win, ...)-shaped frame windows from a loader's batch stream
    of ``(batch, times, indices)`` tuples."""
    buf: List[np.ndarray] = []
    offset = 0          # absolute frame index of buf[0]
    next_start = 0      # absolute start of the next window
    for item in batches:
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
            d = min(next_start - offset, len(buf))
            if d > 0:
                del buf[:d]
                offset += d


def framewise_windows(batches: Iterable) -> Iterator[tuple]:
    """Per-frame ``(frame, t_ms)`` windows from a loader's batch stream:
    the frame-wise families' packed window, with its timestamp as the
    window's meta."""
    for batch, times, _ in batches:
        for frame, t_ms in zip(batch, times):
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
    ``packed_windows``). Videos drain in order. An exception while
    opening or decoding one video fails that task, is reported as the
    per-video loop reports it, and the stream goes on with the next
    video; its windows already pooled flow on but are never saved. A
    video that ends without a window is followed by ``NUDGE``, so the
    consumer finalizes it without waiting for a batch.
    """
    from video_features_torch.extract.base import (
        is_device_fault, log_extraction_error,
    )
    from video_features_torch.parallel.packing import FLUSH, NUDGE
    for task in tasks:
        if task is FLUSH:
            yield FLUSH
            continue
        try:
            for window, meta in open_windows(task):
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
