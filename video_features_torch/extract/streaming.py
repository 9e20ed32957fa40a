"""Streaming stack-window assembly (port of ``video_features_tpu/
extract/streaming.py``: ``stream_windows``, ``iter_batched_windows``).

Frames stream off the decoder through a bounded buffer and a window is
emitted as soon as it completes, so memory is O(window). Window k starts
at ``k·step``; only full windows are emitted (a partial final stack is
dropped, like the reference).
"""
from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np


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
