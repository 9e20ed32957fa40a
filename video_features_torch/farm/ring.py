"""Bounded shared-memory byte ring with one producer (a decode worker
process) and one consumer (the farm's drain loop in the parent): the
port's copy of ``video_features_tpu/farm/ring.py``.

The ring is a byte arena over one ``multiprocessing.shared_memory``
segment. Positions are monotonic byte counters that never wrap; the
physical offset is ``pos % capacity``. The producer owns ``write_pos``;
the consumer reports the bytes it has consumed over a queue and the
producer folds them into ``read_pos``, so the two sides share nothing
mutable but the segment's bytes, and a crashed worker cannot corrupt
another worker's ring (each worker has its own segment and queues).

A window takes one contiguous region and never straddles the wrap: when
the arena's tail is too short, the producer skips it, and the skip rides
in the region's ``adv`` (its total byte advance), which the consumer
reports back verbatim, so both sides' arithmetic stays identical. When
``capacity - (write_pos - read_pos)`` cannot fit the next window the
producer waits for frees: a slow consumer stalls decode instead of
growing memory.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


class RingFull(Exception):
    """Raised by :meth:`RingProducer.alloc` when it would have to wait
    for space and was given no ``wait_free``."""


class RingProducer:
    """Producer-side allocator over a shared-memory segment's buffer."""

    def __init__(self, buf: memoryview, capacity: int) -> None:
        self.buf = buf
        self.capacity = int(capacity)
        self.write_pos = 0      # monotonic bytes allocated
        self.read_pos = 0       # monotonic bytes freed by the consumer

    def free_space(self) -> int:
        return self.capacity - (self.write_pos - self.read_pos)

    def freed(self, nbytes: int) -> None:
        """Fold a consumer's free report (an ``adv`` value) into
        ``read_pos``."""
        self.read_pos += int(nbytes)

    def alloc(self, nbytes: int,
              wait_free: Optional[Callable[[], None]] = None,
              ) -> Optional[Tuple[int, int]]:
        """Reserve a contiguous ``nbytes`` region: ``(offset, adv)``.

        ``adv`` is the total byte advance (the region and any skipped
        arena tail) that the consumer must report back. None when the
        window is over half the arena: a wrap's skipped tail can approach
        the window's size, so such a window could need more than the
        whole arena, and the caller ships it through the message queue
        instead. ``wait_free`` is called until there is space (it drains
        the free queue, and may raise to abort).
        """
        nbytes = int(nbytes)
        if nbytes * 2 > self.capacity:
            return None
        off = self.write_pos % self.capacity
        skip = self.capacity - off if off + nbytes > self.capacity else 0
        adv = skip + nbytes
        while self.free_space() < adv:
            if wait_free is None:
                raise RingFull(nbytes)
            wait_free()
        self.write_pos += adv
        return (self.write_pos - nbytes) % self.capacity, adv

    def write(self, offset: int, arr: np.ndarray) -> None:
        """Copy a C-contiguous array's bytes into the segment."""
        dst = np.frombuffer(self.buf, dtype=np.uint8, count=arr.nbytes,
                            offset=offset)
        dst[:] = arr.reshape(-1).view(np.uint8)


def read_window(buf: memoryview, offset: int, shape: tuple,
                dtype: str) -> np.ndarray:
    """The consumer's copy of one window out of the segment. The copy
    lets the ring slot be freed at once, so the ring bounds only the
    transport and the packer's buffers keep their own bounds."""
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    src = np.frombuffer(buf, dtype=np.uint8, count=n, offset=offset)
    return src.copy().view(np.dtype(dtype)).reshape(shape)
