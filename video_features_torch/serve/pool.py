"""Warm pool: an LRU-bounded cache of live extractor workers (the port's
copy of ``video_features_tpu/serve/pool.py``).

Building an extractor loads its weights onto the device (seconds); the
first batch through a geometry pays cuDNN's algorithm search, the CUDA
kernels' nvcc build and the allocator's growth. All of that attaches to
the extractor instance, so keeping the instance resident keeps it warm.
The pool keys entries by identity (``serve.server.pool_key``: family,
model and geometry knobs, precision, device: whatever changes the
program or the weights) and bounds residency with LRU eviction, because
each entry holds its params in device memory.

Eviction is graceful: an entry may have queued work, so the pool never
kills one. It calls ``entry.close()`` (stop accepting, drain, exit) and
hands the entry back to the caller to join. Busy entries are passed over
for idle ones; when every entry is busy the pool runs over capacity
rather than stall admission behind a drain.

Placement (:class:`DevicePlacer`): on a host with several GPUs each entry
is assigned devices at build time, one for a single-device extractor, N
for a ``mesh_devices=N`` packed mesh, the least loaded by resident bytes,
so different families spread over the cards instead of all landing on
``cuda:0``.

No module of ``serve/`` but ``server.py`` imports torch: a client needs
none.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence


class WarmPool:
    """Thread-safe LRU of serve workers with hit/miss/eviction accounting."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f'warm pool capacity must be >= 1: {capacity}')
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: 'OrderedDict[tuple, Any]' = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple) -> Optional[Any]:
        """The entry for ``key`` (refreshing its recency) or None; counts
        a hit or a miss, which is the metrics' hit rate."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def peek(self, key: tuple) -> Optional[Any]:
        """Like :meth:`get`, but counts nothing and leaves the recency:
        for the double-checked insertion after a build."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key: tuple, entry: Any) -> List[Any]:
        """Insert a fresh entry; returns the entries LRU-evicted to make
        room, already ``close()``d (the caller joins and retires them).
        Only ``entry.idle()`` entries are evicted; when all are busy the
        pool runs over capacity until a later ``put`` finds an idle one."""
        evicted = []
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            excess = len(self._entries) - self.capacity
            if excess > 0:
                for k in list(self._entries):
                    if excess == 0:
                        break
                    if k == key:
                        continue
                    victim = self._entries[k]
                    if victim.idle():
                        del self._entries[k]
                        self.evictions += 1
                        evicted.append(victim)
                        excess -= 1
        for victim in evicted:
            victim.close()
        if evicted:
            import logging

            from video_features_torch.obs.events import event
            event(logging.INFO, 'warm pool evicted entries (LRU)',
                  subsystem='serve',
                  labels=[getattr(v, 'label', '?') for v in evicted],
                  size=len(self._entries), capacity=self.capacity)
        return evicted

    def entries(self) -> List[Any]:
        with self._lock:
            return list(self._entries.values())

    def remove(self, key: tuple, entry: Any = None) -> Optional[Any]:
        """Drop ``key`` without counting an eviction (a crashed worker's
        retirement; the caller closes it). With ``entry`` given, only if
        the slot still holds that entry: a crash must not evict the
        healthy replacement a concurrent submit installed under the key."""
        with self._lock:
            current = self._entries.get(key)
            if current is None or (entry is not None
                                   and current is not entry):
                return None
            del self._entries[key]
            return current

    def pop_all(self) -> List[Any]:
        """Remove every entry (the drain); the caller closes and joins."""
        with self._lock:
            out = list(self._entries.values())
            self._entries.clear()
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                'size': len(self._entries),
                'capacity': self.capacity,
                'hits': self.hits,
                'misses': self.misses,
                'hit_rate': (self.hits / total) if total else 0.0,
                'evictions': self.evictions,
            }


def device_id(device) -> int:
    """A device's ordinal: ``torch.device('cuda', i).index`` (the CPU and
    an unindexed device are 0), or the ``id`` of a device object that
    carries one."""
    ident = getattr(device, 'id', None)
    if ident is None:
        ident = getattr(device, 'index', None)
    return int(ident or 0)


class DevicePlacer:
    """Least-loaded device placement for warm-pool entries.

    Tracks how many resident entries, and how many resident bytes, each
    local device carries, and gives every newly built extractor the
    least-loaded device(s): ranked by bytes first, then entries, then the
    ordinal. Entries are not interchangeable: a ``compute_dtype=bfloat16``
    entry holds about half the params bytes of its fp32 sibling and an
    ``int8`` one about a quarter, so two bf16 entries, or four int8 ones,
    stack on one device before a second fp32 copy does. A caller that
    does not know its size passes 0 and the ranking is by entry count.
    Release on retirement (eviction, crash) returns the devices and the
    bytes. On a one-device host every assignment is that device.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._load: Dict[int, int] = {}      # device ordinal → entries
        self._bytes: Dict[int, int] = {}     # device ordinal → params bytes

    def assign(self, devices: Sequence, n: int, nbytes: int = 0) -> list:
        """Pick the ``n`` least-loaded of ``devices`` and count each as
        holding ``nbytes`` (a mesh entry holds one copy per device).
        ``n`` is clamped to what exists."""
        n = max(1, min(int(n or 1), len(devices)))
        nbytes = max(int(nbytes or 0), 0)
        with self._lock:
            ranked = sorted(devices,
                            key=lambda d: (self._bytes.get(device_id(d), 0),
                                           self._load.get(device_id(d), 0),
                                           device_id(d)))
            chosen = ranked[:n]
            for d in chosen:
                i = device_id(d)
                self._load[i] = self._load.get(i, 0) + 1
                self._bytes[i] = self._bytes.get(i, 0) + nbytes
        return chosen

    def release(self, devices: Optional[Sequence],
                nbytes: int = 0) -> None:
        nbytes = max(int(nbytes or 0), 0)
        with self._lock:
            for d in devices or ():
                # zero counts stay, so a drained device's gauge reads 0
                # rather than its last nonzero value
                i = device_id(d)
                self._load[i] = max(self._load.get(i, 0) - 1, 0)
                self._bytes[i] = max(self._bytes.get(i, 0) - nbytes, 0)

    def snapshot(self) -> Dict[str, int]:
        """``d<i>`` → resident entries (``vft_device_resident_entries``)."""
        with self._lock:
            return {f'd{i}': c for i, c in sorted(self._load.items())}

    def snapshot_bytes(self) -> Dict[str, int]:
        """``d<i>`` → resident params bytes
        (``vft_device_resident_bytes``)."""
        with self._lock:
            return {f'd{i}': b for i, b in sorted(self._bytes.items())}
