"""Per-stage wall-time accounting for the device loops (port of
``video_features_tpu/utils/tracing.py``: ``Tracer``, ``NULL_TRACER``,
``merge_reports``, ``round_report``).

  * :class:`Tracer` is a thread-safe accumulator of named stage timings:
    ``with tracer.stage('h2d'): ...``, or ``tracer.wrap_iter('decode',
    loader)``, which times each ``next()`` on the thread that runs it
    (the prefetch producer for streaming decode);
  * ``add_occupancy`` counts how many of a batch's slots carried real
    work, so the table shows the padded share (``occ%``);
  * the ``ramp`` column is the first call over the steady-state mean:
    the warm-up wall a run pays once (cuDNN's algorithm choice, the
    kernels' build, the caching allocator's first blocks);
  * :data:`NULL_TRACER` is disabled: an instrumentation site then costs
    an attribute load and a truthiness check.

``profile: true`` (any family) prints the table to stderr after each
video and after a packed run. The stage names: ``decode`` (r21d's and
s3d's raw decode) and ``decode+preprocess`` (decode and host transform),
both on the producer thread, ``pack``
(packed batch assembly), ``h2d`` (the copy to the card, producer
thread), ``model`` (the step's launch on the consumer thread), ``d2h``
(the deferred readback and the wait for the step it follows), ``save``;
with the decode farm (``farm/``), ``decode`` is one window's decode and
host transform inside a worker process (the workers run in parallel, so
its total can exceed the wall), and ``shm_copy`` (the parent's copy of a
window out of the worker's shared-memory ring; its ``occ%`` is the
ring's fill when the window was shipped). The farm's ``decode`` spans
also keep their start (``spans``), placed on the parent's clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional

SPAN_CAPACITY = 100_000


class _StageStat:
    __slots__ = ('count', 'total_s', 'max_s', 'first_s', 'occ_valid',
                 'occ_capacity')

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.first_s = 0.0
        self.occ_valid = 0
        self.occ_capacity = 0

    def add(self, dt: float) -> None:
        if self.count == 0:
            self.first_s = dt
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    def ramp(self) -> Optional[float]:
        """First-call time over the steady-state mean (None until two
        calls): ~1 means no warm-up."""
        if self.count < 2:
            return None
        steady = (self.total_s - self.first_s) / (self.count - 1)
        return self.first_s / steady if steady > 0 else None

    def occupancy(self) -> Optional[float]:
        """Valid slots over all batch slots (None if never recorded)."""
        if self.occ_capacity <= 0:
            return None
        return self.occ_valid / self.occ_capacity


class Tracer:
    """Thread-safe named-stage wall-time accumulator."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: Dict[str, _StageStat] = {}
        self._order: List[str] = []
        # (name, t0, dt) of the spans recorded with their start, newest
        # SPAN_CAPACITY kept
        self.spans: deque = deque(maxlen=SPAN_CAPACITY)

    def _stat(self, name: str) -> _StageStat:
        stat = self._stats.get(name)
        if stat is None:
            stat = self._stats[name] = _StageStat()
            self._order.append(name)
        return stat

    def add(self, name: str, dt: float, t0: Optional[float] = None) -> None:
        """Record ``dt`` seconds under ``name``; with ``t0`` (its start on
        this process's ``perf_counter`` clock) also the span."""
        if not self.enabled:
            return
        with self._lock:
            self._stat(name).add(dt)
            if t0 is not None:
                self.spans.append((name, t0, dt))

    def add_occupancy(self, name: str, valid: int, capacity: int) -> None:
        """Record that a ``capacity``-slot batch under ``name`` carried
        ``valid`` real items (the rest was padding)."""
        if not self.enabled:
            return
        with self._lock:
            stat = self._stat(name)
            stat.occ_valid += int(valid)
            stat.occ_capacity += int(capacity)

    @contextmanager
    def stage(self, name: str):
        """Time a block under ``name`` (a no-op when disabled)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def wrap_iter(self, name: str, iterable: Iterable) -> Iterator:
        """Yield from ``iterable``, timing each ``next()`` under ``name``."""
        if not self.enabled:
            yield from iterable
            return
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self.add(name, time.perf_counter() - t0)
            yield item

    @staticmethod
    def _record(s: _StageStat) -> Dict[str, float]:
        rec = {'count': s.count, 'total_s': s.total_s,
               'mean_s': s.total_s / max(s.count, 1), 'max_s': s.max_s,
               'first_s': s.first_s}
        ramp = s.ramp()
        if ramp is not None:
            rec['ramp'] = ramp
        occ = s.occupancy()
        if occ is not None:
            # the raw counts ride along so reports stay mergeable
            rec.update(occupancy=occ, occ_valid=s.occ_valid,
                       occ_capacity=s.occ_capacity)
        return rec

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: self._record(s) for name, s in self._stats.items()}

    def summary(self) -> str:
        """The stage table in order of first occurrence: count, total,
        mean, share of the summed stage time, ``occ%`` and ``ramp``."""
        with self._lock:
            order = list(self._order)
            rep = {name: self._record(s) for name, s in self._stats.items()}
        if not rep:
            return '(no stages recorded)'
        total = sum(r['total_s'] for r in rep.values())
        width = max(len(n) for n in order)
        lines = [f'{"stage".ljust(width)} | count |  total s |   mean ms '
                 f'| share |  occ% |   ramp']
        for name in order:
            r = rep[name]
            share = r['total_s'] / total * 100 if total else 0.0
            occ = (f'{r["occupancy"] * 100:5.1f}' if 'occupancy' in r
                   else '    -')
            ramp = f'{r["ramp"]:6.1f}' if 'ramp' in r else '     -'
            lines.append(
                f'{name.ljust(width)} | {r["count"]:5d} | {r["total_s"]:8.3f} '
                f'| {r["mean_s"] * 1e3:9.2f} | {share:4.1f}% | {occ} | {ramp}')
        return '\n'.join(lines)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._order.clear()
            self.spans.clear()


NULL_TRACER = Tracer(enabled=False)


def merge_reports(reports: Iterable[Dict[str, Dict[str, float]]]
                  ) -> Dict[str, Dict[str, float]]:
    """Several ``Tracer.report()`` dicts → one: counts and totals sum,
    ``max_s`` and ``first_s`` take the worst, occupancy recombines from
    the raw slot counts; ``ramp`` is per tracer and is dropped."""
    merged: Dict[str, Dict[str, float]] = {}
    for rep in reports:
        for name, r in rep.items():
            m = merged.setdefault(name, {'count': 0, 'total_s': 0.0,
                                         'max_s': 0.0, 'first_s': 0.0})
            m['count'] += r.get('count', 0)
            m['total_s'] += r.get('total_s', 0.0)
            m['max_s'] = max(m['max_s'], r.get('max_s', 0.0))
            m['first_s'] = max(m['first_s'], r.get('first_s', 0.0))
            if 'occ_capacity' in r:
                m['occ_valid'] = m.get('occ_valid', 0) + r['occ_valid']
                m['occ_capacity'] = m.get('occ_capacity', 0) + r['occ_capacity']
    for m in merged.values():
        m['mean_s'] = m['total_s'] / max(m['count'], 1)
        if m.get('occ_capacity'):
            m['occupancy'] = m['occ_valid'] / m['occ_capacity']
    return merged


def round_report(report: Dict[str, Dict[str, float]],
                 ndigits: int = 6) -> Dict[str, Dict[str, float]]:
    """A report with its floats rounded, for compact JSON."""
    return {name: {k: round(v, ndigits) if isinstance(v, float) else v
                   for k, v in rec.items()}
            for name, rec in report.items()}
