"""Stall watchdog: liveness detection for the serve daemon's workers (the
port's copy of ``video_features_tpu/obs/watchdog.py``).

The daemon's failure modes split in two: crashes (the worker's exception
handler and the black box own those) and wedges, a worker that holds
queued work but has stopped advancing (a decoder hung on a truncated
file, a device call that never returns, a farm ring nobody drains).

This module keeps a **progress ledger**: per worker (serve warm-pool
entries and decode farm workers alike) the last time any stage advanced,
which stage it was, and how much work the worker holds. A monitor thread
trips when a worker has held pending work for longer than
``watchdog_stall_s`` without a stage advance; a trip

  * emits a structured ERROR event (worker, stage, pending, stalled
    seconds),
  * increments ``vft_watchdog_stalls_total{stage}`` on the owning
    registry (the stage label is the LAST stage that advanced;
    ``admission`` when work was queued but nothing ever started),
  * fires ``on_stall`` (the serve daemon dumps the black box there).

A tripped worker does not trip again until it advances; an idle worker
with an empty queue never trips. Advances come from the tracer's
``progress`` hook (``utils/tracing.py``), so the ledger rides the same
instrumentation sites as the stage table and the span timeline.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# stage label for "work queued, nothing ever advanced"
STAGE_NOT_STARTED = 'admission'


class _WorkerLedger:
    __slots__ = ('last_advance', 'last_stage', 'pending', 'stalled')

    def __init__(self, now: float) -> None:
        self.last_advance = now
        self.last_stage = STAGE_NOT_STARTED
        self.pending = 0
        self.stalled = False


class StallWatchdog:
    """Progress ledger + monitor thread (see module docstring)."""

    def __init__(self, stall_s: float,
                 on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
                 registry=None,
                 interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.stall_s = float(stall_s)
        if self.stall_s <= 0:
            raise ValueError(f'stall_s must be > 0; got {stall_s}')
        self.on_stall = on_stall
        self._clock = clock
        self.interval_s = (float(interval_s) if interval_s is not None
                           else max(0.05, min(self.stall_s / 4.0, 5.0)))
        self._registry = registry
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerLedger] = {}
        self.stalls_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ledger feeds (hot-ish paths: one lock, no allocation) ---------------

    def advance(self, worker: str, stage: str) -> None:
        """A canonical stage made progress for ``worker`` (fed from the
        Tracer ``progress`` hook — every timed stage completion)."""
        now = self._clock()
        with self._lock:
            rec = self._workers.get(worker)
            if rec is None:
                rec = self._workers[worker] = _WorkerLedger(now)
            rec.last_advance = now
            rec.last_stage = stage
            rec.stalled = False

    def set_pending(self, worker: str, pending: int) -> None:
        """How much queued-or-in-flight work ``worker`` holds. The
        0 → positive edge resets the advance clock: a worker idle for an
        hour must get a full ``stall_s`` after NEW work arrives, not an
        instant trip."""
        now = self._clock()
        with self._lock:
            rec = self._workers.get(worker)
            if rec is None:
                rec = self._workers[worker] = _WorkerLedger(now)
            if pending > 0 and rec.pending == 0:
                rec.last_advance = now
                rec.stalled = False
            rec.pending = int(pending)

    def forget(self, worker: str) -> None:
        """Drop a retired worker's row (pool eviction/crash retirement —
        the ledger must not grow with lifetime churn)."""
        with self._lock:
            self._workers.pop(worker, None)

    def forget_prefix(self, prefix: str) -> None:
        """Drop every row under ``prefix`` — a retired serve worker
        takes its farm sub-rows (``label/farm-wN``) with it."""
        with self._lock:
            for key in [w for w in self._workers
                        if w.startswith(prefix)]:
                del self._workers[key]

    # -- monitoring ----------------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One monitor pass; returns (and reports) the stalls it fired.
        Public so tests and embedders can drive it without the thread."""
        if now is None:
            now = self._clock()
        fired: List[Dict[str, Any]] = []
        with self._lock:
            for worker, rec in self._workers.items():
                if rec.pending <= 0 or rec.stalled:
                    continue
                stalled_for = now - rec.last_advance
                if stalled_for < self.stall_s:
                    continue
                rec.stalled = True
                self.stalls_total += 1
                fired.append({'worker': worker,
                              'stage': rec.last_stage,
                              'pending': rec.pending,
                              'stalled_s': round(stalled_for, 3)})
        for info in fired:
            self._report(info)
        return fired

    def _report(self, info: Dict[str, Any]) -> None:
        from video_features_torch.obs.events import event
        event(logging.ERROR,
              'watchdog: worker stalled with queued work',
              subsystem='watchdog', worker=info['worker'],
              stage=info['stage'], pending=info['pending'],
              stalled_s=info['stalled_s'])
        if self._registry is not None:
            try:
                self._registry.counter(
                    'vft_watchdog_stalls_total',
                    'stage-stall trips: a worker held queued work past '
                    'watchdog_stall_s without a stage advance',
                    labels={'stage': info['stage']}).inc()
            except Exception:
                # vft-lint: ok=swallowed-exception — the stall is
                # already reported through the event above; a metrics
                # bump must not break the monitor thread
                pass
        if self.on_stall is not None:
            try:
                self.on_stall(info)
            except Exception:
                event(logging.WARNING, 'watchdog on_stall hook failed',
                      subsystem='watchdog', exc_info=True,
                      worker=info['worker'])

    def snapshot(self) -> Dict[str, Any]:
        """The metrics-document view: per-worker last stage / seconds
        since advance / pending, plus the lifetime trip count."""
        now = self._clock()
        with self._lock:
            workers = {
                w: {'stage': rec.last_stage,
                    'pending': rec.pending,
                    'since_advance_s': round(now - rec.last_advance, 3),
                    'stalled': rec.stalled}
                for w, rec in self._workers.items()}
            return {'enabled': True, 'stall_s': self.stall_s,
                    'stalls_total': self.stalls_total,
                    'workers': workers}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> 'StallWatchdog':
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name='vft-watchdog', daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.interval_s + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                # vft-lint: ok=swallowed-exception — one broken pass
                # must not end liveness monitoring for the daemon's
                # lifetime; the next tick retries
                pass
