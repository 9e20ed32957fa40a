"""Per-stage wall-time accounting for the device loops, and the seam to
the flight recorder (port of ``video_features_tpu/utils/tracing.py``:
``STAGES``, ``Tracer``, ``NULL_TRACER``, ``merge_reports``,
``round_report``; ``torch_profiler_trace`` takes the place of
``jax_profiler_trace``).

  * :class:`Tracer` is a thread-safe accumulator of named stage timings:
    ``with tracer.stage('h2d'): ...``, or ``tracer.wrap_iter('decode',
    loader)``, which times each ``next()`` on the thread that runs it
    (the prefetch producer for streaming decode);
  * with a ``recorder`` (``obs.spans.SpanRecorder``) attached, every
    timed stage is also a span on the timeline that ``trace_out=``
    exports, with the ``attrs`` given to ``stage``/``add`` as its args:
    the table and the timeline are two views of the same sites;
  * ``add_occupancy`` counts how many of a batch's slots carried real
    work, so the table shows the padded share (``occ%``);
  * the ``ramp`` column is the first call over the steady-state mean:
    the warm-up wall a run pays once (cuDNN's algorithm choice, the
    kernels' build, the caching allocator's first blocks);
  * :data:`NULL_TRACER` is disabled: an instrumentation site then costs
    an attribute load and a truthiness check;
  * :func:`torch_profiler_trace` (``profile_dir=``) wraps a run in
    ``torch.profiler`` and writes a Chrome trace of its CPU ops and CUDA
    kernels.

``profile: true`` (any family) prints the table to stderr after each
video and after a packed run. The stage names are :data:`STAGES`; with
the decode farm (``farm/``), ``decode`` is one window's decode and host
transform inside a worker process (its span on that worker's own pid
lane, placed on the parent's clock; the workers run in parallel, so its
total can exceed the wall), and ``shm_copy`` is the parent's copy of a
window out of the worker's shared-memory ring (its ``occ%`` is the
ring's fill when the window was shipped).

Nothing here imports torch at module level: a spawned decode worker
imports this module.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional

# The stage vocabulary of the table, the timeline and the run manifest
# (the JAX package's, unchanged). ``model`` is the step's dispatch and
# whatever runs before it returns; ``d2h`` the deferred readback and the
# wait for the step, so readback never counts as compute.
STAGES = (
    'decode',             # raw decode (stack families without preprocess)
    'decode+preprocess',  # decode + host transform on the prefetch thread
    'audio_dsp',          # vggish: host-side mel/log-mel DSP on the wav
    'queue_idle',         # serve: blocking waits on an idle request feed
    'pack',               # packed batch assembly (pool flush + np.stack)
    'h2d',                # host→device input transfer (producer thread)
    'model',              # device-step dispatch + compute until the sync
    'd2h',                # deferred device→host readback of step outputs
    'save',               # output materialization (.npy/.pkl writes)
    'cache_lookup',       # content-addressed cache consult
    'cache_publish',      # content-addressed cache publish
)


class _StageStat:
    __slots__ = ('count', 'total_s', 'max_s', 'first_s', 'occ_valid',
                 'occ_capacity', 'occ_device')

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.first_s = 0.0
        self.occ_valid = 0
        self.occ_capacity = 0
        # mesh-sharded batches: device label → [valid, capacity], kept
        # apart from the aggregate (recorded once per batch at the global
        # capacity), so neither view double-counts the other
        self.occ_device: Optional[Dict[str, list]] = None

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
    """Thread-safe named-stage wall-time accumulator; with a ``recorder``
    attached, each timed stage is also a span event."""

    def __init__(self, enabled: bool = True, recorder=None) -> None:
        self.enabled = enabled
        self.recorder = recorder
        # the stall watchdog's liveness hook (obs/watchdog.py): called
        # with (stage, worker) on every recorded stage, ``worker`` being
        # the decode farm worker's index where the span names one
        self.progress = None
        self._lock = threading.Lock()
        self._stats: Dict[str, _StageStat] = {}
        self._order: List[str] = []

    def _stat(self, name: str) -> _StageStat:
        stat = self._stats.get(name)
        if stat is None:
            stat = self._stats[name] = _StageStat()
            self._order.append(name)
        return stat

    def add(self, name: str, dt: float, t0: Optional[float] = None,
            span_pid: Optional[int] = None, span_tid: Optional[int] = None,
            **attrs) -> None:
        """Record ``dt`` seconds under ``name``. On an attached recorder
        the span starts at ``t0`` (this process's ``perf_counter``; without
        it, ``dt`` before now), under ``span_pid``/``span_tid`` when given
        (a decode worker's span), with ``attrs`` as its args."""
        if not self.enabled:
            return
        rec = self.recorder
        if rec is not None and rec.enabled:
            if t0 is None:
                t0 = time.perf_counter() - dt
            rec.span(name, t0, t0 + dt, pid=span_pid, tid=span_tid, **attrs)
        progress = self.progress
        if progress is not None:
            try:
                progress(name, attrs.get('worker'))
            except Exception:
                # vft-lint: ok=swallowed-exception — a broken liveness
                # hook must not fail the loop
                pass
        with self._lock:
            self._stat(name).add(dt)

    def add_occupancy(self, name: str, valid: int, capacity: int,
                      device: Optional[str] = None) -> None:
        """Record that a ``capacity``-slot batch under ``name`` carried
        ``valid`` real items (the rest was padding). With ``device`` (a
        mesh shard's label) the counts go to that device's record."""
        if not self.enabled:
            return
        with self._lock:
            stat = self._stat(name)
            if device is not None:
                if stat.occ_device is None:
                    stat.occ_device = {}
                rec = stat.occ_device.setdefault(str(device), [0, 0])
                rec[0] += int(valid)
                rec[1] += int(capacity)
            else:
                stat.occ_valid += int(valid)
                stat.occ_capacity += int(capacity)

    @contextmanager
    def stage(self, name: str, **attrs):
        """Time a block under ``name`` (a no-op when disabled); ``attrs``
        annotate the span on an attached recorder."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, t0=t0, **attrs)

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
                self.add(name, time.perf_counter() - t0, t0=t0)
            yield item

    @staticmethod
    def _stat_record(s: _StageStat) -> Dict[str, float]:
        rec = {'count': s.count, 'total_s': s.total_s,
               'mean_s': s.total_s / max(s.count, 1), 'max_s': s.max_s,
               'first_s': s.first_s}
        ramp = s.ramp()
        if ramp is not None:
            rec['ramp'] = ramp
        occ = s.occupancy()
        if occ is not None:
            # the raw counts ride along so reports stay mergeable
            rec['occupancy'] = occ
            rec['occ_valid'] = s.occ_valid
            rec['occ_capacity'] = s.occ_capacity
        if s.occ_device:
            rec['occ_device'] = {
                dev: {'occ_valid': v, 'occ_capacity': c,
                      'occupancy': (v / c) if c else 0.0}
                for dev, (v, c) in s.occ_device.items()}
        return rec

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: self._stat_record(s) for name, s in self._stats.items()}

    def summary(self) -> str:
        """The stage table in order of first occurrence: count, total,
        mean, share of the summed stage time, ``occ%`` and ``ramp``."""
        with self._lock:
            order = list(self._order)
            rep = {name: self._stat_record(s) for name, s in self._stats.items()}
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
            for dev, d in (r.get('occ_device') or {}).items():
                md = m.setdefault('occ_device', {}).setdefault(
                    dev, {'occ_valid': 0, 'occ_capacity': 0})
                md['occ_valid'] += d.get('occ_valid', 0)
                md['occ_capacity'] += d.get('occ_capacity', 0)
    for m in merged.values():
        m['mean_s'] = m['total_s'] / max(m['count'], 1)
        if m.get('occ_capacity'):
            m['occupancy'] = m['occ_valid'] / m['occ_capacity']
        for md in (m.get('occ_device') or {}).values():
            md['occupancy'] = (md['occ_valid'] / md['occ_capacity']
                               if md['occ_capacity'] else 0.0)
    return merged


def round_report(report: Dict[str, Dict[str, float]],
                 ndigits: int = 6) -> Dict[str, Dict[str, float]]:
    """A report with its floats rounded, for compact JSON."""
    def _round(v):
        if isinstance(v, float):
            return round(v, ndigits)
        if isinstance(v, dict):             # occ_device's records
            return {k: _round(x) for k, x in v.items()}
        return v

    return {name: {k: _round(v) for k, v in rec.items()}
            for name, rec in report.items()}


@contextmanager
def torch_profiler_trace(profile_dir: Optional[str]):
    """Run the block under ``torch.profiler`` (CPU and, on a machine with
    a card, CUDA activities) and write its Chrome trace under
    ``profile_dir`` as ``<host>_<pid>.<ns>.pt.trace.json``; a null
    ``profile_dir`` is a no-op. The trace names each CUDA kernel the block
    launched (the RAFT path's ``masked_kernel`` and ``gru_tf32x3``); open
    it in Perfetto. (The JAX package writes an XLA profile there.) A
    trace that cannot be written is a warning event, never a failed run."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    write = tensorboard_trace_handler(str(profile_dir))

    def on_trace_ready(prof) -> None:
        try:
            write(prof)
        except Exception:
            import logging

            from video_features_torch.obs.events import event
            event(logging.WARNING, 'profile_dir trace export failed',
                  subsystem='obs', exc_info=True, path=str(profile_dir))

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=on_trace_ready):
        yield
