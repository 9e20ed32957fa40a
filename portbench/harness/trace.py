"""The traced run's readings: the program's stage spans (its ``Tracer``,
given a recorder of the benchmark's), ``record_function`` ranges the
benchmark puts around the program's layers, and the device activity
``torch.profiler`` records, all reduced to the traced window."""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# what ran on the device: kernels and copies (never the annotations)
DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


class SpanLog:
    """A recorder for the program's ``Tracer``: every stage it times,
    as (name, start, end) on ``time.perf_counter``'s clock."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def span(self, name, t0, t1, pid=None, tid=None, **attrs) -> None:
        with self._lock:
            self.spans.append((name, t0, t1))

    def instant(self, name, **attrs) -> None:
        pass

    def total(self, name: str, t_a: float, t_b: float) -> float:
        """Seconds of ``name`` spans inside [t_a, t_b], clipped to it."""
        return sum(max(0.0, min(e, t_b) - max(s, t_a))
                   for n, s, e in self.spans if n == name)


def kept_tracer(recorder):
    """The program's ``Tracer`` with ``recorder`` attached, whose tables
    survive the loop's end-of-run reset (kept in ``.reports``)."""
    from video_features_torch.utils.tracing import Tracer

    class KeptTracer(Tracer):
        def __init__(self) -> None:
            super().__init__(recorder=recorder)
            self.reports: List[dict] = []

        def reset(self) -> None:
            self.reports.append(self.report())
            super().reset()

        def merged(self) -> dict:
            from video_features_torch.utils.tracing import merge_reports
            return merge_reports(self.reports + [self.report()])

    return KeptTracer()


@contextmanager
def ranges(targets: Dict[str, Tuple[object, str]]):
    """Wrap each ``module.attr`` in a ``record_function`` range named by
    its key, for the block: {range: (module, attr)}."""
    import torch
    saved = []
    for name, (module, attr) in targets.items():
        orig = getattr(module, attr)

        def wrapped(*a, _orig=orig, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _orig(*a, **k)
        saved.append((module, attr, orig))
        setattr(module, attr, wrapped)
    try:
        yield
    finally:
        for module, attr, orig in saved:
            setattr(module, attr, orig)


def epoch_offset_ns() -> int:
    """Add to ``perf_counter_ns`` to get the profiler's clock (epoch ns)."""
    return time.time_ns() - time.perf_counter_ns()


def activity(ev) -> str:
    """A profiler record's activity type (``activity_type()`` where the
    torch release has it, else told from its device and name)."""
    kind = getattr(ev, 'activity_type', None)
    if kind is not None:
        return kind()
    name = ev.name()
    if str(ev.device_type()).endswith('CUDA'):
        if name.startswith('portbench.') or getattr(
                ev, 'is_user_annotation', lambda: False)():
            return 'gpu_user_annotation'
        if name.startswith('Memcpy'):
            return 'gpu_memcpy'
        if name.startswith('Memset'):
            return 'gpu_memset'
        return 'kernel'
    if name.startswith('portbench.'):
        return 'user_annotation'
    return 'cuda_runtime' if name.startswith('cu') else 'cpu_op'


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """The profiler's events reduced to [t_a, t_b] (epoch ns): busy
    seconds, kernel seconds by name, kernel seconds and instances of each
    benchmark range, and idle gaps."""

    def __init__(self, events, t_a: int, t_b: int) -> None:
        self.t_a, self.t_b = t_a, t_b
        device: List[Tuple[int, int, str, int, str]] = []
        launches: Dict[int, int] = {}
        annots: List[Tuple[int, int, str]] = []
        for ev in events:
            kind = activity(ev)
            if kind in DEVICE_ACTIVITIES:
                s = ev.start_ns()
                device.append((s, s + ev.duration_ns(), ev.name(),
                               ev.correlation_id(), kind))
            elif kind in ('cuda_runtime', 'cuda_driver'):
                launches[ev.correlation_id()] = ev.start_ns()
            elif kind == 'user_annotation' and ev.name().startswith('portbench.'):
                s = ev.start_ns()
                annots.append((s, s + ev.duration_ns(), ev.name()))
        clipped = [(max(s, t_a), min(e, t_b), n, c, k)
                   for s, e, n, c, k in device if e > t_a and s < t_b]
        self.busy = _union([(s, e) for s, e, *_ in clipped])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.window_s = (t_b - t_a) / 1e9
        self.by_name: Dict[str, float] = defaultdict(float)
        for s, e, n, _, _ in clipped:
            self.by_name[n] += (e - s) / 1e9
        # each kernel to the benchmark range its launch fell in
        annots = [a for a in annots if a[1] > t_a and a[0] < t_b]
        annots.sort()
        starts = [a[0] for a in annots]
        self.range_calls: Dict[str, int] = defaultdict(int)
        for s, e, name in annots:
            if s >= t_a and e <= t_b:
                self.range_calls[name] += 1
        inside = {i for i, (s, e, _) in enumerate(annots) if s >= t_a and e <= t_b}
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for s, e, n, corr, kind in device:
            if kind != 'kernel':
                continue
            launched = launches.get(corr)
            if launched is None:
                continue
            i = bisect.bisect_right(starts, launched) - 1
            if i in inside and launched <= annots[i][1]:
                spans[annots[i][2]].append((s, e))
        # the device time of a range's kernels: the union of their
        # intervals (cuDNN runs some of its kernels side by side)
        self.range_s: Dict[str, float] = {
            name: sum(e - s for s, e in _union(iv)) / 1e9
            for name, iv in spans.items()}

    def idle_gaps(self) -> List[Tuple[int, int]]:
        edges = [self.t_a] + [x for iv in self.busy for x in iv] + [self.t_b]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def breakdown(self, spans: Optional[SpanLog], offset_ns: int) -> dict:
        """The ten device operations with the most time, and the idle
        time by the program stage open on the host at each gap's middle
        ('no stage' where none was)."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        # one sweep over span edges and gap middles, in time order
        marks = []
        for n, s, e in (spans.spans if spans else []):
            marks.append((int(s * 1e9) + offset_ns, 0, n))
            marks.append((int(e * 1e9) + offset_ns, 2, n))
        for s, e in self.idle_gaps():
            marks.append(((s + e) // 2, 1, e - s))
        marks.sort(key=lambda m: (m[0], m[1]))
        active: Dict[str, int] = defaultdict(int)
        idle: Dict[str, float] = defaultdict(float)
        for _, kind, what in marks:
            if kind == 0:
                active[what] += 1
            elif kind == 2:
                active[what] -= 1
            else:
                names = '+'.join(sorted(n for n, c in active.items() if c > 0))
                idle[names or 'no stage'] += what / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[n[:120], v] for n, v in ops],
                'idle_gaps': [[n, v] for n, v in gaps]}


@contextmanager
def profiled():
    """``torch.profiler`` over the block, CPU and CUDA activity; yields a
    holder whose ``events`` are the raw records once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        events: list = []

    holder = Holder()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.events = prof.profiler.kineto_results.events()
