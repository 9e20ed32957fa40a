"""Span timeline: a bounded ring buffer of trace events and its Chrome
trace export (the port's copy of ``video_features_tpu/obs/spans.py``).

The stage table (``utils/tracing.Tracer``) says where the wall time goes
in aggregate; the timeline says what happened when. Every
``Tracer.stage``/``add`` forwards its start, duration and attrs to an
attached :class:`SpanRecorder`, so the table and the timeline are two
views of the same instrumentation sites.

Recording is a ``deque`` append under one lock: no I/O and no
formatting. When the ring wraps the oldest events drop and ``dropped``
counts them. The export is Chrome trace-event JSON (``traceEvents``;
open it at https://ui.perfetto.dev): complete events (``ph='X'``) with
``ts``/``dur`` in microseconds, instants (``ph='i'``) for lifecycle
points, and metadata events naming the recording threads.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

# one clock for every span, the one Tracer uses
CLOCK = time.perf_counter

# the ring's default size, in events
DEFAULT_CAPACITY = 200_000


class SpanRecorder:
    """Thread-safe bounded recorder of span and instant trace events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (ph, name, t_start_s, dur_s, tid, attrs|None, pid|None); a pid
        # and tid of another process place a span its worker measured
        # (the decode farm's) under that worker's lane
        self._events: 'deque' = deque(maxlen=self.capacity)
        self._appended = 0
        self._thread_names: Dict[int, str] = {}
        # ts=0 on CLOCK, and the wall clock at that point
        self._t0 = CLOCK()
        self._wall0 = time.time()
        # the earliest start ever appended, kept at append time so
        # origin() is O(1); never raised on eviction (an older origin only
        # shifts timestamps later)
        self._min_ts = self._t0

    # -- recording -----------------------------------------------------------

    def span(self, name: str, t_start: float, t_end: float,
             pid: Optional[int] = None, tid: Optional[int] = None,
             **attrs: Any) -> None:
        """Record one complete ('X') span between two ``CLOCK()``
        readings; ``attrs`` become its ``args``; ``pid``/``tid`` replace
        the recording process and thread."""
        if not self.enabled:
            return
        own_thread = tid is None
        if own_thread:
            tid = threading.get_ident()
        with self._lock:
            if own_thread and tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if t_start < self._min_ts:
                self._min_ts = t_start
            self._events.append(('X', name, t_start, t_end - t_start,
                                 int(tid), attrs or None, pid))
            self._appended += 1

    def instant(self, name: str, **attrs: Any) -> None:
        """Record an instant ('i') marker at now."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(('i', name, CLOCK(), 0.0, tid,
                                 attrs or None, None))
            self._appended += 1

    # -- export --------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events lost to the ring's wrap, oldest first."""
        with self._lock:
            return max(0, self._appended - len(self._events))

    def origin(self) -> float:
        """ts=0: the recorder's epoch or its earliest start, whichever is
        older, so no span exports a negative timestamp."""
        with self._lock:
            return min(self._t0, self._min_ts)

    def snapshot(self, origin: Optional[float] = None,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """The buffered events as Chrome trace-event dicts, ts-sorted.
        ``origin`` overrides ts=0 (``merge_traces`` passes one for all
        recorders); ``limit`` keeps the most recent ``limit`` events."""
        with self._lock:
            if limit is not None and limit < len(self._events):
                from itertools import islice
                events = list(islice(self._events,
                                     len(self._events) - int(limit),
                                     len(self._events)))
            else:
                events = list(self._events)
            names = dict(self._thread_names)
            if origin is None:
                origin = min(self._t0, self._min_ts)
        own_pid = os.getpid()
        out: List[Dict[str, Any]] = []
        for tid, tname in sorted(names.items()):
            out.append({'name': 'thread_name', 'ph': 'M', 'ts': 0,
                        'pid': own_pid, 'tid': tid,
                        'args': {'name': tname}})
        body = []
        for ph, name, ts, dur, tid, attrs, pid in events:
            ev: Dict[str, Any] = {
                'name': name, 'ph': ph,
                'pid': pid if pid is not None else own_pid, 'tid': tid,
                'ts': round((ts - origin) * 1e6, 3),
            }
            if ph == 'X':
                ev['dur'] = round(dur * 1e6, 3)
            else:
                ev['s'] = 't'           # instant scope: this thread
            if attrs:
                ev['args'] = {k: _jsonable(v) for k, v in attrs.items()}
            body.append(ev)
        # one sort at export keeps recording cheap; timestamps must rise
        body.sort(key=lambda e: e['ts'])
        return out + body

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON document to ``path`` atomically."""
        from video_features_torch.utils.output import atomic_write
        doc = {
            'traceEvents': self.snapshot(),
            'displayTimeUnit': 'ms',
            'otherData': {
                'tool': 'video_features_torch',
                'wall_epoch_s': self._wall0,
                'events_dropped': self.dropped,
            },
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        atomic_write(path, lambda f: f.write(
            json.dumps(doc).encode('utf-8')))
        return path


# a bytes attr renders at most this many bytes
_BYTES_RENDER_CAP = 256


def _jsonable(v: Any) -> Any:
    """The JSON-safe form of a span arg or manifest value."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (bytes, bytearray)):
        head = bytes(v[:_BYTES_RENDER_CAP])
        text = head.decode('ascii', 'backslashreplace')
        if len(v) > _BYTES_RENDER_CAP:
            text += f'...(+{len(v) - _BYTES_RENDER_CAP} bytes)'
        return text
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


#: disabled singleton: an instrumentation site can hold it unconditionally
NULL_RECORDER = SpanRecorder(capacity=1, enabled=False)


def merge_traces(recorders: Iterable[SpanRecorder],
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """One ts-sorted event list over several recorders, all on one
    origin (the oldest), so recorders made at different times stay in
    order; ``limit`` bounds each recorder's share to its newest events."""
    recorders = list(recorders)
    if not recorders:
        return []
    origin = min(rec.origin() for rec in recorders)
    events: List[Dict[str, Any]] = []
    for rec in recorders:
        events.extend(rec.snapshot(origin=origin, limit=limit))
    events.sort(key=lambda e: (e['ph'] != 'M', e['ts']))
    return events


def export_merged(recorders: Iterable[SpanRecorder], path: str) -> str:
    """Write one Chrome trace document of several recorders atomically."""
    from video_features_torch.utils.output import atomic_write
    recorders = [r for r in recorders if r is not None]
    doc = {
        'traceEvents': merge_traces(recorders),
        'displayTimeUnit': 'ms',
        'otherData': {
            'tool': 'video_features_torch',
            'recorders_merged': len(recorders),
            'events_dropped': sum(r.dropped for r in recorders),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write(path, lambda f: f.write(json.dumps(doc).encode('utf-8')))
    return path


# -- validation (the port's copy of tools/trace_view.py::validate_events) ----

#: every key a trace event of this package may carry
TRACE_EVENT_KEYS = frozenset({'name', 'ph', 'ts', 'dur', 'pid', 'tid',
                              'args', 's'})
REQUIRED_KEYS = ('name', 'ph', 'ts', 'pid', 'tid')
META_PHASES = ('M',)


def validate_events(events: List[Dict[str, Any]]) -> List[str]:
    """Every violation in a trace-event list (empty: valid): the required
    keys, ``ts >= 0`` and non-decreasing over the timeline events,
    ``dur >= 0`` on complete events, balanced ``B``/``E`` pairs per
    (pid, tid), and a ``span_id`` beside every ``trace_id``."""
    from collections import defaultdict
    errors: List[str] = []
    open_stacks: Dict[tuple, List[str]] = defaultdict(list)
    last_ts = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f'event[{i}]: not an object')
            continue
        missing = [k for k in REQUIRED_KEYS if k not in ev]
        if missing:
            errors.append(f'event[{i}] ({ev.get("name")!r}): missing '
                          f'keys {missing}')
            continue
        ph = ev['ph']
        if ph in META_PHASES:
            continue
        args = ev.get('args')
        if isinstance(args, dict) and 'trace_id' in args \
                and 'span_id' not in args:
            errors.append(f'event[{i}] ({ev["name"]!r}): args carry '
                          f'trace_id without span_id')
        ts = ev['ts']
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f'event[{i}] ({ev["name"]!r}): bad ts {ts!r}')
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f'event[{i}] ({ev["name"]!r}): ts {ts} < '
                          f'previous {last_ts} (not monotonic)')
        last_ts = ts
        if ph == 'X':
            dur = ev.get('dur')
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f'event[{i}] ({ev["name"]!r}): X event '
                              f'with bad dur {dur!r}')
        elif ph == 'B':
            open_stacks[(ev['pid'], ev['tid'])].append(ev['name'])
        elif ph == 'E':
            stack = open_stacks[(ev['pid'], ev['tid'])]
            if not stack:
                errors.append(f'event[{i}] ({ev["name"]!r}): E without '
                              f'matching B on tid {ev["tid"]}')
            elif stack[-1] != ev['name']:
                errors.append(f'event[{i}]: E {ev["name"]!r} crosses '
                              f'open B {stack[-1]!r}')
            else:
                stack.pop()
    for (pid, tid), stack in open_stacks.items():
        if stack:
            errors.append(f'unclosed B events on pid {pid} tid {tid}: '
                          f'{stack}')
    return errors
