"""Metrics registry: counters, gauges and histograms with Prometheus
text rendering (the port's copy of ``video_features_tpu/obs/metrics.py``).

Series are identified by ``(name, labels)`` as Prometheus families are:
the same name with other labels extends the family, and registering an
existing series returns the same object, so call sites grab a metric by
name. :meth:`MetricsRegistry.render` writes the text exposition format
0.0.4 (``# HELP``/``# TYPE`` once per family, one sample line per
series, histograms as cumulative ``_bucket{le=...}``, ``_sum`` and
``_count``); :meth:`MetricsRegistry.collect` a JSON-able snapshot.
:data:`REGISTRY` is the process-wide registry (the decode farm's
``vft_farm_*`` series); the black box dumps it.

Every mutation takes the metric's own lock; the registry's lock guards
registration only.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

# default histogram buckets: request/stage latencies from sub-10ms cache
# hits up to multi-minute cold extractions
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

LabelPairs = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelPairs:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _fmt_value(v: float) -> str:
    if v != v:                                    # NaN
        return 'NaN'
    if v in (math.inf, -math.inf):
        return '+Inf' if v > 0 else '-Inf'
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(pairs: LabelPairs, extra: str = '') -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return '{' + ','.join(parts) + '}' if parts else ''


def _escape(v: str) -> str:
    return str(v).replace('\\', r'\\').replace('"', r'\"').replace('\n', r'\n')


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline but NOT double quotes —
    # the exposition format 0.0.4 rule differs from label values
    return str(v).replace('\\', r'\\').replace('\n', r'\n')


class Counter:
    """Monotonic float counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f'counters only go up; inc({n})')
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, name: str, pairs: LabelPairs) -> List[str]:
        return [f'{name}{_fmt_labels(pairs)} {_fmt_value(self.value)}']


class Gauge:
    """Set-to-current-value metric (queue depth, pool size, hit rate)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, name: str, pairs: LabelPairs) -> List[str]:
        return [f'{name}{_fmt_labels(pairs)} {_fmt_value(self.value)}']


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self.buckets: Tuple[float, ...] = tuple(sorted(set(buckets)))
        if not self.buckets:
            raise ValueError('histogram needs at least one bucket bound')
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +1 = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, []
        for bound, c in zip(self.buckets, counts):
            cum += c
            out.append((bound, cum))
        return {'buckets': out, 'count': total, 'sum': s}

    def _samples(self, name: str, pairs: LabelPairs) -> List[str]:
        snap = self.snapshot()
        lines = []
        for bound, cum in snap['buckets']:
            le = 'le="%s"' % _fmt_value(bound)
            lines.append(f'{name}_bucket{_fmt_labels(pairs, le)} {cum}')
        inf = 'le="+Inf"'
        lines.append(f'{name}_bucket{_fmt_labels(pairs, inf)} '
                     f'{snap["count"]}')
        lines.append(f'{name}_sum{_fmt_labels(pairs)} '
                     f'{_fmt_value(snap["sum"])}')
        lines.append(f'{name}_count{_fmt_labels(pairs)} {snap["count"]}')
        return lines


_TYPE_NAMES = {Counter: 'counter', Gauge: 'gauge', Histogram: 'histogram'}


class MetricsRegistry:
    """Named families of (labels → metric) with Prometheus rendering."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name → {'type', 'help', 'series': {label_pairs: metric}}
        self._families: 'Dict[str, Dict[str, Any]]' = {}

    def _get(self, cls, name: str, help: str,
             labels: Optional[Dict[str, str]], **kwargs):
        pairs = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    'type': _TYPE_NAMES[cls], 'help': help, 'series': {}}
            elif fam['type'] != _TYPE_NAMES[cls]:
                raise ValueError(
                    f'metric {name!r} already registered as {fam["type"]}')
            metric = fam['series'].get(pairs)
            if metric is None:
                metric = fam['series'][pairs] = cls(**kwargs)
            if help and not fam['help']:
                fam['help'] = help
            return metric

    def counter(self, name: str, help: str = '',
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = '',
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = '',
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def collect(self) -> Dict[str, Any]:
        """JSON-able snapshot: name → [{labels, value | histogram}]."""
        with self._lock:
            families = {name: (fam['type'],
                               list(fam['series'].items()))
                        for name, fam in self._families.items()}
        out: Dict[str, Any] = {}
        for name, (mtype, series) in families.items():
            rows = []
            for pairs, metric in series:
                row: Dict[str, Any] = {'labels': dict(pairs)}
                if mtype == 'histogram':
                    row.update(metric.snapshot())
                else:
                    row['value'] = metric.value
                rows.append(row)
            out[name] = {'type': mtype, 'series': rows}
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (trailing newline)."""
        with self._lock:
            families = [(name, fam['type'], fam['help'],
                         list(fam['series'].items()))
                        for name, fam in sorted(self._families.items())]
        lines: List[str] = []
        for name, mtype, help_text, series in families:
            lines.append(f'# HELP {name} '
                         f'{_escape_help(help_text or name.replace("_", " "))}')
            lines.append(f'# TYPE {name} {mtype}')
            for pairs, metric in series:
                lines.extend(metric._samples(name, pairs))
        return '\n'.join(lines) + '\n'


#: the process-wide registry
REGISTRY = MetricsRegistry()
