"""Declarative SLOs and multi-window burn-rate alerts over the metrics
registry (the port's copy of ``video_features_tpu/obs/slo.py``).

A serve daemon points it at its own request families
(``vft_serve_request_latency_seconds`` / ``vft_serve_requests_total``,
the defaults). Objectives are two knobs:

  * ``slo_latency_p99_s=T``: 99% of requests complete within T seconds.
    The error budget is the 1% of requests allowed over T; the burn rate
    is (observed fraction over T) / 0.01, read from the cumulative
    histogram buckets (the smallest bucket bound >= T stands in for T:
    conservative, and no samples need keeping).
  * ``slo_availability=A`` (e.g. 0.999): the failed-request fraction's
    budget is (1 - A); the burn rate is (failed / total) / (1 - A).

Each :meth:`SloEvaluator.tick` snapshots the cumulative counters, and
the burn rate over each window (5m and 1h by default) is the delta
between now and the sample closest to the window's start. An alert fires
only when every window burns above the threshold (14.4x by default: at
that rate a 30-day budget is gone in about 2 days). Ticks ride metrics
assembly (every scrape is a sample), so there is no thread.

Outputs, all derived on tick: ``vft_slo_*`` gauges on the same registry
(``..._burn_rate{window=}``, ``..._alert{slo=}``), a structured
``obs/events`` record on every alert transition, and the ``slo`` section
of the metrics document (:meth:`stats`).
"""
from __future__ import annotations

import logging
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from video_features_torch.obs.metrics import MetricsRegistry

# multi-window defaults: the short window drives fast firing/reset, the
# long window keeps one spike from paging
DEFAULT_WINDOWS_S = (300.0, 3600.0)

# burn-rate alert threshold (applies to EVERY window at once): 14.4x is
# the classic fast-burn page — a 30-day budget exhausted in ~2 days
DEFAULT_BURN_ALERT = 14.4

# the p99 objective's error budget: the fraction of requests allowed
# over the latency threshold
_LATENCY_BUDGET = 0.01


def disabled_stats() -> Dict[str, Any]:
    """The stable shape the metrics document carries when no objective
    is configured — scrapers see one schema either way (same policy as
    the ``watchdog`` / ``index`` sections)."""
    return {'enabled': False, 'objectives': {}, 'burn_rates': {},
            'alerts': {}, 'alerts_firing': 0, 'alerts_total': 0}


def window_label(seconds: float) -> str:
    """``300 -> '5m'``, ``3600 -> '1h'`` — the ``window=`` label value
    (dashboards key on these, so they must be stable and human)."""
    s = int(seconds)
    if s % 3600 == 0:
        return f'{s // 3600}h'
    if s % 60 == 0:
        return f'{s // 60}m'
    return f'{s}s'


class SloEvaluator:
    """Burn-rate evaluation of declarative objectives over one registry.

    Reads the cumulative latency histogram and outcome counters the
    serving path already maintains (no second set of probes to drift);
    every :meth:`tick` appends a timestamped snapshot, prunes history
    past the longest window, and re-derives per-window burn rates and
    alert states. Thread-safe; ``clock`` is injectable so tests can
    walk time instead of sleeping through a 5-minute window.
    """

    def __init__(self, registry: MetricsRegistry,
                 latency_p99_s: Optional[float] = None,
                 availability: Optional[float] = None,
                 latency_family: str = 'vft_serve_request_latency_seconds',
                 outcome_family: str = 'vft_serve_requests_total',
                 windows_s: Tuple[float, ...] = DEFAULT_WINDOWS_S,
                 burn_alert: float = DEFAULT_BURN_ALERT,
                 clock=time.monotonic) -> None:
        if latency_p99_s is None and availability is None:
            raise ValueError('an SloEvaluator needs at least one '
                             'objective (slo_latency_p99_s= and/or '
                             'slo_availability=)')
        if latency_p99_s is not None and float(latency_p99_s) <= 0:
            raise ValueError(f'slo_latency_p99_s must be > 0; '
                             f'got {latency_p99_s}')
        if availability is not None \
                and not (0 < float(availability) < 1):
            raise ValueError(f'slo_availability must be in (0, 1), e.g. '
                             f'0.999; got {availability}')
        self.registry = registry
        self.latency_p99_s = (None if latency_p99_s is None
                              else float(latency_p99_s))
        self.availability = (None if availability is None
                             else float(availability))
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.burn_alert = float(burn_alert)
        self._clock = clock
        self._lock = threading.Lock()
        # the families this evaluator derives from — registering here
        # returns the SAME series the serving path writes (re-register
        # semantics), or a zero series it grows into on a fresh router
        self._hist = registry.histogram(latency_family)
        self._completed = registry.counter(
            outcome_family, labels={'outcome': 'completed'})
        self._failed = registry.counter(
            outcome_family, labels={'outcome': 'failed'})
        # (t, requests_total, over_threshold, completed, failed) —
        # pruned to the longest window (plus one baseline sample at or
        # before the window start, so deltas span the full window)
        self._samples: 'deque[Tuple[float, int, int, float, float]]' \
            = deque()
        self._alerting: Dict[str, bool] = {}
        if self.latency_p99_s is not None:
            self._alerting['latency_p99'] = False
        if self.availability is not None:
            self._alerting['availability'] = False
        self._alerts_total = registry.counter(
            'vft_slo_alerts_total',
            'burn-rate alert FIRING transitions since start')
        # objective values as gauges: the alert rule's parameters travel
        # with the data they gate
        if self.latency_p99_s is not None:
            registry.gauge(
                'vft_slo_latency_threshold_seconds',
                'the slo_latency_p99_s objective').set(self.latency_p99_s)
        if self.availability is not None:
            registry.gauge(
                'vft_slo_availability_target',
                'the slo_availability objective').set(self.availability)

    # -- sampling ------------------------------------------------------------

    def _over_threshold(self) -> Tuple[int, int]:
        """(requests over the latency threshold, total observed) from
        the cumulative buckets: total minus the cumulative count at the
        smallest bound >= the threshold (conservative — a request in
        the straddling bucket counts as over)."""
        snap = self._hist.snapshot()
        total = snap['count']
        if self.latency_p99_s is None or not snap['buckets']:
            return 0, total
        bounds = [b for b, _ in snap['buckets']]
        i = bisect_left(bounds, self.latency_p99_s)
        within = snap['buckets'][i][1] if i < len(bounds) else \
            snap['buckets'][-1][1]
        if i >= len(bounds):
            # threshold beyond the last bound: only +Inf-bucket samples
            # are provably over, and those are total - last cumulative
            within = snap['buckets'][-1][1]
        return max(0, total - within), total

    def tick(self) -> Dict[str, Any]:
        """Take one snapshot, re-derive burn rates/alerts, update the
        ``vft_slo_*`` gauges, and return the ``slo`` document section."""
        now = self._clock()
        over, total = self._over_threshold()
        completed, failed = self._completed.value, self._failed.value
        with self._lock:
            self._samples.append((now, total, over, completed, failed))
            horizon = now - self.windows_s[-1]
            # keep ONE sample at or before the horizon as the baseline
            while len(self._samples) > 1 and self._samples[1][0] <= horizon:
                self._samples.popleft()
            burn_latency: Dict[str, float] = {}
            burn_avail: Dict[str, float] = {}
            for w in self.windows_s:
                base = self._baseline_locked(now - w)
                d_total = total - base[1]
                d_over = over - base[2]
                d_req = (completed - base[3]) + (failed - base[4])
                d_failed = failed - base[4]
                label = window_label(w)
                if self.latency_p99_s is not None:
                    frac = (d_over / d_total) if d_total > 0 else 0.0
                    burn_latency[label] = frac / _LATENCY_BUDGET
                if self.availability is not None:
                    budget = 1.0 - self.availability
                    frac = (d_failed / d_req) if d_req > 0 else 0.0
                    burn_avail[label] = frac / budget
            transitions = self._update_alerts_locked(
                burn_latency, burn_avail)
            alerts = dict(self._alerting)
        # gauges + events OUTSIDE the lock: registry/event sinks take
        # their own locks
        for label, burn in burn_latency.items():
            self.registry.gauge(
                'vft_slo_latency_burn_rate',
                'latency error-budget burn rate per window '
                '(1.0 = exactly on budget)',
                labels={'window': label}).set(burn)
        for label, burn in burn_avail.items():
            self.registry.gauge(
                'vft_slo_availability_burn_rate',
                'availability error-budget burn rate per window',
                labels={'window': label}).set(burn)
        for slo, firing in alerts.items():
            self.registry.gauge(
                'vft_slo_alert',
                '1 while the multi-window burn-rate alert fires',
                labels={'slo': slo}).set(1 if firing else 0)
        for slo, firing, burns in transitions:
            if firing:
                self._alerts_total.inc()
            from video_features_torch.obs.events import event
            event(logging.WARNING if firing else logging.INFO,
                  f'SLO {slo} burn-rate alert '
                  f'{"FIRING" if firing else "resolved"}',
                  subsystem='slo', slo=slo,
                  burn_rates={k: round(v, 3) for k, v in burns.items()},
                  threshold=self.burn_alert)
        return {
            'enabled': True,
            'objectives': {'latency_p99_s': self.latency_p99_s,
                           'availability': self.availability},
            'windows_s': list(self.windows_s),
            'burn_alert_threshold': self.burn_alert,
            'burn_rates': {
                **({'latency': burn_latency} if burn_latency else {}),
                **({'availability': burn_avail} if burn_avail else {}),
            },
            'alerts': alerts,
            'alerts_firing': sum(1 for f in alerts.values() if f),
            'alerts_total': int(self._alerts_total.value),
        }

    # stats() is the metrics-document spelling: every assembly is a tick,
    # so scraping IS sampling and no background thread is needed
    stats = tick

    # -- internals -----------------------------------------------------------

    def _baseline_locked(self, t_start: float
                         ) -> Tuple[float, int, int, float, float]:
        """The latest sample at or before ``t_start`` (the window
        start), else the oldest held — a young process reports burn
        over the history it actually has rather than zero."""
        base = self._samples[0]
        for s in self._samples:
            if s[0] <= t_start:
                base = s
            else:
                break
        return base

    def _update_alerts_locked(self, burn_latency: Dict[str, float],
                              burn_avail: Dict[str, float]
                              ) -> List[Tuple[str, bool, Dict[str, float]]]:
        """Multi-window AND: fire only when EVERY window burns over the
        threshold. Returns the transitions to report (outside the
        lock)."""
        transitions: List[Tuple[str, bool, Dict[str, float]]] = []
        for slo, burns in (('latency_p99', burn_latency),
                           ('availability', burn_avail)):
            if slo not in self._alerting:
                continue
            firing = bool(burns) and all(b > self.burn_alert
                                         for b in burns.values())
            if firing != self._alerting[slo]:
                self._alerting[slo] = firing
                transitions.append((slo, firing, dict(burns)))
        return transitions
