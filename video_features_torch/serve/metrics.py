"""Live metrics for the extraction service: a view over one registry
(the port's copy of ``video_features_tpu/serve/metrics.py``, with the same
document keys and Prometheus family names).

Two renderings of the same state:

  * the JSON document, assembled on demand from sources that are each
    thread-safe: the warm pool's counters, the admission gate's depth,
    per-request latency samples, and every pool entry's
    ``utils.tracing.Tracer`` report (stage times, batch occupancy);
  * Prometheus text exposition (:func:`prometheus_text`): the same
    values as ``vft_*`` families, counters and the latency histogram
    straight off the registry, point-in-time document values mirrored
    into gauges, for the ``metrics_prom`` command and the ``<path>.prom``
    file mirror.

Both are on the socket and, with ``serve_metrics_path``, in atomically
rewritten files. The ``aot`` section merges the executable stores'
counters (``aot.store.merge_exec_stats``) with the kernel libraries'
paths, and renders as the ``vft_aot_*`` gauges.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from video_features_torch.obs.metrics import MetricsRegistry
from video_features_torch.utils.tracing import merge_reports

# bounded latency window: p50/p99 over the most recent completions, not
# an unbounded all-time list (a week-long server would otherwise grow
# without bound and average away regressions). The Prometheus histogram
# alongside is cumulative-since-start by design — rate() windows it.
LATENCY_WINDOW = 1024

# counter key → (Prometheus family, labels): request-level outcomes and
# video-level outcomes are separate families
# thread-discipline declaration (vft-lint): write-once constant — every
# RequestStats reads it, nothing mutates it after import
_LOCKED_BY = {'_COUNTER_SERIES': 'immutable'}
_COUNTER_SERIES = {
    'submitted': ('vft_serve_requests_total', {'outcome': 'submitted'}),
    'completed': ('vft_serve_requests_total', {'outcome': 'completed'}),
    'failed': ('vft_serve_requests_total', {'outcome': 'failed'}),
    'rejected': ('vft_serve_requests_total', {'outcome': 'rejected'}),
    'expired_videos': ('vft_serve_videos_total', {'outcome': 'expired'}),
    'cached_videos': ('vft_serve_videos_total', {'outcome': 'cached'}),
}


class RequestStats:
    """Thread-safe request counters + completion-latency window, backed
    by an ``obs.metrics`` registry (one per server instance, so several
    servers in one process never bleed counts into each other)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._counters = {
            key: self.registry.counter(
                family, 'request/video outcomes by type', labels=labels)
            for key, (family, labels) in _COUNTER_SERIES.items()}
        self._latency_hist = self.registry.histogram(
            'vft_serve_request_latency_seconds',
            'request completion latency (admission to terminal state)')
        self._latencies: List[float] = []

    def bump(self, key: str, n: int = 1) -> None:
        self._counters[key].inc(n)

    def observe_latency(self, seconds: float) -> None:
        self._latency_hist.observe(float(seconds))
        with self._lock:
            self._latencies.append(float(seconds))
            if len(self._latencies) > LATENCY_WINDOW:
                del self._latencies[:-LATENCY_WINDOW]

    def snapshot(self) -> Dict[str, Any]:
        counts = {key: int(c.value) for key, c in self._counters.items()}
        with self._lock:
            lat = list(self._latencies)
        out: Dict[str, Any] = {'requests': counts}
        if lat:
            out['latency'] = {
                'count': len(lat),
                'p50_s': round(float(np.percentile(lat, 50)), 4),
                'p99_s': round(float(np.percentile(lat, 99)), 4),
                'max_s': round(max(lat), 4),
            }
        else:
            out['latency'] = {'count': 0, 'p50_s': None, 'p99_s': None,
                              'max_s': None}
        return out


def build_metrics(started_at: float,
                  queue_depth: int,
                  queue_capacity: int,
                  draining: bool,
                  pool_stats: Dict[str, Any],
                  request_stats: RequestStats,
                  stage_reports: Dict[str, Dict],
                  cache_stats: Optional[Dict[str, Any]] = None,
                  inflight_batches: int = 0,
                  farm_stats: Optional[Dict[str, Any]] = None,
                  ingress_stats: Optional[Dict[str, Any]] = None,
                  trace_stats: Optional[Dict[str, Any]] = None,
                  watchdog_stats: Optional[Dict[str, Any]] = None,
                  aot_stats: Optional[Dict[str, Any]] = None,
                  index_stats: Optional[Dict[str, Any]] = None,
                  slo_stats: Optional[Dict[str, Any]] = None,
                  ) -> Dict[str, Any]:
    """Assemble the one metrics document. ``stage_reports`` maps a
    human-readable pool-entry label → that entry's ``Tracer.report()``;
    the aggregate view merges them (``tracing.merge_reports``).
    ``cache_stats`` is the merged content-addressed feature-cache view
    (``cache.store.merge_cache_stats`` over every cache dir requests have
    named) — always present in the document so scrapers see hit/miss/
    bytes-saved counters next to the warm-pool hit rate even before the
    first cache-enabled request. ``farm_stats`` is the merged decode-farm
    view (``farm.merge_farm_stats`` over every warm worker's farm) —
    likewise always present (all-zero before the first farm-backed
    request)."""
    doc: Dict[str, Any] = {
        'uptime_s': round(time.monotonic() - started_at, 3),
        'queue': {'depth': queue_depth, 'capacity': queue_capacity,
                  'draining': draining},
        'warm_pool': pool_stats,
        # async device loop: dispatched-but-unmaterialized device batches
        # across every warm worker (0 when idle or fully synchronous)
        'inflight_batches': int(inflight_batches),
    }
    if cache_stats is None:
        from video_features_torch.cache.store import merge_cache_stats
        cache_stats = merge_cache_stats(())
    doc['cache'] = cache_stats
    if farm_stats is None:
        from video_features_torch.farm.farm import merge_farm_stats
        farm_stats = merge_farm_stats(())
    doc['farm'] = farm_stats
    # the executable store (aot/): the merged counters of every store the
    # live workers were built against, and how many kernel libraries took
    # each path (loaded from the store or compiled); always present,
    # all-zero without aot_enabled, so scrapers see one schema;
    # builds_compiled == 0 with programs_loaded > 0 is a compile-free boot
    if aot_stats is None:
        from video_features_torch.aot.store import merge_exec_stats
        aot_stats = merge_exec_stats(())
        aot_stats['programs_loaded'] = 0
        aot_stats['programs_compiled'] = 0
    doc['aot'] = aot_stats
    # the network front door's view: per-tenant request/shed counters,
    # live-session + connection gauges (ingress/gateway.stats()) —
    # always present, {'enabled': False} on a loopback-only server, so
    # scrapers see one stable schema
    # feature-index view (index/): rows/shards/ingest-lag from the
    # serve-side ingest worker plus query counters — always present,
    # {'enabled': False} without index_enabled, so scrapers see one
    # stable schema; ingest_lag_bytes == 0 means the index has folded
    # in every published cache object
    doc['index'] = (index_stats if index_stats is not None
                    else {'enabled': False, 'rows_live': 0, 'rows_dead': 0,
                          'shards': 0, 'rows_indexed': 0, 'rows_dropped': 0,
                          'ingest_lag_bytes': 0, 'queries': 0})
    doc['ingress'] = (ingress_stats if ingress_stats is not None
                      else {'enabled': False, 'requests_total': 0,
                            'shed_total': 0, 'live_sessions': 0,
                            'open_connections': 0, 'tenants': {}})
    # structured-event accounting (obs/events): lifetime counts per
    # (level, subsystem) — the vft_events_total mirror's source; always
    # present so scrapers see a stable schema
    from video_features_torch.obs.events import event_counts
    counts = {f'{level}/{subsystem}': n
              for (level, subsystem), n in sorted(event_counts().items())}
    doc['events'] = {'total': sum(counts.values()), 'counts': counts}
    # span-ring view (vft-flight): live recorders + events lost to ring
    # wrap — today only visible in the Chrome-trace footer, invisible
    # to scrapers without this
    doc['trace'] = (trace_stats if trace_stats is not None
                    else {'recorders': 0, 'events_dropped': 0})
    # stall watchdog (obs/watchdog): the progress-ledger view, or the
    # stable disabled shape on servers without watchdog_stall_s
    doc['watchdog'] = (watchdog_stats if watchdog_stats is not None
                       else {'enabled': False, 'stalls_total': 0,
                             'workers': {}})
    # SLO burn rates (obs/slo): objectives + per-window burn + alert
    # states, or the stable disabled shape without slo_* knobs
    if slo_stats is not None:
        doc['slo'] = slo_stats
    else:
        from video_features_torch.obs.slo import disabled_stats
        doc['slo'] = disabled_stats()
    doc.update(request_stats.snapshot())
    doc['stages'] = {label: rep for label, rep in stage_reports.items()}
    doc['stages_merged'] = merge_reports(stage_reports.values())
    return doc


def prometheus_text(doc: Dict[str, Any],
                    registry: MetricsRegistry) -> str:
    """Render the metrics state as Prometheus text exposition 0.0.4.

    Counters and the latency histogram come straight off ``registry``
    (``RequestStats`` writes them); the document's point-in-time values
    — queue depth, warm-pool and cache counters, the merged stage table
    — mirror into gauges on the same registry first, so one ``render``
    emits the whole surface."""
    g = registry.gauge
    g('vft_serve_uptime_seconds',
      'seconds since server start').set(doc.get('uptime_s', 0.0))
    q = doc.get('queue') or {}
    g('vft_serve_queue_depth',
      'videos queued or in flight').set(q.get('depth', 0))
    g('vft_serve_queue_capacity',
      'admission bound (serve_queue_depth)').set(q.get('capacity', 0))
    g('vft_serve_draining',
      '1 while draining, else 0').set(1 if q.get('draining') else 0)
    g('vft_inflight_batches',
      'device batches dispatched but not yet materialized (async '
      'device loop)').set(doc.get('inflight_batches', 0))
    for key, value in (doc.get('warm_pool') or {}).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            g(f'vft_warm_pool_{key}',
              'warm extractor pool accounting').set(value)
    for dev, count in (doc.get('warm_pool') or {}
                       ).get('device_residents', {}).items():
        # placement-aware pool: how many warm entries each device carries
        g('vft_device_resident_entries',
          'warm-pool entries resident per device',
          labels={'device': dev}).set(count)
    for dev, nbytes in (doc.get('warm_pool') or {}
                        ).get('device_resident_bytes', {}).items():
        # real per-device residency: a bf16 fast-lane entry counts its
        # actual ~half-size params footprint, not '1 entry'
        g('vft_device_resident_bytes',
          'warm-pool params bytes resident per device',
          labels={'device': dev}).set(nbytes)
    for key, value in (doc.get('cache') or {}).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            g(f'vft_cache_{key}',
              'content-addressed feature cache accounting').set(value)
    for key, value in (doc.get('farm') or {}).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            g(f'vft_farm_{key}',
              'decode farm accounting (merged across warm workers)'
              ).set(value)
    for key, value in (doc.get('aot') or {}).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            # vft_aot_programs_loaded vs vft_aot_programs_compiled is the
            # compile-free boot's dashboard pair
            g(f'vft_aot_{key}',
              'persistent executable store accounting (merged across '
              'warm workers)').set(value)
    for key, value in (doc.get('index') or {}).items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            # point-in-time mirrors; the registered vft_index_*_total
            # counters and latency histogram render off the registry
            # directly (IndexService registers them at construction)
            g(f'vft_index_{key}',
              'sharded feature-index accounting (ingest worker + '
              'query engine)').set(value)
    # monotonic mirrors (counter semantics, hence _total names): the
    # document carries lifetime totals; the registry counter advances by
    # the delta so repeated renders never double-count and a recorder
    # aging out of the bounded deque (sum dips) never decrements
    def _mirror_counter(name: str, help_text: str, total: float,
                        labels: Optional[Dict[str, str]] = None) -> None:
        c = registry.counter(name, help_text, labels=labels)
        delta = float(total) - c.value
        if delta > 0:
            c.inc(delta)

    for key, n in ((doc.get('events') or {}).get('counts') or {}).items():
        level, _, subsystem = key.partition('/')
        _mirror_counter('vft_events_total',
                        'structured events by level and subsystem '
                        '(obs/events)', n,
                        labels={'level': level,
                                'subsystem': subsystem or 'core'})
    _mirror_counter('vft_trace_events_dropped_total',
                    'span-ring events lost to ring-buffer wrap across '
                    'the live recorders', (doc.get('trace') or {}
                                           ).get('events_dropped', 0))
    wd = doc.get('watchdog') or {}
    g('vft_watchdog_enabled',
      '1 when the stall watchdog is armed, else 0').set(
          1 if wd.get('enabled') else 0)
    for stage, rep in (doc.get('stages_merged') or {}).items():
        # gauge family names deliberately avoid the _total suffix
        # (reserved for counter semantics): these mirror a point-in-time
        # document, and tracer resets mean they are not monotonic
        labels = {'stage': stage}
        g('vft_stage_seconds', 'merged stage wall time',
          labels=labels).set(rep.get('total_s', 0.0))
        g('vft_stage_calls', 'merged stage call count',
          labels=labels).set(rep.get('count', 0))
        if rep.get('occupancy') is not None:
            g('vft_stage_occupancy',
              'valid batch slots / all slots for the stage',
              labels=labels).set(rep['occupancy'])
        for dev, drec in (rep.get('occ_device') or {}).items():
            # mesh-sharded batches: the same family grows a device
            # label, one series per device (aggregate stays label-free)
            g('vft_stage_occupancy',
              'valid batch slots / all slots for the stage',
              labels={'stage': stage, 'device': dev}
              ).set(drec.get('occupancy', 0.0))
    return registry.render()


def write_metrics_file(path: Optional[str], doc: Dict[str, Any],
                       prom_text: Optional[str] = None) -> None:
    """Atomically mirror the metrics document to ``path`` (no-op if
    unset) and — when given — the Prometheus rendering to
    ``<path>.prom`` (node_exporter textfile-collector friendly).
    Failures are swallowed — metrics mirroring must never take down the
    serving loop."""
    if not path:
        return
    from video_features_torch.utils.output import atomic_write
    try:
        atomic_write(path, lambda f: f.write(
            json.dumps(doc, sort_keys=True).encode('utf-8')))
        if prom_text is not None:
            atomic_write(path + '.prom',
                         lambda f: f.write(prom_text.encode('utf-8')))
    except OSError:
        pass
