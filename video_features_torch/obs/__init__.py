"""Flight recorder: spans, metrics, run manifest, structured event log and
black box (the port's copy of ``video_features_tpu/obs/``).

  * **Span timeline** (``obs.spans``): the ring buffer the
    :class:`~video_features_torch.utils.tracing.Tracer` feeds, exported
    as Chrome trace-event JSON by ``trace_out=``;
  * **Metrics registry** (``obs.metrics``): counters, gauges and
    histograms with Prometheus text;
  * **Run manifest** (``obs.manifest``, ``manifest_out=``): config,
    fingerprints, per-stage table, per-video outcomes, kernel builds;
  * **Structured event log** (``obs.events``): the warning and error
    channel, on stderr, so ``on_extraction=print`` keeps stdout clean;
  * **Black box** (``obs.blackbox``, ``postmortem_dir=``): a post-mortem
    bundle on a fatal signal or a decode worker's death;
  * **Stall watchdog** (``obs.watchdog``, ``watchdog_stall_s=``) and
    **SLO burn rates** (``obs.slo``, ``slo_*=``): the serve daemon's.

No module here imports torch at its top, so a decode farm worker that
imports one stays torch-free.
"""
from video_features_torch.obs.events import event, get_logger, log_extraction_error
from video_features_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
)
from video_features_torch.obs.spans import NULL_RECORDER, SpanRecorder

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry', 'REGISTRY',
    'NULL_RECORDER', 'SpanRecorder',
    'event', 'get_logger', 'log_extraction_error',
]
