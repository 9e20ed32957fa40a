"""The warm-pool extraction daemon (the port's copy of
``video_features_tpu/serve/server.py``: the same config keys, wire,
output files, metric names and named errors).

``python -m video_features_torch serve [serve_*=.. base_override=..]``
keeps extractors resident in a :class:`serve.pool.WarmPool`, and
requests arriving over a loopback socket feed the packed loop
(``parallel/packing.py``): windows of concurrent requests fill shared
device batches, with the per-video fault isolation and scatter-back of
the packed loop, so one bad request never poisons a batch it shares.

  accept thread ── JSON lines (serve/protocol.py) ── per-connection handlers
        │ submit                                        │ status/metrics
        ▼                                               ▼
  admission (bounded queue depth, priorities, per-request deadline)
        │ pool hit → enqueue      │ pool miss → build the extractor
        ▼                         ▼
  one _Worker per warm-pool entry: a queue-fed task stream (with FLUSH
  on arrival lulls) into ``run_packed``, which returns only when the
  worker drains, so requests arriving while the card runs batch k pack
  into batch k+1.

Graceful drain (SIGTERM, SIGINT or the ``drain`` command): admission
closes, every worker's feed ends after its queued videos, ``run_packed``
flushes its tail and finalizes every started video, the final metrics
file and the merged trace are written, then the process exits. No
completed output is lost; an interrupted video re-extracts on restart
through the resume contract.

Not ported, each refused by name with the JAX package's error shape:
``range`` on submit (segments come with ``ingress/``), live sessions
(:meth:`ExtractionServer.submit_live`, :meth:`~ExtractionServer.
attach_ingress`), ``search`` and ``index_status`` (no ``index/``). The
metrics document's ``aot`` section is ``{}`` (no executable store), and
``serve_prewarm`` warms an entry by one step on a zero batch
(``BaseExtractor.warm_window``) where the JAX package loads executables.
"""
from __future__ import annotations

import itertools
import logging
import os
import queue
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from video_features_torch.config import (
    OBS_DEFAULTS, knob_exclude, load_config, split_serve_config,
)
from video_features_torch.obs.context import accept_traceparent
from video_features_torch.obs.events import event
from video_features_torch.parallel.packing import FLUSH, VideoTask
from video_features_torch.registry import PACKED_FEATURES, create_extractor
from video_features_torch.serve import metrics as metrics_mod
from video_features_torch.serve import protocol
from video_features_torch.serve.pool import DevicePlacer, WarmPool, device_id

_CLOSE = object()

# terminal requests kept for status(); older ones age out so a long-lived
# daemon's request table stays bounded
REQUEST_HISTORY = 4096

# events read per recorder by the trace command: the recent window of
# each ring, never all of it under the recorder's lock
TRACE_ROUTE_SPAN_LIMIT = 50_000

# keys that change neither the program, the weights nor how a worker
# runs stay out of the pool key (config.KNOB_CLASSIFICATION, the JAX
# package's table)
_KEY_EXCLUDE = knob_exclude('pool_key')

# what the port refuses by name, and why
NOT_PORTED = {
    'range': 'segment queries (submit range=[start_s, end_s]) come with '
             'ingress/, which the port does not have yet (its VideoTask has '
             'no segment); submit without range',
    'live': 'live sessions come with ingress/, which the port does not '
            'have yet',
    'search': 'the search command needs the feature index, index/, which '
              'the port does not have yet',
    'index_status': 'the index_status command needs the feature index, '
                    'index/, which the port does not have yet',
}


def pool_key(args: Dict[str, Any]) -> tuple:
    """The identity of a sanity-checked request config."""
    return tuple(sorted((k, repr(v)) for k, v in args.items()
                        if k not in _KEY_EXCLUDE))


def resolve_mesh_devices(args: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``mesh_devices=0`` (every local device) to the count, in
    place, before :func:`pool_key`: 0 and the same explicit width must
    share one warm entry."""
    n = args.get('mesh_devices', 1)
    if n is not None and int(n) == 0:
        from video_features_torch.utils.device import local_devices
        args['mesh_devices'] = len(local_devices(args.get('device', 'cuda')))
    return args


class _ServeTask(VideoTask):
    """A packed-loop task carrying its request; each gets its own child
    span under the request's trace."""

    __slots__ = ('request',)

    def __init__(self, path: str, request: 'Request', out_root: str) -> None:
        super().__init__(path, out_root=out_root,
                         trace=(request.trace.child()
                                if request.trace is not None else None))
        self.request = request


class Request:
    """Admission-to-completion state of one submit."""

    def __init__(self, request_id: str, feature_type: str, paths: List[str],
                 deadline: Optional[float],
                 priority: str = 'interactive',
                 trace=None) -> None:
        self.id = request_id
        self.feature_type = feature_type
        self.videos: Dict[str, str] = {p: 'pending' for p in paths}
        self.pending = len(paths)
        self.deadline = deadline          # monotonic; None: no deadline
        self.priority = priority
        # the request's trace context (obs/context.TraceContext), taken
        # from the caller's traceparent or minted at admission
        self.trace = trace
        self.t0 = time.monotonic()
        self.done_t: Optional[float] = None

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def state(self) -> str:
        if self.pending > 0:
            return 'running'
        states = set(self.videos.values())
        if states <= {'saved', 'skipped', 'cached'}:
            return 'done'
        if states & {'saved', 'skipped', 'cached'}:
            return 'partial'
        return 'failed'

    def snapshot(self) -> Dict[str, Any]:
        out = {'request_id': self.id, 'state': self.state(),
               'feature_type': self.feature_type,
               'videos': dict(self.videos)}
        if self.trace is not None:
            out['trace_id'] = self.trace.trace_id
        if self.priority != 'interactive':
            out['priority'] = self.priority
        if self.done_t is not None:
            out['latency_s'] = round(self.done_t - self.t0, 4)
        return out


class FusedRequest(Request):
    """The umbrella of one ``features=[...]`` submit: the caller holds one
    request id while a child request per family runs through the normal
    admission and workers (each family its own warm entry, cache,
    deadline and fault isolation). It is terminal when every child is;
    it takes no admission slot and counts no completion itself."""

    def __init__(self, request_id: str, features: List[str],
                 paths: List[str], priority: str = 'interactive',
                 trace=None) -> None:
        super().__init__(request_id, '+'.join(features), paths, None,
                         priority=priority, trace=trace)
        self.features = list(features)
        self.children: Dict[str, Request] = {}
        self.pending = 0        # completion is tracked by the children

    def state(self) -> str:
        if not self.children:
            return 'running'    # the fan-out is still going on
        states = {c.state() for c in self.children.values()}
        if 'running' in states or any(c.done_t is None
                                      for c in self.children.values()):
            return 'running'
        if states == {'done'}:
            return 'done'
        if states & {'done', 'partial'}:
            return 'partial'
        return 'failed'

    def snapshot(self) -> Dict[str, Any]:
        out = {'request_id': self.id, 'state': self.state(),
               'feature_type': self.feature_type,
               'features': list(self.features),
               'requests': {f: c.id for f, c in self.children.items()},
               'videos': {f: dict(c.videos)
                          for f, c in self.children.items()}}
        if self.trace is not None:
            out['trace_id'] = self.trace.trace_id
        if self.priority != 'interactive':
            out['priority'] = self.priority
        if self.done_t is not None:
            out['latency_s'] = round(self.done_t - self.t0, 4)
        return out


_WD_SEQ = itertools.count(1)


class _Worker:
    """One warm-pool entry: an extractor and the thread that drives one
    long-lived ``run_packed`` over a queue-fed task stream."""

    def __init__(self, server: 'ExtractionServer', key: tuple, label: str,
                 extractor, idle_flush_s: float,
                 max_batch_wait_s: float = 2.0) -> None:
        self.server = server
        self.key = key
        self.label = label
        # the watchdog's row: labels collide across entries of one family
        # (other overrides), so each worker gets a process-unique key
        self.wd_key = f'{label}#{next(_WD_SEQ)}'
        self.ex = extractor
        self.idle_flush_s = idle_flush_s
        self.max_batch_wait_s = max_batch_wait_s
        self.queue: 'queue.Queue' = queue.Queue()
        # the devices the placer gave this entry (None once released, so
        # retirement is idempotent)
        self.devices: Optional[List] = None
        self.outstanding: set = set()
        self._lock = threading.Lock()
        self.closed = False
        self.crashed = False
        self.thread = threading.Thread(
            target=self._run, name=f'serve-worker-{label}', daemon=True)

    def start(self) -> None:
        self.thread.start()

    def submit(self, tasks: List[_ServeTask]) -> None:
        with self._lock:
            self.outstanding.update(tasks)
        self.server._wd_pending(self)
        for t in tasks:
            self.queue.put(t)
        if self.crashed:
            # lost a race with a crash: fail what its sweep missed
            with self._lock:
                stranded = [t for t in tasks if t in self.outstanding]
                for t in stranded:
                    self.outstanding.discard(t)
            for t in stranded:
                t.failed = True
                self.server._video_done(t)

    def idle(self) -> bool:
        with self._lock:
            return not self.outstanding

    def close(self) -> None:
        """Stop accepting; the feed ends after everything already queued."""
        self.closed = True
        self.queue.put(_CLOSE)

    def _feed(self):
        """The blocking task stream ``run_packed`` consumes: queued tasks,
        skipping videos whose deadline passed, with ``FLUSH`` after each
        arrival burst (pooled windows never wait on future traffic) and
        at least every ``max_batch_wait_s`` between tasks."""
        dirty = False
        last_flush = time.monotonic()
        while True:
            was_idle = not dirty
            try:
                item = self.queue.get(
                    timeout=self.idle_flush_s if dirty else None)
            except queue.Empty:
                dirty = False
                last_flush = time.monotonic()
                yield FLUSH
                continue
            if item is _CLOSE:
                return
            task = item
            if task.request.expired():
                with self._lock:
                    self.outstanding.discard(task)
                # an all-expired backlog must read as pending 0, not a stall
                self.server._wd_pending(self)
                self.server._video_expired(task)
                continue
            if was_idle:
                # the idle wait ends inside the loop's next(): a FLUSH first
                # puts it on the queue_idle side, not this task's decode
                last_flush = time.monotonic()
                yield FLUSH
            elif time.monotonic() - last_flush >= self.max_batch_wait_s:
                last_flush = time.monotonic()
                yield FLUSH
            dirty = True
            yield task

    def _on_video_done(self, task) -> None:
        with self._lock:
            self.outstanding.discard(task)
        self.server._wd_pending(self)
        self.server._video_done(task)

    def _run(self) -> None:
        try:
            try:
                self.ex.extract_packed(self._feed(),
                                       on_video_done=self._on_video_done,
                                       max_pool_age_s=self.max_batch_wait_s)
            finally:
                # the entry's trace on drain or crash, unless the server
                # writes the merged trace to the same path
                shared = self.server.base_overrides.get('trace_out')
                self.ex.finish_obs(export_trace=(
                    shared is None or str(shared) != self.ex.trace_out))
        except Exception:
            # a loop-level crash (a bug, an out-of-memory, a CUDA error;
            # per-video faults are isolated by run_packed): fail what is
            # outstanding so no request hangs, and retire the entry so the
            # next submit builds a healthy one
            self.crashed = True
            event(logging.ERROR, 'serve worker crashed; failing its '
                  'outstanding videos and retiring the entry',
                  subsystem='serve', exc_info=True, label=self.label)
            with self._lock:
                stranded = list(self.outstanding)
                self.outstanding.clear()
            for task in stranded:
                task.failed = True
                self.server._video_done(task)
            self.server._retire_crashed(self)
            self.server._dump_blackbox('serve_worker_crash',
                                       label=self.label,
                                       stranded=len(stranded))


class ExtractionServer:
    """The resident extraction daemon and its loopback JSON-lines
    endpoint."""

    def __init__(self,
                 base_overrides: Optional[Dict[str, Any]] = None,
                 host: str = '127.0.0.1',
                 port: int = 0,
                 queue_depth: int = 64,
                 pool_size: int = 4,
                 idle_flush_s: float = 0.05,
                 max_batch_wait_s: float = 2.0,
                 default_timeout_s: Optional[float] = None,
                 metrics_path: Optional[str] = None,
                 batch_shed_fraction: float = 0.5) -> None:
        self.base_overrides = dict(base_overrides or {})
        self.host, self._port_req = host, port
        self.queue_depth = queue_depth
        self.idle_flush_s = idle_flush_s
        self.max_batch_wait_s = max_batch_wait_s
        self.default_timeout_s = default_timeout_s
        self.metrics_path = metrics_path
        # 'batch' requests see this fraction of the queue, so a saturated
        # queue sheds batch first and keeps room for interactive
        self.batch_shed_fraction = float(batch_shed_fraction)
        self._batch_capacity = max(
            1, int(queue_depth * self.batch_shed_fraction))

        self.pool = WarmPool(pool_size)
        self._placer = DevicePlacer()
        # one registry per server: counters and the latency histogram;
        # prometheus_text mirrors the document's values into gauges here
        from video_features_torch.obs.metrics import MetricsRegistry
        self.registry = MetricsRegistry()
        self.stats = metrics_mod.RequestStats(self.registry)
        # one mirror-and-render at a time, so two documents never mix
        self._prom_lock = threading.Lock()
        self._started_at = time.monotonic()
        # one coarse lock for admission and request state; the device
        # batches never take it
        self._lock = threading.RLock()
        self._requests: Dict[str, Request] = {}
        self._done_ids: 'deque[str]' = deque()   # completion order, bounded
        self._inflight_videos = 0
        self._next_id = 0
        # per-key build lock: N concurrent cold submits of one config
        # build once; the others adopt the winner's worker
        self._build_locks: Dict[tuple, threading.Lock] = {}
        # entries built (the JAX package's builds_compiled; its
        # builds_loaded, an entry whose executables all loaded from its
        # store, is 0 in the port)
        self._builds_compiled = 0
        self._caches: Dict[str, Any] = {}
        self._retired: List[_Worker] = []
        # one merged stage report of every retired or crashed entry
        self._retired_stages: Dict[str, Dict] = {}
        # worker span recorders for the merged drain export, bounded
        self._trace_recorders: 'deque' = deque(maxlen=32)
        # long-lived recorders (the server's own admission spans) stay
        # outside the churn deque
        self._persistent_recorders: List = []
        self._server_recorder = None
        if self.base_overrides.get('trace_out'):
            from video_features_torch.obs.spans import SpanRecorder
            self._server_recorder = SpanRecorder()
            self._persistent_recorders.append(self._server_recorder)
        # the black box (postmortem_dir) and the stall watchdog
        # (watchdog_stall_s): absent knobs change nothing
        self.blackbox = None
        if self.base_overrides.get('postmortem_dir'):
            from video_features_torch.obs.blackbox import BlackBox
            max_bytes = self.base_overrides.get('postmortem_max_bytes')
            self.blackbox = BlackBox(
                str(self.base_overrides['postmortem_dir']),
                max_bytes=(int(max_bytes) if max_bytes is not None
                           else OBS_DEFAULTS['postmortem_max_bytes']),
                recorders=self._all_recorders,
                metrics_fn=self._metrics_for_blackbox,
                prom_fn=lambda: self._prometheus(
                    self._metrics_for_blackbox()))
        self.watchdog = None
        if self.base_overrides.get('watchdog_stall_s'):
            from video_features_torch.obs.watchdog import StallWatchdog
            self.watchdog = StallWatchdog(
                float(self.base_overrides['watchdog_stall_s']),
                on_stall=self._on_stall,
                registry=self.registry).start()
        # SLO burn rates over this server's request families; each metrics
        # assembly is a tick, so no thread
        self.slo = None
        if self.base_overrides.get('slo_latency_p99_s') is not None \
                or self.base_overrides.get('slo_availability') is not None:
            from video_features_torch.obs.slo import SloEvaluator
            _lat = self.base_overrides.get('slo_latency_p99_s')
            _avail = self.base_overrides.get('slo_availability')
            self.slo = SloEvaluator(
                self.registry,
                latency_p99_s=(float(_lat) if _lat is not None else None),
                availability=(float(_avail) if _avail is not None
                              else None))
        self._draining = False
        self._drained = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._sock is not None, 'server not started'
        return self._sock.getsockname()[1]

    def start(self) -> 'ExtractionServer':
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._port_req))
        self._sock.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='serve-accept', daemon=True)
        self._accept_thread.start()
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT drain gracefully (the daemon's entry point
        only; a library caller drives :meth:`drain` itself)."""
        def _on_signal(signum, frame):
            print(f'serve: signal {signum} — draining', file=sys.stderr)
            self.drain(wait=False)
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def serve_forever(self) -> None:
        self._drained.wait()

    def drain(self, wait: bool = True, grace_s: float = 300.0) -> None:
        """Close admission, let every worker finish its queued videos
        (tail batches flush padded), write the final metrics file and the
        merged trace, then stop the endpoint. Idempotent; ``wait=False``
        returns at once and finishes on a thread (the signal path)."""
        with self._lock:
            already = self._draining
            self._draining = True
        if already:
            if wait:
                self._drained.wait(grace_s)
            return
        with self._lock:
            workers = self.pool.pop_all() + list(self._retired)
        for w in workers:
            w.close()

        def _finish():
            deadline = time.monotonic() + grace_s
            pending = workers
            while pending:
                for w in pending:
                    if w.thread.is_alive():
                        w.thread.join(max(0.0, deadline - time.monotonic()))
                    self._release_placement(w)
                # a cold submit racing the drain may have put a fresh
                # worker in after the first sweep
                with self._lock:
                    pending = self.pool.pop_all()
                for w in pending:
                    w.close()
                if time.monotonic() >= deadline:
                    break
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            if self.watchdog is not None:
                # before the final exports: a drained worker must not read
                # as a stall while the monitor races shutdown
                self.watchdog.stop()
            doc = self.metrics()
            metrics_mod.write_metrics_file(self.metrics_path, doc,
                                           prom_text=self._prometheus(doc))
            self._export_merged_trace()
            self._drained.set()

        if wait:
            _finish()
        else:
            threading.Thread(target=_finish, name='serve-drain',
                             daemon=True).start()

    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    def _prometheus(self, doc: Dict[str, Any]) -> str:
        """One mirror-the-gauges-and-render pass (see ``_prom_lock``)."""
        with self._prom_lock:
            return metrics_mod.prometheus_text(doc, self.registry)

    def _export_merged_trace(self) -> None:
        """Every recorder's spans as one Chrome trace at the base
        ``trace_out`` (on drain, after the workers joined, so it replaces
        each worker's own export there). Never raises."""
        path = self.base_overrides.get('trace_out')
        if not path:
            return
        recorders = self._all_recorders()
        if not recorders:
            return
        try:
            from video_features_torch.obs.spans import export_merged
            export_merged(recorders, str(path))
        except Exception:
            event(logging.WARNING, 'merged trace export failed',
                  subsystem='serve', exc_info=True, path=str(path))

    # -- the watchdog and the black box --------------------------------------

    def _all_recorders(self) -> List:
        with self._lock:
            return (list(self._persistent_recorders)
                    + list(self._trace_recorders))

    def _wd_pending(self, worker: '_Worker') -> None:
        """Mirror a worker's outstanding count into the watchdog's ledger,
        under the worker's lock so two publishes never land out of order
        (the watchdog's own lock is a leaf)."""
        if self.watchdog is None:
            return
        with worker._lock:
            self.watchdog.set_pending(worker.wd_key,
                                      len(worker.outstanding))

    def _wire_watchdog(self, worker: '_Worker') -> None:
        """Feed the watchdog's ledger from the worker's tracer, the same
        sites as the stage table and the timeline; decode farm workers get
        rows of their own (``label/farm-wN``) from the ``worker=`` span
        attribute and the farm's backlog feed."""
        if self.watchdog is None:
            return
        from video_features_torch.utils.tracing import NULL_TRACER, Tracer
        if worker.ex.tracer is NULL_TRACER or not worker.ex.tracer.enabled:
            # admission forces profile=true, so this is a guard: hooking
            # the shared NULL_TRACER would leak across extractors
            worker.ex.tracer = Tracer(enabled=True)
        wd, wd_key = self.watchdog, worker.wd_key

        def _progress(stage: str, farm_worker=None) -> None:
            wd.advance(wd_key, stage)
            if farm_worker is not None:
                wd.advance(f'{wd_key}/farm-w{farm_worker}', stage)

        worker.ex.tracer.progress = _progress
        worker.ex.watchdog_pending = (
            lambda widx, n: wd.set_pending(f'{wd_key}/farm-w{widx}', int(n)))

    def _wd_forget(self, worker: '_Worker') -> None:
        if self.watchdog is not None:
            self.watchdog.forget(worker.wd_key)
            self.watchdog.forget_prefix(worker.wd_key + '/')

    def _on_stall(self, info: Dict[str, Any]) -> None:
        """A watchdog trip (its event and counter already fired): the
        post-mortem bundle."""
        self._dump_blackbox('watchdog_stall', **info)

    def _dump_blackbox(self, reason: str, **extra: Any) -> None:
        """A post-mortem bundle (no-op without postmortem_dir; never
        raises; called by crash handlers and the watchdog's thread)."""
        if self.blackbox is None:
            return
        if self.watchdog is not None:
            extra.setdefault('watchdog', self.watchdog.snapshot())
        self.blackbox.dump(reason, **extra)

    def _metrics_for_blackbox(self) -> Dict[str, Any]:
        """The metrics document for a dump, after probing the admission
        lock: a dump often documents a wedge, and if that lock is what
        wedged, the bundle skips this section rather than hang."""
        if not self._lock.acquire(timeout=2.0):
            raise RuntimeError(
                'admission lock unavailable; skipping metrics section')
        self._lock.release()
        return self.metrics()

    def _record_admission(self, t0: float, req: Request,
                          **attrs: Any) -> None:
        """The ``admission`` span of a submit, under its trace (only with
        a base trace_out)."""
        rec = self._server_recorder
        if rec is None:
            return
        rec.span('admission', t0, time.perf_counter(),
                 request_id=req.id, feature_type=req.feature_type,
                 priority=req.priority,
                 **(req.trace.attrs() if req.trace is not None else {}),
                 **attrs)

    def request_trace(self, request_id: str) -> Dict[str, Any]:
        """One request's span timeline: every event of the live recorders
        that carries its trace id (``trace_id``, or ``trace_ids`` for a
        shared batch) or its ``request_id``, in time order."""
        with self._lock:
            req = self._requests.get(request_id)
        recorders = self._all_recorders()
        if req is None:
            return protocol.error(f'unknown request_id {request_id!r}',
                                  code=protocol.ERR_NOT_FOUND)
        ctx = req.trace
        trace_id = ctx.trace_id if ctx is not None else None
        events: List[Dict[str, Any]] = []
        if recorders and trace_id is not None:
            origin = min(r.origin() for r in recorders)
            for rec in recorders:
                for e in rec.snapshot(origin=origin,
                                      limit=TRACE_ROUTE_SPAN_LIMIT):
                    if e.get('ph') == 'M':
                        continue
                    args = e.get('args') or {}
                    if args.get('trace_id') == trace_id \
                            or trace_id in (args.get('trace_ids') or ()) \
                            or args.get('request_id') == request_id:
                        events.append(e)
            events.sort(key=lambda e: e['ts'])
        return protocol.ok(request_id=request_id, trace_id=trace_id,
                           state=req.state(), events=events)

    # -- admission -----------------------------------------------------------

    def _admission_capacity(self, priority: str) -> int:
        return (self._batch_capacity if priority == 'batch'
                else self.queue_depth)

    def _refuse(self, what: str) -> Dict[str, Any]:
        self.stats.bump('rejected')
        return protocol.error(f'{what} is not ported yet: {NOT_PORTED[what]}',
                              code=protocol.ERR_UNSUPPORTED)

    def submit(self, feature_type: str, video_paths: List[str],
               overrides: Optional[Dict[str, Any]] = None,
               timeout_s: Optional[float] = None,
               range_s=None,
               priority: str = 'interactive',
               traceparent: Optional[str] = None,
               features: Optional[List[str]] = None) -> Dict[str, Any]:
        if range_s is not None:
            return self._refuse('range')
        if features is not None:
            return self._submit_fused(
                features, video_paths, overrides=overrides,
                timeout_s=timeout_s, priority=priority,
                traceparent=traceparent)
        t0_admit = time.perf_counter()
        trace_ctx = accept_traceparent(traceparent)
        if not isinstance(video_paths, (list, tuple)) or not video_paths:
            self.stats.bump('rejected')
            return protocol.error('video_paths must be a non-empty list',
                                  code=protocol.ERR_INVALID)
        if priority is None:
            priority = 'interactive'
        if priority not in protocol.PRIORITIES:
            self.stats.bump('rejected')
            return protocol.error(
                f'unknown priority {priority!r}; known: '
                f'{", ".join(protocol.PRIORITIES)}',
                code=protocol.ERR_INVALID)
        paths = [str(p) for p in video_paths]
        if len(set(paths)) != len(paths):
            # Request.videos is keyed by path: a duplicate would never
            # complete
            self.stats.bump('rejected')
            return protocol.error('duplicate video_paths in one request',
                                  code=protocol.ERR_INVALID)
        if feature_type not in PACKED_FEATURES:
            self.stats.bump('rejected')
            return protocol.error(
                f'feature_type {feature_type!r} has no packed/serving '
                f'support; serveable: {", ".join(sorted(PACKED_FEATURES))}',
                code=protocol.ERR_UNSUPPORTED)
        # the YAML read and sanity_check run outside the admission lock
        try:
            args, key = self._resolve_entry_config(feature_type, paths,
                                                   overrides)
        except Exception as e:
            self.stats.bump('rejected')
            return protocol.error(f'invalid request: {e}',
                                  code=protocol.ERR_INVALID)

        # feature cache hits are answered before admission: a file copy
        # takes no queue slot and wakes no worker
        cache_hits: List[str] = []
        if args.get('cache_enabled') and not self._draining:
            cache_hits = self._answer_cache_hits(args, paths)
            if cache_hits:
                self.stats.bump('cached_videos', len(cache_hits))
        miss_paths = ([p for p in paths if p not in set(cache_hits)]
                      if cache_hits else paths)
        if not miss_paths:
            with self._lock:
                self._next_id += 1
                req = Request(f'r{self._next_id:06d}', feature_type, paths,
                              None, priority=priority, trace=trace_ctx)
                for p in paths:
                    req.videos[p] = 'cached'
                req.pending = 0
                self._requests[req.id] = req
                self._record_done_locked(req)
            self.stats.bump('submitted')
            self._record_admission(t0_admit, req, cached=len(paths))
            self._after_completion(req)
            return protocol.ok(request_id=req.id,
                               trace_id=trace_ctx.trace_id)

        with self._lock:
            if self._draining:
                self.stats.bump('rejected')
                return protocol.error('draining', code=protocol.ERR_SHED)
            capacity = self._admission_capacity(priority)
            if self._inflight_videos + len(miss_paths) > capacity:
                self.stats.bump('rejected')
                return protocol.error(
                    'queue_full', code=protocol.ERR_SHED,
                    depth=self._inflight_videos,
                    capacity=capacity, priority=priority)
            worker = self.pool.get(key)
            build_lock = self._build_locks.setdefault(
                key, threading.Lock())

        # a worker just acquired can be evicted (idle until enqueued)
        # before admission: re-acquire rather than enqueue behind _CLOSE
        for _ in range(5):
            if worker is None or worker.closed or worker.crashed:
                # the cold start the pool amortizes, outside the admission
                # lock, under the per-key build lock
                with build_lock:
                    existing = self.pool.peek(key)
                    if existing is not None and not (existing.closed
                                                     or existing.crashed):
                        worker = existing
                    else:
                        try:
                            worker = self._spawn_worker(args, key)
                        except Exception as e:
                            self.stats.bump('rejected')
                            return protocol.error(
                                f'extractor build failed: {e}',
                                code=protocol.ERR_INTERNAL)

            with self._lock:
                if self._draining:
                    worker.close()
                    self.stats.bump('rejected')
                    return protocol.error('draining',
                                          code=protocol.ERR_SHED)
                if self._inflight_videos + len(miss_paths) > \
                        self._admission_capacity(priority):
                    self.stats.bump('rejected')
                    return protocol.error(
                        'queue_full', code=protocol.ERR_SHED,
                        depth=self._inflight_videos,
                        capacity=self._admission_capacity(priority),
                        priority=priority)
                if worker.closed or worker.crashed:
                    worker = None
                    continue
                self._reap_retired_locked()

                if timeout_s is None:
                    timeout_s = self.default_timeout_s
                deadline = (time.monotonic() + float(timeout_s)
                            if timeout_s is not None else None)
                self._next_id += 1
                req = Request(f'r{self._next_id:06d}', feature_type, paths,
                              deadline, priority=priority, trace=trace_ctx)
                for p in cache_hits:
                    req.videos[p] = 'cached'
                    req.pending -= 1
                self._requests[req.id] = req
                self._inflight_videos += len(miss_paths)
                tasks = [_ServeTask(p, req, out_root=args['output_path'])
                         for p in miss_paths]
                # under the admission lock: eviction (pool.put) runs under
                # it too, so a worker cannot be closed before the enqueue
                worker.submit(tasks)
            self.stats.bump('submitted')
            self._record_admission(t0_admit, req, videos=len(miss_paths))
            return protocol.ok(request_id=req.id,
                               trace_id=trace_ctx.trace_id)
        self.stats.bump('rejected')
        return protocol.error('worker churn outpaced admission; retry',
                              code=protocol.ERR_SHED)

    def _submit_fused(self, features, video_paths,
                      overrides: Optional[Dict[str, Any]] = None,
                      timeout_s: Optional[float] = None,
                      priority: str = 'interactive',
                      traceparent: Optional[str] = None) -> Dict[str, Any]:
        """One ``features=[...]`` submit: every family's config is checked
        first (a fused request admits whole or not at all on config
        grounds), then one child submit per family under one trace."""
        from video_features_torch.config import (
            resolve_fused_features, split_fused_overrides,
        )
        try:
            fams = resolve_fused_features(features)
        except (TypeError, ValueError) as e:
            self.stats.bump('rejected')
            return protocol.error(f'invalid features: {e}',
                                  code=protocol.ERR_INVALID)
        bad = [f for f in fams if f not in PACKED_FEATURES]
        if bad:
            self.stats.bump('rejected')
            return protocol.error(
                f'features {bad} have no packed/serving support; '
                f'serveable: {", ".join(sorted(PACKED_FEATURES))}',
                code=protocol.ERR_UNSUPPORTED)
        if not isinstance(video_paths, (list, tuple)) or not video_paths:
            self.stats.bump('rejected')
            return protocol.error('video_paths must be a non-empty list',
                                  code=protocol.ERR_INVALID)
        paths = [str(p) for p in video_paths]
        trace_ctx = accept_traceparent(traceparent)
        # '<family>.<knob>' overrides go to their family, the rest to all
        shared, scoped = split_fused_overrides(overrides or {}, fams)
        fam_overrides: Dict[str, Dict[str, Any]] = {}
        for fam in fams:
            o = dict(shared)
            o.update(scoped.get(fam, {}))
            fam_overrides[fam] = o
            try:
                self._resolve_entry_config(fam, paths, o)
            except Exception as e:
                self.stats.bump('rejected')
                return protocol.error(f'invalid request for {fam!r}: {e}',
                                      code=protocol.ERR_INVALID)

        with self._lock:
            if self._draining:
                self.stats.bump('rejected')
                return protocol.error('draining', code=protocol.ERR_SHED)
            self._next_id += 1
            parent = FusedRequest(f'r{self._next_id:06d}', fams, paths,
                                  priority=priority, trace=trace_ctx)
            self._requests[parent.id] = parent

        children: Dict[str, Request] = {}
        errors: Dict[str, str] = {}
        for fam in fams:
            resp = self.submit(fam, paths,
                               overrides=fam_overrides[fam],
                               timeout_s=timeout_s,
                               priority=priority,
                               traceparent=trace_ctx.traceparent())
            if resp.get('ok'):
                with self._lock:
                    children[fam] = self._requests[resp['request_id']]
            else:
                # refused mid-fan-out (queue_full in a race): a terminal
                # failed child, so the umbrella still completes
                errors[fam] = str(resp.get('error'))
                child = Request(f'{parent.id}.{fam}', fam, paths, None,
                                priority=priority, trace=trace_ctx)
                for p in paths:
                    child.videos[p] = 'failed'
                child.pending = 0
                child.done_t = time.monotonic()
                children[fam] = child
        if not any(fam not in errors for fam in fams):
            with self._lock:
                self._requests.pop(parent.id, None)
            return protocol.error(
                'fused submit admitted no family: '
                + '; '.join(f'{f}: {e}' for f, e in errors.items()),
                code=protocol.ERR_INTERNAL)

        with self._lock:
            parent.children = children
            for child in children.values():
                child.fused_parent = parent
            # children terminal at birth (all cache hits) completed before
            # the parent hook was attached: close the umbrella here
            if parent.done_t is None and all(c.done_t is not None
                                             for c in children.values()):
                self._record_done_locked(parent)
        out: Dict[str, Any] = {'request_id': parent.id,
                               'trace_id': trace_ctx.trace_id,
                               'requests': {f: c.id
                                            for f, c in children.items()}}
        if errors:
            out['errors'] = errors
        return protocol.ok(**out)

    def submit_live(self, feature_type: str, session, **kwargs
                    ) -> Dict[str, Any]:
        """A live session (frames arriving over the network): refused by
        name, as the port has no ``ingress/``."""
        return self._refuse('live')

    def attach_ingress(self, ingress) -> None:
        raise NotImplementedError(
            'attach_ingress is not ported yet: the port has no network '
            'front door (ingress/)')

    def _resolve_entry_config(self, feature_type: str, paths: List[str],
                              overrides: Optional[Dict[str, Any]] = None,
                              ) -> tuple:
        """One entry's config and pool key: base overrides ← the call's
        overrides ← the worklist and ``profile`` ← ``load_config``. The
        submit path and the prewarm share it, so both derive one key for
        one entry."""
        merged = dict(self.base_overrides)
        merged.update(overrides or {})
        merged['video_paths'] = paths
        merged.pop('file_with_video_paths', None)
        merged['feature_type'] = feature_type
        merged['profile'] = True              # the tracer feeds metrics
        args = load_config(feature_type, overrides=merged)
        if args.get('manifest_out'):
            # a per-run artifact; a resident worker has no run end
            event(logging.WARNING,
                  'manifest_out is a per-run CLI knob; ignored by the '
                  'serve daemon (use metrics / metrics_prom / trace_out)',
                  subsystem='serve', path=str(args['manifest_out']))
            args['manifest_out'] = None
        return args, pool_key(resolve_mesh_devices(args))

    def _spawn_worker(self, args: Dict[str, Any], key: tuple) -> _Worker:
        """Build one warm-pool entry: load the weights, place it, wire the
        watchdog, start its worker and insert it. Shared by a cold submit
        and the prewarm; raises on a failed build. The caller holds the
        key's build lock."""
        label = args['feature_type'] + (
            f"/{args['model_name']}" if args.get('model_name') else '')
        extractor = create_extractor(args)
        worker = _Worker(self, key, label, extractor,
                         self.idle_flush_s, self.max_batch_wait_s)
        worker.devices = self._place_extractor(extractor)
        self._wire_watchdog(worker)
        worker.start()
        rec = getattr(extractor.tracer, 'recorder', None)
        with self._lock:
            self._builds_compiled += 1
            if rec is not None:
                self._trace_recorders.append(rec)
            self._retired.extend(self.pool.put(key, worker))
        return worker

    def prewarm(self, specs) -> Dict[str, Any]:
        """Build warm-pool entries at start-up (``serve_prewarm``), each
        ``'family[@lane]'`` spec resolved against the base overrides as a
        cold submit is, and step each once on a zero batch of its
        ``warm_window()`` (the JAX package loads executables instead). A
        spec that fails is a warning event; the family then builds on
        its first request."""
        report: Dict[str, Any] = {'entries': 0, 'programs_loaded': 0,
                                  'programs_compiled': 0, 'errors': []}
        specs = list(specs or ())
        if len(specs) > self.pool.capacity:
            event(logging.WARNING,
                  'serve_prewarm names more entries than the warm pool '
                  'holds; the earliest pre-warmed entries will be '
                  'evicted before the first request arrives',
                  subsystem='serve', specs=len(specs),
                  pool_size=self.pool.capacity)
        for spec in specs:
            family, _, lane = str(spec).partition('@')
            if family == 'index':
                report['errors'].append(f'{spec}: index_enabled is false')
                continue
            try:
                args, key = self._resolve_entry_config(
                    family, ['__prewarm__.live'],
                    {'compute_dtype': lane} if lane else None)
                with self._lock:
                    build_lock = self._build_locks.setdefault(
                        key, threading.Lock())
                with build_lock:
                    existing = self.pool.peek(key)
                    if existing is not None and not (existing.closed
                                                     or existing.crashed):
                        continue
                    worker = self._spawn_worker(args, key)
                report['programs_compiled'] += self._warm_step(worker.ex)
                report['entries'] += 1
            except Exception as e:
                event(logging.WARNING,
                      'serve pre-warm spec failed to build; the family '
                      'will cold-build on its first request',
                      subsystem='serve', exc_info=True, spec=str(spec))
                report['errors'].append(f'{spec}: {e}')
        if report['entries'] or report['errors']:
            event(logging.INFO, 'serve pre-warm complete',
                  subsystem='serve', **{k: v for k, v in report.items()
                                        if k != 'errors'},
                  failed=len(report['errors']))
        return report

    @staticmethod
    def _warm_step(ex) -> int:
        """One step of ``ex`` on a zero batch of its warm window; 1 if it
        ran, 0 for a family without one."""
        import numpy as np
        import torch
        window = ex.warm_window()
        if window is None:
            return 0
        batch = np.stack([window] * ex.packed_batch_size())
        with torch.inference_mode():
            ex.fetch_outputs(ex.dispatch(ex.put_input(batch)))
        return 1

    def _place_extractor(self, extractor) -> Optional[List]:
        """Give a fresh entry's extractor its device(s): the least loaded
        local devices of its kind, ``mesh_devices`` of them for a mesh
        entry. Never fails a build: a placement error leaves the
        extractor where it was built."""
        try:
            from video_features_torch.utils.device import local_devices
            local = local_devices(extractor.device)
            n = int(getattr(extractor, 'mesh_devices', 1) or 1)
            nbytes = extractor.params_nbytes()
            devices = self._placer.assign(local, n, nbytes=nbytes)
            try:
                extractor.place_on(devices)
            except Exception:
                self._placer.release(devices, nbytes=nbytes)
                raise
            # the exact bytes charged, for a release that nets to zero
            extractor._placement_nbytes = nbytes
            return devices
        except Exception:
            event(logging.WARNING, 'device placement failed; entry stays '
                  'on the default device', subsystem='serve',
                  exc_info=True)
            return None

    def _release_placement(self, worker: '_Worker') -> None:
        """Return a retired entry's devices and bytes to the placer
        (idempotent: a crash and a reap can race)."""
        devices, worker.devices = worker.devices, None
        if devices:
            self._placer.release(
                devices,
                nbytes=getattr(worker.ex, '_placement_nbytes', 0))

    def _answer_cache_hits(self, args: Dict[str, Any],
                           paths: List[str]) -> List[str]:
        """Copy every video the feature cache holds for this request's
        recipe into its output root; returns the hit paths. Never raises:
        a cache failure is a miss, and extraction reports what is wrong
        with the video."""
        from video_features_torch.cache import (
            FeatureCache, log_cache_error, run_fingerprint, video_cache_key,
        )
        hits: List[str] = []
        try:
            l2 = args.get('cache_l2_dir')
            if l2:
                from video_features_torch.fleet.tier import TieredFeatureCache
                cache = TieredFeatureCache.get_pair(
                    args.get('cache_dir'), l2, args.get('cache_max_bytes'))
            else:
                cache = FeatureCache.get(args.get('cache_dir'),
                                         args.get('cache_max_bytes'))
            with self._lock:
                self._caches[cache.cache_dir] = cache
            fp = run_fingerprint(args)
        except Exception:
            log_cache_error('serve-side open')
            return hits
        for p in paths:
            try:
                if cache.fetch_to(video_cache_key(p, fp), args['output_path'],
                                  p, fingerprint=fp):
                    hits.append(p)
            except Exception:
                log_cache_error(f'serve-side lookup for {p}')
        return hits

    def status(self, request_id: str) -> Dict[str, Any]:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                return protocol.error(f'unknown request_id {request_id!r}',
                                      code=protocol.ERR_NOT_FOUND)
            return protocol.ok(**req.snapshot())

    def _fold_retired_locked(self, report: Dict[str, Dict]) -> None:
        from video_features_torch.utils.tracing import merge_reports
        self._retired_stages = merge_reports([self._retired_stages, report])

    def _reap_retired_locked(self) -> None:
        """Drop evicted workers whose drain finished, folding their stage
        tables into the retired history, so their params stop holding
        device memory. The caller holds ``self._lock``."""
        for w in list(self._retired):
            if not w.thread.is_alive():
                self._fold_retired_locked(w.ex.tracer.report())
                self._retired.remove(w)
                self._release_placement(w)
                self._wd_forget(w)

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            self._reap_retired_locked()
            depth = self._inflight_videos
            draining = self._draining
            builds_compiled = self._builds_compiled
            reports = {}
            placements = {}
            workers = self.pool.entries() + self._retired
            for i, w in enumerate(workers):
                label = w.label if w.label not in reports \
                    else f'{w.label}#{i}'
                reports[label] = w.ex.tracer.report()
                if w.devices:
                    placements[label] = [f'd{device_id(d)}' for d in w.devices]
            if self._retired_stages:
                reports['retired'] = dict(self._retired_stages)
            caches = list(self._caches.values())
            inflight_batches = sum(
                int(getattr(w.ex, '_inflight_now', 0) or 0) for w in workers)
            farms = [w.ex._farm.stats() for w in workers
                     if getattr(w.ex, '_farm', None) is not None]
        pool_stats = self.pool.stats()
        pool_stats['builds_compiled'] = builds_compiled
        pool_stats['builds_loaded'] = 0
        pool_stats['placements'] = placements
        pool_stats['device_residents'] = self._placer.snapshot()
        pool_stats['device_resident_bytes'] = self._placer.snapshot_bytes()
        from video_features_torch.cache.store import merge_cache_stats
        from video_features_torch.farm.farm import merge_farm_stats
        recorders = self._all_recorders()
        trace_stats = {'recorders': len(recorders),
                       'events_dropped': sum(r.dropped for r in recorders)}
        return metrics_mod.build_metrics(
            self._started_at, depth, self.queue_depth, draining,
            pool_stats, self.stats, reports,
            cache_stats=merge_cache_stats(c.stats() for c in caches),
            inflight_batches=inflight_batches,
            farm_stats=merge_farm_stats(farms),
            trace_stats=trace_stats,
            watchdog_stats=(self.watchdog.snapshot()
                            if self.watchdog is not None else None),
            slo_stats=(self.slo.stats() if self.slo is not None else None))

    # -- completion (worker threads) -----------------------------------------

    def _record_done_locked(self, req: Request) -> None:
        """Stamp a terminal request and age out the oldest terminal ones
        (the caller holds ``self._lock``)."""
        req.done_t = time.monotonic()
        self._done_ids.append(req.id)
        while len(self._done_ids) > REQUEST_HISTORY:
            self._requests.pop(self._done_ids.popleft(), None)

    def _fused_child_done(self, parent: 'FusedRequest') -> None:
        """A fused child is terminal: close the umbrella after the last."""
        with self._lock:
            if parent.done_t is None and parent.children and all(
                    c.done_t is not None for c in parent.children.values()):
                self._record_done_locked(parent)

    def _after_completion(self, req: Request) -> None:
        self.stats.bump('completed')
        if req.state() in ('partial', 'failed'):
            self.stats.bump('failed')
        self.stats.observe_latency(req.done_t - req.t0)
        parent = getattr(req, 'fused_parent', None)
        if parent is not None:
            self._fused_child_done(parent)
        if self.metrics_path:
            doc = self.metrics()
            metrics_mod.write_metrics_file(self.metrics_path, doc,
                                           prom_text=self._prometheus(doc))

    def _finish_video(self, task, state: str) -> None:
        req = task.request
        with self._lock:
            if req.videos.get(task.path) == 'pending':
                req.videos[task.path] = state
                req.pending -= 1
                self._inflight_videos -= 1
            completed = req.pending == 0 and req.done_t is None
            if completed:
                self._record_done_locked(req)
        if completed:
            self._after_completion(req)

    def _video_done(self, task) -> None:
        # 'cached': missed at admission, published by another request
        # before this one reached its decode
        if getattr(task, 'cached', False):
            self.stats.bump('cached_videos')
            self._finish_video(task, 'cached')
            return
        state = ('skipped' if task.skipped
                 else 'failed' if task.failed else 'saved')
        self._finish_video(task, state)

    def _video_expired(self, task) -> None:
        self.stats.bump('expired_videos')
        self._finish_video(task, 'expired')

    def _retire_crashed(self, worker: _Worker) -> None:
        with self._lock:
            self.pool.remove(worker.key, worker)
            self._fold_retired_locked(worker.ex.tracer.report())
            self._release_placement(worker)
            self._wd_forget(worker)

    # -- the endpoint --------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                        # the socket closed: drained
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        with conn:
            rfile = conn.makefile('rb')
            wfile = conn.makefile('wb')
            for line in rfile:
                if not line.strip():
                    continue
                try:
                    msg = protocol.decode(line)
                    resp = self._dispatch(msg)
                except Exception as e:
                    resp = protocol.error(f'{type(e).__name__}: {e}',
                                          code=protocol.ERR_INTERNAL)
                try:
                    wfile.write(protocol.encode(resp))
                    wfile.flush()
                except (OSError, ValueError):
                    return                    # the client went away

    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        bad_version = protocol.check_version(msg)
        if bad_version is not None:
            return bad_version
        cmd = msg.get('cmd')
        if cmd == protocol.CMD_PING:
            return protocol.ok(draining=self._draining, v=protocol.VERSION)
        if cmd == protocol.CMD_SUBMIT:
            unknown = set(msg) - set(protocol.SUBMIT_FIELDS)
            if unknown:
                return protocol.error(
                    f'unknown submit fields: {sorted(unknown)}',
                    code=protocol.ERR_INVALID)
            return self.submit(msg.get('feature_type'),
                               msg.get('video_paths'),
                               overrides=msg.get('overrides'),
                               timeout_s=msg.get('timeout_s'),
                               range_s=msg.get('range'),
                               priority=msg.get('priority', 'interactive'),
                               traceparent=msg.get('traceparent'),
                               features=msg.get('features'))
        if cmd == protocol.CMD_STATUS:
            return self.status(msg.get('request_id'))
        if cmd == protocol.CMD_TRACE:
            return self.request_trace(msg.get('request_id'))
        if cmd == protocol.CMD_METRICS:
            return protocol.ok(metrics=self.metrics())
        if cmd == protocol.CMD_METRICS_PROM:
            return protocol.ok(text=self._prometheus(self.metrics()))
        if cmd in (protocol.CMD_SEARCH, protocol.CMD_INDEX_STATUS):
            return protocol.error(f'{cmd} is not ported yet: '
                                  f'{NOT_PORTED[cmd]}',
                                  code=protocol.ERR_UNSUPPORTED)
        if cmd == protocol.CMD_DRAIN:
            self.drain(wait=False)
            return protocol.ok(draining=True)
        return protocol.error(
            f'unknown cmd {cmd!r}; known: {", ".join(protocol.COMMANDS)}',
            code=protocol.ERR_INVALID)


def serve_main(argv: List[str]) -> int:
    """``python -m video_features_torch serve`` entry point."""
    from video_features_torch.config import parse_dotlist
    serve_cfg, base = split_serve_config(parse_dotlist(argv))
    server = ExtractionServer(
        base_overrides=base,
        host=serve_cfg['serve_host'],
        port=serve_cfg['serve_port'],
        queue_depth=serve_cfg['serve_queue_depth'],
        pool_size=serve_cfg['serve_warm_pool_size'],
        idle_flush_s=serve_cfg['serve_idle_flush_s'],
        max_batch_wait_s=serve_cfg['serve_max_batch_wait_s'],
        default_timeout_s=serve_cfg['serve_default_timeout_s'],
        metrics_path=serve_cfg['serve_metrics_path'],
        batch_shed_fraction=serve_cfg['serve_batch_shed_fraction'],
    ).start()
    server.install_signal_handlers()
    # entries are built before the endpoint line, which tooling reads as
    # readiness
    if serve_cfg.get('serve_prewarm'):
        server.prewarm(serve_cfg['serve_prewarm'])
    if server.blackbox is not None:
        from video_features_torch.obs.blackbox import install_signal_dump
        install_signal_dump(server.blackbox)
    # the endpoint line clients scrape host:port from
    print(f'serving on {server.host}:{server.port} '
          f'(pid {os.getpid()}; queue_depth='
          f'{serve_cfg["serve_queue_depth"]}, warm_pool='
          f'{serve_cfg["serve_warm_pool_size"]})', flush=True)
    server.serve_forever()
    print('serve: drained, exiting', flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    # every output is published by atomic writes and both streams are
    # flushed: skip the interpreter's teardown of the worker threads'
    # CUDA state and give supervisors a clean 0
    os._exit(0)
