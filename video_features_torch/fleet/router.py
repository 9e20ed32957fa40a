"""The fleet front door: consistent-hash routing over N serve daemons
(the port's copy of ``video_features_tpu/fleet/router.py``: the same
routing, failover, spans, metric families and endpoint lines). It
imports neither torch nor jax, so a router process never touches a card.

One router process speaks BOTH surfaces the single-host daemon does:

  * the loopback JSON-lines protocol (``serve/protocol.py``) — so a
    ``ServeClient`` pointed at the router is indistinguishable from one
    pointed at a daemon (submit/status/trace/search/metrics/ping), and
    the CLI/tests drive the fleet with zero new client code;
  * the ingress HTTP surface (``ingress/http.py`` transport +
    ``ingress/auth.py`` API keys + ``ingress/quota.py`` tenant gates)
    when ``fleet_http_port`` is set — ``POST /v1/extract``,
    ``POST /v1/search``, ``GET /v1/requests/<id>``,
    ``GET /v1/requests/<id>/trace`` (cross-host assembled trace),
    ``GET /v1/metrics``, ``GET /metrics`` (fleet-aggregated Prometheus
    text), and an unauthenticated ``GET /healthz`` carrying the
    per-backend health table.

Routing: requests key on the first video's CONTENT hash (the same
sha256 the content-addressed cache keys on — ``cache/key.hash_file``),
so every video's repeat traffic lands on the shard whose L1 cache and
warm pools already hold it. Vector searches key on the family.

Failover (the wire-1.4 contract): a backend failure is classified by
its structured error ``code`` — ``shed`` / ``connect_refused`` /
``deadline`` walk to the hash ring's NEXT host with bounded
exponential backoff (at most ``fleet_max_attempts`` hosts); everything
else (``invalid``, ``unsupported``, ``not_found``, ``internal``)
propagates to the caller, because a request the whole fleet would
reject identically must not be retried N times. Message text never
drives the decision.

Membership: ``fleet_hosts`` is static config; LIVENESS is probed — a
background thread pings every backend each ``fleet_probe_interval_s``,
and the ping response's ``draining`` flag (wire 1.1+) removes a
draining host from the eligible set before its listener closes
(drain-aware membership). A connect failure on the REQUEST path marks
the backend unhealthy immediately — the next submit skips it without
waiting for the probe cycle. Unhealthy hosts stay ON the ring
(eligibility is a filter, not a rebuild), so when one returns, exactly
its own keys come home.

Observability (vft-scope): the router is the one hop every production
request crosses, so it records its own ``route`` / ``backend_call`` /
``failover`` / ``probe`` spans on a ``SpanRecorder``, mints or adopts
a W3C traceparent per submit and forwards it on every loopback hop —
one trace_id spans the whole fleet. The ``trace`` command (and
``GET /v1/requests/<id>/trace``) scatter-gathers: every backend the
request ATTEMPTED is asked for its spans (failover history included),
each event is stamped ``host=``, and the merge is ts-sorted under the
one trace_id. Per-host clocks are not aligned — the ts-sort is a
presentation order; the ``host`` attr is the ground truth for "where
did this span run". ``metrics_prom`` / ``GET /metrics`` aggregate
every backend's exposition (``fleet/aggregate.py``: host-relabel +
merge) with the router's own ``vft_fleet_*`` families and the always-on
fleet SLO burn-rate gauges (``obs/slo.py`` over the router's
routed-request families) — one scrape target for the whole fleet.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from video_features_torch.fleet import aggregate
from video_features_torch.fleet.ring import DEFAULT_REPLICAS, HashRing
from video_features_torch.obs.context import TraceContext, accept_traceparent
from video_features_torch.obs.metrics import MetricsRegistry
from video_features_torch.obs.slo import SloEvaluator
from video_features_torch.obs.spans import CLOCK, SpanRecorder
from video_features_torch.serve import protocol
from video_features_torch.serve.client import ServeClient, ServeError

# request_id → backend retention for status/trace routing; same bound
# as the daemons' own request history
ROUTE_HISTORY = 4096

# the router's span ring: routing spans are tiny (4 per routed request
# worst-case) so a fraction of the daemons' 200K default covers hours
ROUTER_TRACE_CAPACITY = 50_000


def _log_fleet_error(what: str) -> None:
    """Router-path failures degrade to failover or a structured error,
    never to a dropped request — but silently eating them would hide a
    dead backend forever. Same reporting seam as cache/aot."""
    import logging

    from video_features_torch.obs.events import event
    event(logging.WARNING, f'fleet router {what} failed (continuing)',
          subsystem='fleet', exc_info=True)


class Backend:
    """One configured backend host and its probed liveness."""

    def __init__(self, addr: str) -> None:
        self.addr = addr
        host, _, port = addr.rpartition(':')
        self.host = host or '127.0.0.1'
        self.port = int(port)
        self.healthy = False
        self.draining = False
        self.last_probe_t = 0.0
        self.last_error: Optional[str] = None
        self.consecutive_failures = 0

    def snapshot(self) -> Dict[str, Any]:
        # probe_age_s makes freshness explicit: `healthy` alone can't
        # distinguish a live backend from one whose last GOOD probe is
        # a probe-loop stall ago (None = never probed)
        age = (round(time.time() - self.last_probe_t, 3)
               if self.last_probe_t else None)
        return {'healthy': self.healthy, 'draining': self.draining,
                'last_probe_t': self.last_probe_t,
                'probe_age_s': age,
                'last_error': self.last_error,
                'consecutive_failures': self.consecutive_failures}


class FleetRouter:
    """Content-hash router over a static backend list."""

    # failover backoff between ring hosts: same shape as ServeClient's
    # connect backoff — short, doubling, jitter-free (the per-host
    # connect path already jitters)
    _BACKOFF_CAP_S = 0.5

    def __init__(self, hosts: List[str], host: str = '127.0.0.1',
                 port: int = 0,
                 http_host: str = '127.0.0.1',
                 http_port: Optional[int] = None,
                 auth_file: Optional[str] = None,
                 auth: Optional[Any] = None,
                 probe_interval_s: float = 2.0,
                 max_attempts: int = 3,
                 backoff_base_s: float = 0.05,
                 connect_timeout_s: float = 2.0,
                 ring_replicas: int = DEFAULT_REPLICAS,
                 max_connections: int = 64,
                 slo_latency_p99_s: float = 30.0,
                 slo_availability: float = 0.999) -> None:
        addrs = []
        for h in hosts:
            addr = str(h)
            if ':' not in addr:
                addr = f'127.0.0.1:{addr}'   # bare port = loopback sim
            addrs.append(addr)
        if not addrs:
            raise ValueError('fleet_hosts must name at least one backend')
        self.ring = HashRing(addrs, replicas=ring_replicas)
        self._backends = {a: Backend(a) for a in self.ring.hosts}
        self.host, self._port_req = host, int(port)
        self.probe_interval_s = float(probe_interval_s)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base_s = float(backoff_base_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._lock = threading.Lock()
        self._draining = False
        self._started_at = time.monotonic()
        # request_id → (owner addr, trace_id, attempted addrs) — the
        # owner routes status; the full attempt history (failovers
        # included) routes the scatter-gather trace assembly
        self._routes: Dict[str, Tuple[str, Optional[str],
                                      Tuple[str, ...]]] = {}
        self._route_order: 'deque[str]' = deque()
        # counters (under _lock)
        self._routed: Dict[str, int] = {a: 0 for a in self.ring.hosts}
        self._failovers = 0
        self._rejected = 0
        # vft-scope: the router's own observability plane — routing
        # spans, vft_fleet_* families, and the always-on fleet SLO
        # (its /metrics is the fleet's one scrape target, so the
        # vft_slo_* gauges must always render)
        self.recorder = SpanRecorder(capacity=ROUTER_TRACE_CAPACITY)
        self.registry = MetricsRegistry()
        self._latency_hist = self.registry.histogram(
            'vft_fleet_request_latency_seconds',
            'router-observed latency of routed requests (failover '
            'walk included)')
        self._req_completed = self.registry.counter(
            'vft_fleet_requests_total', 'routed requests by outcome',
            labels={'outcome': 'completed'})
        self._req_failed = self.registry.counter(
            'vft_fleet_requests_total', 'routed requests by outcome',
            labels={'outcome': 'failed'})
        self.slo = SloEvaluator(
            self.registry,
            latency_p99_s=slo_latency_p99_s,
            availability=slo_availability,
            latency_family='vft_fleet_request_latency_seconds',
            outcome_family='vft_fleet_requests_total')
        self._sock = None
        self._accept_thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # optional HTTP front door (reuses the ingress transport/auth)
        self.http = None
        self._http_auth = auth
        self._http_host, self._http_port = http_host, http_port
        self._http_auth_file = auth_file
        self._quota = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._sock is not None, 'router not started'
        return self._sock.getsockname()[1]

    def start(self) -> 'FleetRouter':
        import socket
        # one synchronous probe sweep BEFORE accepting traffic, so the
        # first request sees real membership, not all-unhealthy
        self.probe()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._port_req))
        self._sock.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='fleet-accept', daemon=True)
        self._accept_thread.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name='fleet-probe', daemon=True)
        self._probe_thread.start()
        if self._http_port is not None:
            from video_features_torch.ingress.auth import ApiKeyAuth
            from video_features_torch.ingress.http import HttpServer
            from video_features_torch.ingress.quota import QuotaManager
            if self._http_auth is None:
                if not self._http_auth_file:
                    raise ValueError('the fleet HTTP front door requires '
                                     'an API-key file (fleet_auth_file)')
                self._http_auth = ApiKeyAuth.from_file(self._http_auth_file)
            self._quota = QuotaManager()
            self.http = HttpServer(self._handle_http,
                                   host=self._http_host,
                                   port=int(self._http_port)).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._draining = True
        if self.http is not None:
            self.http.begin_drain()
            self.http.finish_drain(grace_s=1.0)
        if self._sock is not None:
            import socket
            try:
                # shutdown BEFORE close: a bare close leaves the
                # listener half-alive while the accept thread is blocked
                # on it, and one more connection would sneak through
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass

    # -- membership ----------------------------------------------------------

    def _probe_call(self, b: Backend) -> Dict[str, Any]:
        """One raw ping with a HARD read deadline — ServeClient leaves
        reads unbounded (extraction can take a while), but a wedged
        backend that accepts and never answers must cost the probe
        thread half a second, not its liveness."""
        import socket
        timeout = min(0.5, self.connect_timeout_s)
        with socket.create_connection((b.host, b.port),
                                      timeout=timeout) as conn:
            conn.settimeout(timeout)
            conn.sendall(protocol.encode({'cmd': protocol.CMD_PING,
                                          'v': protocol.VERSION}))
            with conn.makefile('rb') as rfile:
                line = rfile.readline()
        if not line:
            raise ConnectionError('backend closed the probe connection')
        return protocol.decode(line)

    def probe(self) -> Dict[str, Dict[str, Any]]:
        """One synchronous health sweep; returns the per-backend table.
        ``ping`` (wire 1.1+) answers ``draining`` — a draining host is
        alive but leaves the eligible set."""
        for b in self._backends.values():
            t0 = CLOCK()
            try:
                resp = self._probe_call(b)
                with self._lock:
                    b.healthy = bool(resp.get('ok'))
                    b.draining = bool(resp.get('draining'))
                    b.last_error = None
                    b.consecutive_failures = 0
            except (ServeError, OSError, ValueError) as e:
                with self._lock:
                    b.healthy = False
                    b.last_error = f'{type(e).__name__}: {e}'
                    b.consecutive_failures += 1
            finally:
                with self._lock:
                    b.last_probe_t = time.time()
                    healthy, draining = b.healthy, b.draining
                self.recorder.span('probe', t0, CLOCK(), host=b.addr,
                                   healthy=healthy, draining=draining)
        with self._lock:
            return {a: b.snapshot() for a, b in self._backends.items()}

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe()
            except Exception:
                _log_fleet_error('probe sweep')

    def eligible(self) -> List[str]:
        """Backends the ring may route to: healthy and not draining."""
        with self._lock:
            return [a for a, b in self._backends.items()
                    if b.healthy and not b.draining]

    # -- routing core --------------------------------------------------------

    @staticmethod
    def route_key(msg: Dict[str, Any]) -> str:
        """The consistent-hash key for one request: the first video's
        CONTENT hash (cache-key identity — repeat traffic for a video
        lands where its features are cached), the path itself when the
        file isn't readable yet (the backend will answer the error),
        or the family for vector searches."""
        paths = msg.get('video_paths') or []
        video = msg.get('video_path')
        if video is not None and not paths:
            paths = [video]
        if paths:
            from video_features_torch.cache.key import hash_file
            try:
                return hash_file(str(paths[0]))
            except OSError:
                return str(paths[0])
        return f"family:{msg.get('family')}"

    def _remember_route(self, request_id: str, addr: str,
                        trace_id: Optional[str] = None,
                        attempted: Tuple[str, ...] = ()) -> None:
        with self._lock:
            self._routes[request_id] = (addr, trace_id,
                                        attempted or (addr,))
            self._route_order.append(request_id)
            while len(self._route_order) > ROUTE_HISTORY:
                self._routes.pop(self._route_order.popleft(), None)

    def _backend_call(self, addr: str,
                      msg: Dict[str, Any]) -> Dict[str, Any]:
        b = self._backends[addr]
        client = ServeClient(b.port, host=b.host,
                             connect_timeout_s=self.connect_timeout_s)
        return client._call(dict(msg))

    @staticmethod
    def _span_ids(ctx: Optional[TraceContext]) -> Dict[str, str]:
        """trace_id + a FRESH span_id for one router span (the pairing
        contract: every trace-scoped event names its own span)."""
        return ctx.child().attrs() if ctx is not None else {}

    def _observe_routed(self, t0: float, ok: bool) -> None:
        """Feed the router's SLO families: one latency observation and
        one outcome per routed request (failover walk included — the
        caller experienced the whole walk)."""
        self._latency_hist.observe(CLOCK() - t0)
        (self._req_completed if ok else self._req_failed).inc()

    def _route(self, key: str, msg: Dict[str, Any],
               on_success: Optional[Callable[[Dict[str, Any], str,
                                              Tuple[str, ...]], None]]
               = None,
               ctx: Optional[TraceContext] = None,
               ) -> Dict[str, Any]:
        """Walk the ring's failover order for ``key``, forwarding
        ``msg``; classify each failure by its structured code and
        either walk on (shed / connect_refused / deadline) or
        propagate. Returns the successful backend response, or the
        LAST failure as a structured error. ``on_success`` receives
        the response, the serving backend, and every backend the walk
        ATTEMPTED (trace assembly follows the same history)."""
        t_route = CLOCK()
        hosts = self.ring.hosts_for(key, eligible=self.eligible())
        if not hosts:
            with self._lock:
                self._rejected += 1
            self._observe_routed(t_route, ok=False)
            return protocol.error('no eligible fleet backend '
                                  '(all unhealthy or draining)',
                                  code=protocol.ERR_SHED)
        delay = self.backoff_base_s
        last: Optional[ServeError] = None
        attempted: List[str] = []
        for i, addr in enumerate(hosts[:self.max_attempts]):
            if i > 0:
                with self._lock:
                    self._failovers += 1
                t_f = CLOCK()
                time.sleep(delay)
                self.recorder.span('failover', t_f, CLOCK(),
                                   from_backend=attempted[-1],
                                   to_backend=addr, attempt=i,
                                   **self._span_ids(ctx))
                delay = min(delay * 2, self._BACKOFF_CAP_S)
            attempted.append(addr)
            t_call = CLOCK()
            try:
                resp = self._backend_call(addr, msg)
            except ServeError as e:
                self.recorder.span('backend_call', t_call, CLOCK(),
                                   backend=addr, attempt=i,
                                   error_code=e.code,
                                   **self._span_ids(ctx))
                last = e
                if e.code == protocol.ERR_CONNECT_REFUSED:
                    # fast member removal: don't wait for the probe
                    with self._lock:
                        b = self._backends[addr]
                        b.healthy = False
                        b.last_error = str(e)
                        b.consecutive_failures += 1
                if e.retryable:
                    continue
                break
            except (OSError, ValueError) as e:
                # transport surprise outside the classified set (reset
                # mid-read, undecodable response): treat as shed —
                # another host may serve it — but remember the text
                self.recorder.span('backend_call', t_call, CLOCK(),
                                   backend=addr, attempt=i,
                                   error_code=protocol.ERR_SHED,
                                   **self._span_ids(ctx))
                last = ServeError(f'{type(e).__name__}: {e}',
                                  code=protocol.ERR_SHED)
                continue
            self.recorder.span('backend_call', t_call, CLOCK(),
                               backend=addr, attempt=i,
                               **self._span_ids(ctx))
            with self._lock:
                self._routed[addr] = self._routed.get(addr, 0) + 1
            if on_success is not None:
                on_success(resp, addr, tuple(attempted))
            rid = resp.get('request_id')
            self.recorder.span('route', t_route, CLOCK(), backend=addr,
                               attempts=i + 1,
                               **({'request_id': rid} if rid else {}),
                               **self._span_ids(ctx))
            self._observe_routed(t_route, ok=True)
            return resp
        with self._lock:
            self._rejected += 1
        assert last is not None
        self.recorder.span('route', t_route, CLOCK(),
                           attempts=len(attempted),
                           error_code=last.code or protocol.ERR_INTERNAL,
                           **self._span_ids(ctx))
        self._observe_routed(t_route, ok=False)
        return protocol.error(str(last),
                              code=last.code or protocol.ERR_INTERNAL,
                              **{k: v for k, v in last.extra.items()
                                 if k not in ('ok', 'error', 'code')})

    # -- command handlers ----------------------------------------------------

    def submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._draining:
                self._rejected += 1
                return protocol.error('draining',
                                      code=protocol.ERR_SHED)
        # adopt the caller's traceparent or mint one, and forward it on
        # EVERY loopback hop: the backend joins the same trace, so one
        # trace_id spans router + every attempted backend
        ctx = accept_traceparent(msg.get('traceparent'))
        msg = dict(msg)
        msg['traceparent'] = ctx.traceparent()

        def _remember(resp: Dict[str, Any], addr: str,
                      attempted: Tuple[str, ...]) -> None:
            rid = resp.get('request_id')
            if rid:
                self._remember_route(rid, addr, ctx.trace_id, attempted)
            # fused children route with the umbrella
            for child in (resp.get('requests') or {}).values():
                self._remember_route(child, addr, ctx.trace_id,
                                     attempted)
            resp['backend'] = addr

        return self._route(self.route_key(msg), msg,
                           on_success=_remember, ctx=ctx)

    def request_scoped(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """status: route by the remembered request_id → owner backend
        binding (content hash is not recoverable from an id)."""
        rid = msg.get('request_id')
        with self._lock:
            entry = self._routes.get(rid)
        if entry is None:
            return protocol.error(f'unknown request_id {rid!r}',
                                  code=protocol.ERR_NOT_FOUND)
        try:
            return self._backend_call(entry[0], msg)
        except ServeError as e:
            return protocol.error(str(e),
                                  code=e.code or protocol.ERR_INTERNAL)

    def assemble_trace(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Scatter-gather trace assembly: ask EVERY backend the request
        attempted (failover history, not just the owner) for its spans,
        stamp each event ``host=``, merge with the router's own spans
        for the trace, and return one ts-sorted timeline under the one
        trace_id. Per-host clocks are not aligned, so the sort is a
        presentation order — the ``host`` attr says where a span ran."""
        rid = msg.get('request_id')
        with self._lock:
            entry = self._routes.get(rid)
        if entry is None:
            return protocol.error(f'unknown request_id {rid!r}',
                                  code=protocol.ERR_NOT_FOUND)
        owner, trace_id, attempted = entry
        events: List[Dict[str, Any]] = []
        hosts: List[str] = []
        state = None
        for addr in attempted:
            try:
                resp = self._backend_call(
                    addr, {'cmd': protocol.CMD_TRACE,
                           'request_id': rid})
            except (ServeError, OSError, ValueError):
                # a backend that SHED the submit never admitted the
                # request — its not_found is expected, and even the
                # owner going down must degrade the trace to the spans
                # we can still reach, not fail the assembly
                if addr == owner:
                    _log_fleet_error(f'trace fetch from owner {addr}')
                continue
            hosts.append(addr)
            if addr == owner:
                state = resp.get('state')
                trace_id = resp.get('trace_id') or trace_id
            for ev in resp.get('events') or ():
                ev = dict(ev)
                args = dict(ev.get('args') or {})
                args['host'] = addr
                ev['args'] = args
                events.append(ev)
        for ev in self.recorder.snapshot():
            if ev.get('ph') == 'M':
                continue                  # router thread metas: noise
            args = ev.get('args') or {}
            if not ((trace_id and args.get('trace_id') == trace_id)
                    or args.get('request_id') == rid):
                continue
            ev = dict(ev)
            args = dict(args)
            args['host'] = 'router'
            ev['args'] = args
            events.append(ev)
        # metas first, then the joint timeline — cross-host ts are a
        # presentation order (same contract as tools/trace_view.py's
        # multi-file merge)
        events.sort(key=lambda e: (e.get('ph') != 'M',
                                   e.get('ts', 0)))
        return protocol.ok(request_id=rid, trace_id=trace_id,
                           state=state, events=events,
                           hosts=['router'] + hosts)

    def search(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self._route(self.route_key(msg), msg)

    def forward_any(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Commands with no content affinity (index_status): any
        eligible backend, ring-ordered on a constant key for
        stability."""
        return self._route('fleet:any', msg)

    def metrics(self) -> Dict[str, Any]:
        """The fleet metrics document: router counters + the
        per-backend table (health, queue depth, cache hit rate — the
        ``python -m video_features_torch.fleet.status`` surface). Backend metrics are
        fetched live from healthy hosts; a host that fails the fetch
        degrades to its probe row."""
        with self._lock:
            backends = {a: b.snapshot()
                        for a, b in self._backends.items()}
            doc: Dict[str, Any] = {
                'uptime_s': round(time.monotonic() - self._started_at, 3),
                'draining': self._draining,
                'hosts': list(self.ring.hosts),
                'routed': dict(self._routed),
                'failovers': self._failovers,
                'rejected': self._rejected,
            }
        for addr, row in backends.items():
            if not row['healthy']:
                continue
            try:
                m = self._backend_call(addr,
                                       {'cmd': protocol.CMD_METRICS})
                bm = m.get('metrics') or {}
                row['queue_depth'] = (bm.get('queue') or {}).get('depth')
                row['cache_hit_rate'] = \
                    (bm.get('cache') or {}).get('hit_rate')
                row['builds_compiled'] = \
                    (bm.get('warm_pool') or {}).get('builds_compiled')
                row['builds_loaded'] = \
                    (bm.get('warm_pool') or {}).get('builds_loaded')
            except (ServeError, OSError, ValueError):
                _log_fleet_error(f'metrics fetch from {addr}')
        doc['eligible'] = [a for a, r in backends.items()
                           if r['healthy'] and not r['draining']]
        doc['backends'] = backends
        # fleet-level SLO burn rates: every metrics assembly is an
        # evaluator tick (scrape-driven sampling, no extra thread)
        doc['slo'] = self.slo.tick()
        return {'fleet': doc}

    def metrics_prom(self) -> str:
        """The fleet's ONE Prometheus scrape: every backend's own
        exposition host-relabeled and merged (``fleet/aggregate.py``)
        plus the router's ``vft_fleet_*`` / ``vft_slo_*`` families. A
        backend that fails its scrape contributes no samples — its
        absence shows as ``vft_fleet_backend_up 0`` with an explicit
        ``vft_fleet_probe_age_seconds``, never as silently stale
        values."""
        deadline = min(0.5, self.connect_timeout_s)
        with self._lock:
            backends = list(self._backends.values())
        texts: Dict[str, Optional[str]] = {}
        for b in backends:
            if not b.healthy:
                texts[b.addr] = None
                continue
            try:
                texts[b.addr] = aggregate.scrape_prom(
                    b.host, b.port, deadline)
            except (ServeError, OSError, ValueError):
                _log_fleet_error(f'metrics scrape from {b.addr}')
                texts[b.addr] = None
        with self._lock:
            routed = dict(self._routed)
            failovers, rejected = self._failovers, self._rejected
            snaps = {a: b.snapshot() for a, b in self._backends.items()}
        # mirror the router's plain-int counters into registry series
        # by DELTA (counters only go up; the ints are the truth)
        for name, help_text, total, labels in (
                [('vft_fleet_failovers_total',
                  'failover walks to a next ring host', failovers, None),
                 ('vft_fleet_rejected_total',
                  'requests the router answered with a structured '
                  'error', rejected, None)]
                + [('vft_fleet_routed_total',
                    'requests routed per backend', n, {'host': a})
                   for a, n in routed.items()]):
            c = self.registry.counter(name, help_text, labels=labels)
            if total > c.value:
                c.inc(total - c.value)
        for addr, snap in snaps.items():
            self.registry.gauge(
                'vft_fleet_backend_up',
                '1 if the last probe of this backend succeeded',
                labels={'host': addr}).set(1 if snap['healthy'] else 0)
            self.registry.gauge(
                'vft_fleet_backend_draining',
                '1 if the backend reported draining on its last probe',
                labels={'host': addr}).set(1 if snap['draining'] else 0)
            if snap['probe_age_s'] is not None:
                self.registry.gauge(
                    'vft_fleet_probe_age_seconds',
                    'seconds since this backend was last probed '
                    '(staleness of its health row and of a missing '
                    'scrape)',
                    labels={'host': addr}).set(snap['probe_age_s'])
        self.slo.tick()
        return aggregate.merge_expositions(texts) + self.registry.render()

    # -- loopback listener ---------------------------------------------------

    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        rejection = protocol.check_version(msg)
        if rejection is not None:
            return rejection
        cmd = msg.get('cmd')
        if cmd == protocol.CMD_PING:
            with self._lock:
                draining = self._draining
            return protocol.ok(draining=draining, v=protocol.VERSION,
                               fleet_hosts=len(self.ring))
        if cmd == protocol.CMD_SUBMIT:
            return self.submit(msg)
        if cmd == protocol.CMD_STATUS:
            return self.request_scoped(msg)
        if cmd == protocol.CMD_TRACE:
            return self.assemble_trace(msg)
        if cmd == protocol.CMD_SEARCH:
            return self.search(msg)
        if cmd == protocol.CMD_INDEX_STATUS:
            return self.forward_any(msg)
        if cmd == protocol.CMD_METRICS:
            return protocol.ok(metrics=self.metrics())
        if cmd == protocol.CMD_METRICS_PROM:
            return protocol.ok(text=self.metrics_prom())
        if cmd == protocol.CMD_DRAIN:
            with self._lock:
                self._draining = True
            return protocol.ok(draining=True)
        return protocol.error(
            f'unknown cmd {cmd!r}; known: {", ".join(protocol.COMMANDS)}',
            code=protocol.ERR_INVALID)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                     # socket closed: stopping
            threading.Thread(target=self._handle_conn, args=(conn,),
                             name='fleet-conn', daemon=True).start()

    def _handle_conn(self, conn) -> None:
        try:
            with conn:
                rfile = conn.makefile('rb')
                wfile = conn.makefile('wb')
                for line in rfile:
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
                        return             # client went away mid-reply
        except OSError:
            pass                           # torn connection: next client

    # -- HTTP front door -----------------------------------------------------

    # structured code → HTTP status for propagated backend errors
    _CODE_STATUS: Dict[str, int] = {}

    @classmethod
    def _code_to_status(cls, code: Optional[str]) -> int:
        from video_features_torch.ingress import http as h
        if not cls._CODE_STATUS:
            cls._CODE_STATUS.update({
                protocol.ERR_SHED: h.SERVICE_UNAVAILABLE,
                protocol.ERR_CONNECT_REFUSED: h.SERVICE_UNAVAILABLE,
                protocol.ERR_DEADLINE: h.SERVICE_UNAVAILABLE,
                protocol.ERR_INVALID: h.BAD_REQUEST,
                protocol.ERR_UNSUPPORTED: h.BAD_REQUEST,
                protocol.ERR_NOT_FOUND: h.NOT_FOUND,
                protocol.ERR_INTERNAL: h.INTERNAL_ERROR,
            })
        return cls._CODE_STATUS.get(code or '', h.INTERNAL_ERROR)

    def _handle_http(self, req, resp, conn) -> None:
        from video_features_torch.ingress import http as h
        try:
            if req.method == 'GET' and req.path == '/healthz':
                # NO auth: load balancers probe this
                with self._lock:
                    table = {a: {'healthy': b.healthy,
                                 'draining': b.draining}
                             for a, b in self._backends.items()}
                    draining = self._draining
                resp.send_json(h.OK, {'ok': True, 'draining': draining,
                                      'fleet': True, 'backends': table})
                return
            tenant = self._http_auth.authenticate(req.headers)
            if tenant is None:
                resp.send_json(h.UNAUTHORIZED, {
                    'ok': False, 'error': 'unauthorized',
                    'message': 'missing or unknown API key '
                               '(Authorization: Bearer <key>)'})
                return
            if req.method == 'GET' and req.path == '/v1/metrics':
                resp.send_json(h.OK, {'ok': True,
                                      'metrics': self.metrics()})
                return
            if req.method == 'GET' and req.path == '/metrics':
                # the fleet's one Prometheus scrape target (same
                # content type as the daemons' ingress /metrics)
                resp.send(h.OK, self.metrics_prom().encode('utf-8'),
                          content_type='text/plain; version=0.0.4')
                return
            if req.method == 'GET' \
                    and req.path.startswith('/v1/requests/'):
                rid = req.path[len('/v1/requests/'):].strip('/')
                if rid.endswith('/trace'):
                    out = self.assemble_trace(
                        {'cmd': protocol.CMD_TRACE,
                         'request_id': rid[:-len('/trace')].strip('/')})
                else:
                    out = self.request_scoped(
                        {'cmd': protocol.CMD_STATUS, 'request_id': rid})
                status = h.OK if out.get('ok') \
                    else self._code_to_status(out.get('code'))
                resp.send_json(status, out)
                return
            if req.method == 'POST' \
                    and req.path in ('/v1/extract', '/v1/search'):
                body = req.json_body(16 * (1 << 20))
                acquired, reason = self._quota.acquire(tenant)
                if not acquired:
                    resp.send_json(
                        h.TOO_MANY_REQUESTS,
                        {'ok': False, 'error': reason,
                         'tenant': tenant.name})
                    return
                try:
                    if req.path == '/v1/extract':
                        msg = {'cmd': protocol.CMD_SUBMIT}
                        for k in protocol.SUBMIT_FIELDS:
                            if k in body:
                                msg[k] = body[k]
                        tp = req.headers.get('traceparent')
                        if tp and 'traceparent' not in msg:
                            msg['traceparent'] = tp
                        out = self.submit(msg)
                    else:
                        msg = dict(body)
                        msg['cmd'] = protocol.CMD_SEARCH
                        out = self.search(msg)
                finally:
                    # the router holds the concurrency unit only for
                    # the forward itself: completion lives on the
                    # backend, and its own ingress (when enabled)
                    # owns per-request lifetime quota
                    self._quota.release(tenant.name)
                status = h.OK if out.get('ok') \
                    else self._code_to_status(out.get('code'))
                resp.send_json(status, out)
                return
            raise h.HttpError(h.NOT_FOUND, 'not_found',
                              f'no fleet route {req.method} {req.path}')
        except h.HttpError as e:
            resp.send_json(e.status, e.body())


def fleet_main(argv: List[str]) -> int:
    """``python -m video_features_torch fleet`` entry point."""
    import os
    import signal

    from video_features_torch.config import parse_dotlist, split_fleet_config
    cli = parse_dotlist(argv)
    fleet_cfg, extra = split_fleet_config(cli)
    if extra:
        raise ValueError(
            f'unknown fleet keys: {sorted(extra)} — the router takes '
            f'only fleet_* knobs (backends own extraction config)')
    hosts = fleet_cfg['fleet_hosts']
    if not hosts:
        raise ValueError('fleet_hosts is required, e.g. '
                         'fleet_hosts=[127.0.0.1:9301,127.0.0.1:9302]')
    router = FleetRouter(
        hosts,
        host=fleet_cfg['fleet_host'],
        port=fleet_cfg['fleet_port'],
        http_host=fleet_cfg['fleet_http_host'],
        http_port=fleet_cfg['fleet_http_port'],
        auth_file=fleet_cfg['fleet_auth_file'],
        probe_interval_s=fleet_cfg['fleet_probe_interval_s'],
        max_attempts=fleet_cfg['fleet_max_attempts'],
        backoff_base_s=fleet_cfg['fleet_backoff_base_s'],
        connect_timeout_s=fleet_cfg['fleet_connect_timeout_s'],
        ring_replicas=fleet_cfg['fleet_ring_replicas'],
        slo_latency_p99_s=fleet_cfg['fleet_slo_latency_p99_s'],
        slo_availability=fleet_cfg['fleet_slo_availability'],
    ).start()
    done = threading.Event()

    def _graceful(signum, frame):
        router.stop()
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    # machine-greppable endpoint line (tests and tooling scrape it,
    # same contract as the serve daemon's startup line)
    print(f'fleet router on {router.host}:{router.port} '
          f'(pid {os.getpid()}; backends={",".join(router.ring.hosts)}, '
          f'eligible={len(router.eligible())})', flush=True)
    if router.http is not None:
            print(f'fleet ingress on {router.http.host}:{router.http.port}',
              flush=True)
    # in slices, so a signal that lands on another thread still runs its
    # handler on the main thread (an untimed wait would never return)
    while not done.wait(0.5):
        pass
    print('fleet: stopped, exiting', flush=True)
    return 0
