"""The ingress gateway: HTTP routes glued to the extraction server (the
port's copy of ``video_features_tpu/ingress/gateway.py``: the same routes,
status codes, error slugs and metric names).

Endpoints (all JSON unless noted; auth via ``Authorization: Bearer
<key>`` or ``X-API-Key``):

  * ``GET  /healthz``            — liveness (NO auth: load balancers)
  * ``GET  /v1/metrics``         — the serve metrics document
  * ``GET  /metrics``            — Prometheus text exposition 0.0.4
  * ``POST /v1/extract``         — submit an extraction request
    (``{feature_type, video_paths, overrides?, timeout_s?,
    range?: [start_s, end_s], priority?, features?: [..]}``) →
    ``{request_id, tenant, trace_id}``. A W3C ``traceparent`` request
    header joins the request to the caller's distributed trace; minted
    when absent/malformed. ``features`` (wire v1.2) submits a FUSED
    multi-family request: the response carries the umbrella request_id
    plus a per-family ``requests`` id map (and ``errors`` for families
    rejected mid-fan-out); status on the umbrella id nests per-family
    ``videos``. One quota unit per fused request, not per family.
  * ``POST /v1/search``          — the feature-index query (wire v1.3):
    ``{family, vector, k?}`` or ``{video_path, features, k?,
    timeout_s?}`` → ranked hits; 503 ``index_disabled`` without
    ``index_enabled``, before any quota is spent.
  * ``GET  /v1/requests/<id>``   — request status (tenant-scoped)
  * ``GET  /v1/requests/<id>/trace`` — the request's assembled span
    timeline (tenant-scoped: ANOTHER tenant's id answers 403 — the
    trace surface is explicit about authorization, unlike status's
    deliberate 404 ambiguity, because traces carry video paths and
    config detail worth a loud denial)
  * ``POST /v1/live/<session>``  — live session: chunked request body
    (first chunk: JSON header ``{feature_type, fps?, overrides?,
    timeout_s?, priority?}``; then ``.npy`` frame batches; empty chunk
    ends), chunked response (one JSON line per extracted window, then a
    final ``{"done": true, ...}`` line).

Admission layering — each gate sheds BEFORE the next spends anything:

  1. transport: connection cap (503), body/header bounds (413/431);
  2. auth: unknown key → 401, before the body is read;
  3. quota: per-tenant token bucket + concurrent-request budget (429);
  4. serve admission: queue depth by PRIORITY CLASS — a saturated queue
     sheds ``batch`` before ``interactive`` (503 ``queue_full``).

A shed request never occupies an admission slot, and every shed
increments ``vft_ingress_shed_total{tenant, class, reason}``.
"""
from __future__ import annotations

import json
import socket
import time
from collections import deque
from threading import Lock
from typing import Any, Dict, Optional, Tuple

from video_features_torch.ingress.auth import ApiKeyAuth, Tenant
from video_features_torch.ingress.http import (
    BAD_REQUEST, CLIENT_CLOSED, CONFLICT, FORBIDDEN, INTERNAL_ERROR,
    METHOD_NOT_ALLOWED, NOT_FOUND, OK, SERVICE_UNAVAILABLE,
    TOO_MANY_REQUESTS, UNAUTHORIZED, HttpError, HttpRequest, HttpServer,
    ResponseWriter,
)
from video_features_torch.ingress.live import (
    LiveSession, LiveSessionError, decode_frame_chunk,
)
from video_features_torch.ingress.quota import QuotaManager

# request_id → tenant retention (status scoping + quota release); same
# bound as the server's own request history
OWNER_HISTORY = 4096

# a live session whose client stops sending/reading for this long is
# torn down (half-open protection between drains)
LIVE_IDLE_TIMEOUT_S = 300.0
# after the client finishes its frames, how long to wait for the device
# loop to finalize before answering with the current state
LIVE_FINALIZE_TIMEOUT_S = 300.0

_EXTRACT_FIELDS = frozenset({'feature_type', 'video_paths', 'overrides',
                             'timeout_s', 'range', 'priority', 'features'})
_LIVE_FIELDS = frozenset({'feature_type', 'fps', 'overrides', 'timeout_s',
                          'priority'})
_SEARCH_FIELDS = frozenset({'family', 'vector', 'video_path', 'features',
                            'k', 'timeout_s', 'priority'})

# W3C Trace Context request header (lowercased by the header parser)
_TRACEPARENT_HEADER = 'traceparent'


class IngressGateway:
    """One network front door over one :class:`ExtractionServer`."""

    def __init__(self, server, host: str = '127.0.0.1', port: int = 0,
                 auth_file: Optional[str] = None,
                 auth: Optional[ApiKeyAuth] = None,
                 max_body_bytes: int = 64 * (1 << 20),
                 max_connections: int = 64) -> None:
        if auth is None:
            if not auth_file:
                raise ValueError('the ingress requires an API-key file '
                                 '(serve_ingress_auth_file)')
            auth = ApiKeyAuth.from_file(auth_file)
        self.server = server
        self.auth = auth
        self.quota = QuotaManager()
        self.max_body_bytes = int(max_body_bytes)
        self.http = HttpServer(self._handle, host=host, port=port,
                               max_connections=max_connections)
        self._lock = Lock()
        # status-scoping table (request_id → tenant), aged out at
        # OWNER_HISTORY — but never while the request still holds a
        # concurrency unit (see _pending_release)
        self._owners: Dict[str, str] = {}
        self._owner_order: 'deque[str]' = deque()
        # the QUOTA ledger, separate from status scoping: request_id →
        # tenant for every request still holding a concurrency unit.
        # Entries leave ONLY on completion, so history aging can never
        # leak a unit (a live session outliving 4096 newer requests
        # would otherwise lock its tenant out forever); size is bounded
        # by admission (queue depth + live sessions), not by history.
        self._pending_release: Dict[str, str] = {}
        # completions that beat _own() to the punch (an all-cache-hit
        # request is terminal INSIDE submit, before the gateway learns
        # its id): _own() settles these immediately instead of leaking
        # the tenant's concurrency unit. BOUNDED: every loopback
        # request's completion also lands here (the gateway never owns
        # those), and the race window this covers is microseconds.
        self._early_done: 'deque[str]' = deque(maxlen=256)
        self._live: Dict[str, LiveSession] = {}  # session_id → session
        self._live_by_request: Dict[str, LiveSession] = {}
        self._requests_total = 0
        self._shed_total = 0
        self._recorder = None                   # ingress spans (trace_out)
        # instruments live on the SERVER's registry so one scrape (the
        # loopback metrics_prom command, the .prom mirror, GET /metrics)
        # carries serve + ingress families together
        reg = server.registry
        self._g_live = reg.gauge(
            'vft_ingress_live_sessions', 'live sessions in flight')
        self._g_conns = reg.gauge(
            'vft_ingress_open_connections', 'open ingress connections')
        self._h_latency = reg.histogram(
            'vft_ingress_request_latency_seconds',
            'ingress request handling latency (headers to response end)')
        self._reg = reg

    # -- lifecycle -----------------------------------------------------------

    @property
    def host(self) -> str:
        return self.http.host

    @property
    def port(self) -> int:
        return self.http.port

    @property
    def n_tenants(self) -> int:
        return self.auth.n_tenants

    def start(self) -> 'IngressGateway':
        trace_out = self.server.base_overrides.get('trace_out')
        if trace_out:
            # ingress spans join the server-wide merged Perfetto export
            # — on the PERSISTENT list: warm-pool churn ages out worker
            # recorders, never the front door's
            from video_features_torch.obs.spans import SpanRecorder
            self._recorder = SpanRecorder()
            self.server._persistent_recorders.append(self._recorder)
        self.http.start()
        self.server.attach_ingress(self)
        self.server.completion_listeners.append(self._on_request_done)
        return self

    def begin_drain(self) -> None:
        """Serve-drain phase 1: stop accepting, end every live session's
        frame input (their tasks finish with the frames already queued,
        so the warm workers' feeds can actually drain)."""
        self.http.begin_drain()
        with self._lock:
            sessions = list(self._live.values())
        for s in sessions:
            s.end_input()

    def finish_drain(self, grace_s: float = 5.0) -> None:
        """Serve-drain phase 2 (after workers joined): abort whatever
        sessions remain and force-close half-open connections — no
        vanished client pins a handler thread or a warm-pool entry."""
        with self._lock:
            sessions = list(self._live.values())
        for s in sessions:
            s.abort()
        self.http.finish_drain(grace_s)

    # -- metrics -------------------------------------------------------------

    def _count(self, endpoint: str, tenant: Optional[str],
               status: int) -> None:
        self._reg.counter(
            'vft_ingress_requests_total',
            'ingress requests by tenant, endpoint, and status code',
            labels={'tenant': tenant or 'anonymous', 'endpoint': endpoint,
                    'code': str(status)}).inc()
        with self._lock:
            self._requests_total += 1

    def _count_shed(self, tenant: Tenant, priority: str,
                    reason: str) -> None:
        self._reg.counter(
            'vft_ingress_shed_total',
            'ingress requests shed before occupying an admission slot, '
            'by tenant, priority class, and reason',
            labels={'tenant': tenant.name, 'class': priority,
                    'reason': reason}).inc()
        with self._lock:
            self._shed_total += 1

    def stats(self) -> Dict[str, Any]:
        """The serve metrics document's ``ingress`` section."""
        with self._lock:
            live = len(self._live)
            requests_total = self._requests_total
            shed_total = self._shed_total
        conns = self.http.open_connections
        self._g_live.set(live)
        self._g_conns.set(conns)
        return {'enabled': True,
                'requests_total': requests_total,
                'shed_total': shed_total,
                'live_sessions': live,
                'open_connections': conns,
                'tenants': self.quota.snapshot()}

    # -- completion plumbing -------------------------------------------------

    def _on_request_done(self, req) -> None:
        """Server completion listener: release the owning tenant's
        concurrency unit; wake the live handler waiting on this id."""
        with self._lock:
            tenant_name = self._pending_release.pop(req.id, None)
            session = self._live_by_request.pop(req.id, None)
            if tenant_name is None:
                # completed before _own() ran (terminal-at-birth cache
                # hit): settle when the submitter records ownership.
                # (Loopback-submitted requests land here too and are
                # never claimed — the deque's maxlen ages them out.)
                self._early_done.append(req.id)
        if tenant_name is not None:
            self.quota.release(tenant_name)
        if session is not None:
            # terminal means no more windows will ever be consumed:
            # abort the input side too, so a handler blocked pushing
            # frames against a full queue (expired deadline, worker
            # crash) unblocks instead of deadlocking until the client
            # gives up
            session.abort()
            session.done.set()

    def _own(self, request_id: str, tenant: Tenant) -> None:
        early = False
        with self._lock:
            if request_id in self._early_done:
                # lost the race with completion: the unit is released
                # below, never ledgered
                early = True
                try:
                    self._early_done.remove(request_id)
                except ValueError:
                    pass
            else:
                self._pending_release[request_id] = tenant.name
            self._owners[request_id] = tenant.name
            self._owner_order.append(request_id)
            # age out TERMINAL requests only; still-running ones (in the
            # quota ledger) keep their status scoping — rotation is
            # bounded because running requests are bounded by admission
            scans = len(self._owner_order)
            while len(self._owner_order) > OWNER_HISTORY and scans > 0:
                scans -= 1
                old = self._owner_order.popleft()
                if old in self._pending_release:
                    self._owner_order.append(old)
                else:
                    self._owners.pop(old, None)
        if early:
            self.quota.release(tenant.name)

    # -- routing -------------------------------------------------------------

    def _handle(self, req: HttpRequest, resp: ResponseWriter,
                conn: socket.socket) -> None:
        t0 = time.perf_counter()
        endpoint = self._endpoint_label(req)
        tenant: Optional[Tenant] = None
        status = INTERNAL_ERROR
        request_id = None
        try:
            if req.path == '/healthz':
                status = OK
                resp.send_json(OK, {
                    'ok': True, 'draining': self.server._draining})
                return
            tenant = self.auth.authenticate(req.headers)
            if tenant is None:
                status = UNAUTHORIZED
                resp.send_json(UNAUTHORIZED, {
                    'ok': False, 'error': 'unauthorized',
                    'message': 'missing or unknown API key '
                               '(Authorization: Bearer <key>)'})
                return
            status, request_id = self._route(req, resp, conn, tenant)
        except HttpError as e:
            status = e.status
            body = e.body()
            if tenant is not None:
                body.setdefault('tenant', tenant.name)
            try:
                resp.send_json(e.status, body)
            except (OSError, ValueError):
                pass
        except (OSError, ConnectionError, socket.timeout):
            status = CLIENT_CLOSED            # client went away mid-request
        finally:
            dt = time.perf_counter() - t0
            self._h_latency.observe(dt)
            self._count(endpoint, tenant.name if tenant else None, status)
            if self._recorder is not None:
                attrs = dict(endpoint=endpoint,
                             tenant=(tenant.name if tenant else None),
                             status=status, request_id=request_id)
                trace_id = self._trace_id_of(request_id)
                if trace_id is not None:
                    # the ingress hop is its own span under the
                    # request's trace (span_id pairs with trace_id —
                    # tools/trace_view.py validates the pairing)
                    from video_features_torch.obs.context import \
                        new_span_id
                    attrs.update(trace_id=trace_id,
                                 span_id=new_span_id())
                self._recorder.span('ingress', t0, t0 + dt, **attrs)

    def _trace_id_of(self, request_id: Optional[str]) -> Optional[str]:
        """The trace id a (possibly just-admitted) request carries, or
        None — same internal-seam access the drain plumbing uses."""
        if request_id is None:
            return None
        with self.server._lock:
            req = self.server._requests.get(request_id)
        trace = getattr(req, 'trace', None)
        return trace.trace_id if trace is not None else None

    @staticmethod
    def _endpoint_label(req: HttpRequest) -> str:
        """Low-cardinality endpoint label: ids stripped, and UNKNOWN
        paths collapse to 'other' — the label feeds a Prometheus family
        whose series are never evicted, so an unauthenticated port sweep
        over arbitrary paths must not mint a series per path."""
        p = req.path
        if p in ('/healthz', '/metrics', '/v1/metrics', '/v1/extract',
                 '/v1/search'):
            return p
        if p.startswith('/v1/requests/'):
            return ('/v1/requests/trace' if p.endswith('/trace')
                    else '/v1/requests')
        if p.startswith('/v1/live/'):
            return '/v1/live'
        return 'other'

    def _route(self, req: HttpRequest, resp: ResponseWriter,
               conn: socket.socket,
               tenant: Tenant) -> Tuple[int, Optional[str]]:
        path, method = req.path, req.method
        if path == '/v1/metrics' and method == 'GET':
            resp.send_json(OK, {'ok': True,
                                'metrics': self.server.metrics()})
            return OK, None
        if path == '/metrics' and method == 'GET':
            text = self.server._prometheus(self.server.metrics())
            resp.send(OK, text.encode('utf-8'),
                      content_type='text/plain; version=0.0.4')
            return OK, None
        if path == '/v1/extract' and method == 'POST':
            return self._handle_extract(req, resp, tenant)
        if path == '/v1/search' and method == 'POST':
            return self._handle_search(req, resp, tenant)
        if path.startswith('/v1/requests/') and path.endswith('/trace') \
                and method == 'GET':
            return self._handle_trace(req, resp, tenant)
        if path.startswith('/v1/requests/') and method == 'GET':
            return self._handle_status(req, resp, tenant)
        if path.startswith('/v1/live/') and method == 'POST':
            return self._handle_live(req, resp, conn, tenant)
        raise HttpError(NOT_FOUND if method in ('GET', 'POST')
                        else METHOD_NOT_ALLOWED,
                        'not_found', f'no route {method} {path}')

    # -- extraction requests --------------------------------------------------

    def _resolve_priority(self, body: Dict[str, Any],
                          tenant: Tenant) -> str:
        from video_features_torch.serve.protocol import PRIORITIES
        priority = body.get('priority') or tenant.priority
        if priority not in PRIORITIES:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'unknown priority {priority!r}; known: '
                            f'{", ".join(PRIORITIES)}')
        if priority == 'interactive' and tenant.priority == 'batch':
            # the key's class is a CAP, not a default: an operator
            # provisions a batch key precisely so saturation sheds it
            # first — a client-side header must not reclaim the
            # interactive headroom that policy protects
            raise HttpError(FORBIDDEN, 'priority_forbidden',
                            f'tenant {tenant.name!r} is provisioned as '
                            "'batch' and cannot request 'interactive'",
                            tenant=tenant.name)
        return priority

    def _check_quota(self, tenant: Tenant, priority: str) -> None:
        ok, reason = self.quota.acquire(tenant)
        if not ok:
            self._count_shed(tenant, priority, reason)
            raise HttpError(
                TOO_MANY_REQUESTS, reason,
                f'tenant {tenant.name!r} is over its '
                + ('request rate' if reason == 'rate_limited'
                   else 'concurrent-request budget'),
                tenant=tenant.name, request_id=None)

    def _submit_error(self, result: Dict[str, Any], tenant: Tenant,
                      priority: str) -> HttpError:
        """Map a serve-side rejection onto a structured HTTP error; a
        queue_full rejection is a SHED (it never occupied a slot)."""
        err = result.get('error', 'rejected')
        if err == 'queue_full':
            self._count_shed(tenant, priority, 'queue_full')
            self.quota.count_shed(tenant)
            return HttpError(SERVICE_UNAVAILABLE, 'queue_full',
                             'admission queue is full for priority '
                             f'class {priority!r}; retry with backoff',
                             tenant=tenant.name, priority=priority,
                             depth=result.get('depth'),
                             capacity=result.get('capacity'))
        if err == 'draining':
            return HttpError(SERVICE_UNAVAILABLE, 'draining', 'server is draining',
                             tenant=tenant.name)
        return HttpError(BAD_REQUEST, 'rejected', str(err), tenant=tenant.name)

    def _handle_extract(self, req: HttpRequest, resp: ResponseWriter,
                        tenant: Tenant) -> Tuple[int, Optional[str]]:
        body = req.json_body(self.max_body_bytes)
        unknown = set(body) - _EXTRACT_FIELDS
        if unknown:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'unknown fields: {sorted(unknown)}')
        priority = self._resolve_priority(body, tenant)
        self._check_quota(tenant, priority)
        try:
            result = self.server.submit(
                body.get('feature_type'), body.get('video_paths'),
                overrides=body.get('overrides'),
                timeout_s=body.get('timeout_s'),
                range_s=body.get('range'), priority=priority,
                traceparent=req.headers.get(_TRACEPARENT_HEADER),
                features=body.get('features'))
        except Exception:
            self.quota.release(tenant.name)
            raise
        if not result.get('ok'):
            self.quota.release(tenant.name)
            raise self._submit_error(result, tenant, priority)
        rid = result['request_id']
        self._own(rid, tenant)
        out = {'ok': True, 'request_id': rid,
               'tenant': tenant.name, 'priority': priority,
               'trace_id': result.get('trace_id')}
        # fused submits answer with the per-family child-id map (and any
        # families rejected mid-fan-out) alongside the umbrella id
        for k in ('requests', 'errors'):
            if k in result:
                out[k] = result[k]
        resp.send_json(OK, out)
        return OK, rid

    def _handle_search(self, req: HttpRequest, resp: ResponseWriter,
                       tenant: Tenant) -> Tuple[int, Optional[str]]:
        """``POST /v1/search`` — the feature-index query surface.
        Same admission layering as extract (auth happened upstream;
        priority cap, then quota) but the concurrency unit is held only
        for the synchronous query, released in ``finally`` — there is
        no completion listener to wait on."""
        body = req.json_body(self.max_body_bytes)
        unknown = set(body) - _SEARCH_FIELDS
        if unknown:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'unknown fields: {sorted(unknown)}')
        svc = self.server.index_service
        if svc is None:
            # shed before admission: a disabled index never spends a
            # quota unit
            raise HttpError(SERVICE_UNAVAILABLE, 'index_disabled',
                            'the feature index is not enabled on this '
                            'server (index_enabled=true)',
                            tenant=tenant.name)
        priority = self._resolve_priority(body, tenant)
        self._check_quota(tenant, priority)
        try:
            if body.get('video_path') is not None:
                result = svc.search_by_video(
                    body['video_path'], features=body.get('features'),
                    k=int(body.get('k', 10)),
                    timeout_s=body.get('timeout_s'), priority=priority,
                    traceparent=req.headers.get(_TRACEPARENT_HEADER))
            else:
                result = svc.search_vector(
                    body.get('family'), body.get('vector'),
                    k=int(body.get('k', 10)))
        except (TypeError, ValueError, KeyError) as e:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'search failed: {e}', tenant=tenant.name)
        finally:
            self.quota.release(tenant.name)
        rid = result.get('request_id')
        if not result.get('ok'):
            raise HttpError(BAD_REQUEST, 'search_failed',
                            str(result.get('error', 'search failed')),
                            tenant=tenant.name, request_id=rid)
        result.pop('ok', None)
        resp.send_json(OK, {'ok': True, 'tenant': tenant.name, **result})
        return OK, rid

    def _handle_trace(self, req: HttpRequest, resp: ResponseWriter,
                      tenant: Tenant) -> Tuple[int, Optional[str]]:
        """``GET /v1/requests/<id>/trace`` — one request's assembled
        span timeline. Tenant-scoped with an EXPLICIT 403 on a foreign
        id (unlike status's 404 ambiguity): traces carry video paths,
        stage timings, and config detail, so a cross-tenant read is an
        authorization failure worth naming. Known tradeoff: with the
        sequential r%06d id space this distinguishes "exists, not
        yours" from "never existed" — a deliberate choice of audit
        clarity over id-space opacity on THIS route only (status keeps
        the uniform 404); revisit if ids ever need to be unguessable."""
        rid = req.path[len('/v1/requests/'):-len('/trace')]
        with self._lock:
            owner = self._owners.get(rid)
        if owner is None:
            raise HttpError(NOT_FOUND, 'not_found',
                            f'unknown request_id {rid!r}',
                            tenant=tenant.name, request_id=rid)
        if owner != tenant.name:
            raise HttpError(FORBIDDEN, 'forbidden',
                            f'request {rid!r} belongs to another tenant',
                            tenant=tenant.name, request_id=rid)
        tr = self.server.request_trace(rid)
        if not tr.get('ok'):
            raise HttpError(NOT_FOUND, 'not_found',
                            tr.get('error', f'unknown request {rid!r}'),
                            tenant=tenant.name, request_id=rid)
        tr.pop('ok', None)
        tr['tenant'] = tenant.name
        resp.send_json(OK, {'ok': True, **tr})
        return OK, rid

    def _handle_status(self, req: HttpRequest, resp: ResponseWriter,
                       tenant: Tenant) -> Tuple[int, Optional[str]]:
        rid = req.path[len('/v1/requests/'):]
        with self._lock:
            owner = self._owners.get(rid)
        if owner != tenant.name:
            # someone else's request id is indistinguishable from an
            # unknown one — the id space must not leak across tenants
            raise HttpError(NOT_FOUND, 'not_found',
                            f'unknown request_id {rid!r}',
                            tenant=tenant.name, request_id=rid)
        st = self.server.status(rid)
        if not st.get('ok'):
            raise HttpError(NOT_FOUND, 'not_found',
                            st.get('error', f'unknown request {rid!r}'),
                            tenant=tenant.name, request_id=rid)
        st.pop('ok', None)
        st['tenant'] = tenant.name
        resp.send_json(OK, {'ok': True, **st})
        return OK, rid

    # -- live sessions ---------------------------------------------------------

    def _handle_live(self, req: HttpRequest, resp: ResponseWriter,
                     conn: socket.socket,
                     tenant: Tenant) -> Tuple[int, Optional[str]]:
        sid = req.path[len('/v1/live/'):]
        if not sid or '/' in sid or len(sid) > 128:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'malformed session id {sid!r}')
        chunks = req.iter_chunks(self.max_body_bytes)
        try:
            header_raw = next(chunks)
        except StopIteration:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'live session body must start with a JSON '
                            'header chunk')
        try:
            header = json.loads(header_raw.decode('utf-8'))
        except (ValueError, UnicodeDecodeError) as e:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'malformed live-session header: {e}')
        unknown = set(header) - _LIVE_FIELDS
        if unknown:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'unknown header fields: {sorted(unknown)}')
        priority = self._resolve_priority(header, tenant)
        try:
            session = LiveSession(
                sid, tenant.name, fps=float(header.get('fps', 25.0)),
                idle_flush_s=self.server.idle_flush_s)
        except (LiveSessionError, TypeError, ValueError) as e:
            raise HttpError(BAD_REQUEST, 'bad_request', str(e))

        # duplicate in-flight session ids are REJECTED: two writers on
        # one session id would interleave frames into one window stream
        with self._lock:
            if sid in self._live:
                raise HttpError(
                    CONFLICT, 'duplicate_session',
                    f'live session {sid!r} is already in flight',
                    tenant=tenant.name, session=sid)
            self._live[sid] = session
        self._g_live.set(len(self._live))

        rid = None
        try:
            self._check_quota(tenant, priority)
            released = False
            try:
                session.attach_writer(resp)
                result = self.server.submit_live(
                    header.get('feature_type'), session,
                    overrides=header.get('overrides'),
                    timeout_s=header.get('timeout_s'),
                    priority=priority,
                    traceparent=req.headers.get(_TRACEPARENT_HEADER))
                if not result.get('ok'):
                    released = True
                    self.quota.release(tenant.name)
                    raise self._submit_error(result, tenant, priority)
                rid = result['request_id']
                self._own(rid, tenant)
                with self._lock:
                    self._live_by_request[rid] = session
                st0 = self.server.status(rid)
                if st0.get('ok') and st0.get('state') != 'running':
                    # terminal before we registered (e.g. instant crash
                    # path): abort the input side — no scheduler will
                    # ever drain the frame queue, so a client still
                    # streaming would wedge push() — and skip the
                    # finalize wait below
                    session.abort()
                    session.done.set()
            except BaseException:
                if not released and rid is None:
                    self.quota.release(tenant.name)
                raise

            resp.start_chunked(OK)
            resp.write_chunk((json.dumps(
                {'ok': True, 'request_id': rid, 'session': sid,
                 'tenant': tenant.name}) + '\n').encode('utf-8'))

            # stream frames up; windows stream back concurrently via
            # session.send_window on the device-loop thread
            conn.settimeout(LIVE_IDLE_TIMEOUT_S)
            error: Optional[str] = None
            try:
                for chunk in chunks:
                    session.push(decode_frame_chunk(chunk))
                session.end_input()
            except (HttpError, LiveSessionError) as e:
                error = str(e)
                session.abort()
            except (OSError, ConnectionError, socket.timeout):
                error = 'client stream ended unexpectedly'
                session.abort()

            session.done.wait(LIVE_FINALIZE_TIMEOUT_S)
            st = self.server.status(rid)
            final = {'done': True, 'request_id': rid, 'session': sid,
                     'tenant': tenant.name,
                     'windows': session.windows_streamed,
                     'frames': session.frames_in,
                     'state': st.get('state', 'unknown')}
            if error:
                final['error'] = error
            try:
                resp.write_chunk((json.dumps(final) + '\n')
                                 .encode('utf-8'))
                resp.end_chunked()
            except (OSError, ValueError):
                pass
            return OK, rid
        finally:
            session.abort()
            with self._lock:
                self._live.pop(sid, None)
                if rid is not None:
                    self._live_by_request.pop(rid, None)
            self._g_live.set(len(self._live))
