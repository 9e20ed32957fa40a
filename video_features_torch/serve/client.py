"""Thin client for the warm-pool extraction service (the port's copy of
``video_features_tpu/serve/client.py``, unchanged in behaviour: it talks
to either package's daemon).

One connection per call (submit/status/metrics are sub-millisecond
against a loopback endpoint — holding a pooled connection buys nothing
and would add reconnect logic); ``wait`` polls status. Raises
:class:`ServeError` for any ``ok: false`` response so callers get Python
exceptions, not dicts to inspect.
"""
from __future__ import annotations

import random
import socket
import time
from typing import Any, Dict, List, Optional

from video_features_torch.serve import protocol


class ServeError(RuntimeError):
    """The server answered ``ok: false`` (the message is the reason).

    ``code`` (wire 1.4) is the STRUCTURED failure class — one of the
    ``protocol.ERR_*`` constants, or None from a pre-1.4 server. The
    fleet router's failover switch keys on it exclusively: ``shed``,
    ``connect_refused``, and ``deadline`` are retry-next-host;
    everything else propagates. ``extra`` carries the response's other
    fields (``depth``/``capacity`` on queue_full, …) verbatim."""

    def __init__(self, message: str, code: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(message)
        self.code = code
        self.extra = dict(extra) if extra else {}

    @property
    def retryable(self) -> bool:
        """True when a DIFFERENT backend could plausibly accept this
        request (this host shed it, refused the connect, or sat on it
        past the deadline) — the one bit the router's failover needs."""
        return self.code in (protocol.ERR_SHED,
                             protocol.ERR_CONNECT_REFUSED,
                             protocol.ERR_DEADLINE)


class ServeConnectError(ServeError, ConnectionRefusedError):
    """No listener answered within ``connect_timeout_s`` (code
    ``connect_refused``). Also a :class:`ConnectionRefusedError` so
    pre-1.4 callers catching the OS exception keep working."""

    def __init__(self, message: str) -> None:
        ServeError.__init__(self, message,
                            code=protocol.ERR_CONNECT_REFUSED)


class ServeDeadlineError(ServeError, TimeoutError):
    """The request outlived the caller's wait deadline (code
    ``deadline``). Also a :class:`TimeoutError` for pre-1.4 callers."""

    def __init__(self, message: str) -> None:
        ServeError.__init__(self, message, code=protocol.ERR_DEADLINE)


class ServeClient:
    """``connect_timeout_s`` is a DEADLINE, not a single attempt: a
    refused connect (daemon still warming up, supervisor restart window)
    retries with bounded exponential backoff + jitter until the deadline
    passes — so ``start daemon & client.submit(...)`` just works without
    the caller hand-rolling a poll loop. Unreachable-host errors
    (timeouts, routing) are NOT retried; only connection-refused is,
    because that is the one error a late-binding listener cures.

    Every message carries the protocol version (``v``). Compatibility is
    deliberately one-way: an OLD client against a NEW server keeps
    working (missing ``v`` = v1), while a NEW client against a
    pre-versioning server fails LOUDLY on submit (its strict field check
    rejects ``v`` with a structured error naming the field) — the
    version field must flow for major-version negotiation to exist at
    all, and a clear rejection beats silently dropping the handshake."""

    # backoff: 50ms doubling to 1s, each delay jittered ±50% so a
    # thundering herd of clients doesn't re-refuse in lockstep
    _BACKOFF_BASE_S = 0.05
    _BACKOFF_CAP_S = 1.0

    def __init__(self, port: int, host: str = '127.0.0.1',
                 connect_timeout_s: float = 10.0) -> None:
        self.host, self.port = host, int(port)
        self.connect_timeout_s = connect_timeout_s

    def _connect(self) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout_s
        delay = self._BACKOFF_BASE_S
        while True:
            remaining = deadline - time.monotonic()
            try:
                conn = socket.create_connection(
                    (self.host, self.port), timeout=max(remaining, 0.001))
                conn.settimeout(None)         # extraction can take a while
                return conn
            except ConnectionRefusedError:
                if time.monotonic() + delay >= deadline:
                    raise ServeConnectError(
                        f'connect to {self.host}:{self.port} refused for '
                        f'{self.connect_timeout_s}s') from None
                # clamp the jittered sleep to the remaining budget so
                # the deadline is honored even at the jitter's top end
                time.sleep(max(0.0, min(delay * random.uniform(0.5, 1.5),
                                        deadline - time.monotonic())))
                delay = min(delay * 2, self._BACKOFF_CAP_S)

    @staticmethod
    def _read_response(rfile) -> Dict[str, Any]:
        line = rfile.readline()
        if not line:
            # a mid-request connection loss looks exactly like a shed to
            # the caller's retry logic: another host may well accept it
            raise ServeError('server closed the connection',
                             code=protocol.ERR_SHED)
        resp = protocol.decode(line)
        if not resp.get('ok'):
            raise ServeError(resp.get('error', 'unknown server error'),
                             code=resp.get('code'),
                             extra={k: v for k, v in resp.items()
                                    if k not in ('ok', 'error', 'code')})
        return resp

    def _call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        msg.setdefault('v', protocol.VERSION)
        with self._connect() as conn:
            conn.sendall(protocol.encode(msg))
            with conn.makefile('rb') as rfile:
                return self._read_response(rfile)

    # -- commands ------------------------------------------------------------

    def ping(self) -> bool:
        return bool(self._call({'cmd': protocol.CMD_PING}).get('ok'))

    def submit(self, feature_type: Optional[str], video_paths: List[str],
               overrides: Optional[Dict[str, Any]] = None,
               timeout_s: Optional[float] = None,
               range_s: Optional[List[float]] = None,
               priority: Optional[str] = None,
               traceparent: Optional[str] = None,
               features: Optional[List[str]] = None) -> str:
        """Enqueue one extraction request; returns its request_id.
        Raises :class:`ServeError` on rejection (queue_full, draining,
        invalid config, …) — backpressure is the caller's to handle.
        ``range_s=[start_s, end_s]`` makes it a segment query (only the
        covered windows decode; outputs named ``_seg<a>-<b>ms``);
        ``priority`` ('interactive' | 'batch') feeds admission — a
        saturated queue sheds batch before interactive; ``traceparent``
        (W3C ``00-<trace>-<span>-<flags>``) joins the request to a
        caller-owned distributed trace (minted server-side otherwise);
        ``features=['i3d', 'clip', ...]`` (v1.2) submits a FUSED
        multi-family request — one umbrella request_id (returned) with
        per-family children, ``feature_type`` ignored; family-scoped
        override keys spell ``<family>.<knob>``."""
        msg: Dict[str, Any] = {'cmd': protocol.CMD_SUBMIT,
                               'feature_type': feature_type,
                               'video_paths': list(video_paths)}
        if features is not None:
            msg['features'] = list(features)
        if overrides:
            msg['overrides'] = dict(overrides)
        if timeout_s is not None:
            msg['timeout_s'] = float(timeout_s)
        if range_s is not None:
            msg['range'] = [float(range_s[0]), float(range_s[1])]
        if priority is not None:
            msg['priority'] = str(priority)
        if traceparent is not None:
            msg['traceparent'] = str(traceparent)
        return self._call(msg)['request_id']

    def status(self, request_id: str) -> Dict[str, Any]:
        return self._call({'cmd': protocol.CMD_STATUS,
                           'request_id': request_id})

    def trace(self, request_id: str) -> Dict[str, Any]:
        """The request's assembled span timeline: ``{request_id,
        trace_id, state, events}`` — every recorded span/instant across
        the server's live recorders carrying the request's trace id
        (requires the server to run with a ``trace_out`` base override;
        empty otherwise). Against the fleet router (v1.5) the assembly
        is scatter-gather: router spans plus every attempted backend's
        spans, ts-sorted under one trace_id, each event stamped with a
        ``host`` attr and the additive ``hosts`` field listing the
        contributors."""
        return self._call({'cmd': protocol.CMD_TRACE,
                           'request_id': request_id})

    def wait(self, request_id: str, timeout_s: float = 300.0,
             poll_s: float = 0.05) -> Dict[str, Any]:
        """Block until the request reaches a terminal state; returns the
        final status snapshot. Polls over ONE persistent connection — the
        protocol is request/response per line, and a waiter reconnecting
        20×/s would make the server churn a handler thread per poll."""
        deadline = time.monotonic() + timeout_s
        with self._connect() as conn:
            rfile = conn.makefile('rb')
            while True:
                conn.sendall(protocol.encode(
                    {'cmd': protocol.CMD_STATUS,
                     'request_id': request_id}))
                st = self._read_response(rfile)
                if st['state'] != 'running':
                    return st
                if time.monotonic() >= deadline:
                    raise ServeDeadlineError(
                        f'request {request_id} still {st["state"]} after '
                        f'{timeout_s}s: {st}')
                time.sleep(poll_s)

    def search(self, family: Optional[str] = None,
               vector: Optional[List[float]] = None,
               video_path: Optional[str] = None,
               features: Optional[List[str]] = None,
               k: int = 10,
               timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Query the feature index (v1.3; requires ``index_enabled``).
        By vector: pass ``family`` + ``vector`` → ``{hits: [...]}``. By
        video: pass ``video_path`` + ``features`` → the server extracts
        through the fused path, waits for ingest, and answers
        ``{results: {family: [hits]}}``; each hit is ``{score, video,
        video_sha256, t_ms, key, family}``."""
        msg: Dict[str, Any] = {'cmd': protocol.CMD_SEARCH, 'k': int(k)}
        if family is not None:
            msg['family'] = str(family)
        if vector is not None:
            msg['vector'] = list(vector)
        if video_path is not None:
            msg['video_path'] = str(video_path)
        if features is not None:
            msg['features'] = list(features)
        if timeout_s is not None:
            msg['timeout_s'] = float(timeout_s)
        return self._call(msg)

    def index_status(self) -> Dict[str, Any]:
        """The index section of the metrics document (rows, shards,
        ingest lag, query-program residency) — v1.3."""
        return self._call({'cmd': protocol.CMD_INDEX_STATUS})['index']

    def metrics(self) -> Dict[str, Any]:
        return self._call({'cmd': protocol.CMD_METRICS})['metrics']

    def metrics_prom(self) -> str:
        """The same state as Prometheus text exposition format 0.0.4.
        Against the fleet router (v1.5): the fleet-aggregated exposition
        — every backend's families relabeled ``host=`` plus the
        router's own ``vft_fleet_*`` / ``vft_slo_*`` families."""
        return self._call({'cmd': protocol.CMD_METRICS_PROM})['text']

    def drain(self) -> None:
        """Ask the server to drain (finish queued work, then exit)."""
        self._call({'cmd': protocol.CMD_DRAIN})
