"""Minimal HTTP/1.1 transport for the ingress, stdlib only (the port's
copy of ``video_features_tpu/ingress/http.py``).

One request per connection (``Connection: close``) — the endpoint fronts
multi-second extraction requests and long-lived live sessions, so
keep-alive buys nothing and drops a whole class of pipelining bugs. The
pieces the gateway composes:

  * :func:`read_request` — request-line + header framing with hard
    bounds; an oversized declared body is rejected with a STRUCTURED
    413-style error (:class:`HttpError`) before a byte of it is read,
    instead of crashing (or OOMing) the reader;
  * :func:`read_chunked` / :func:`iter_chunks` — chunked request bodies
    (live sessions stream frames up in chunks);
  * :class:`ResponseWriter` — fixed and chunked responses; chunk writes
    are lock-serialized because live sessions write from two threads
    (the handler streaming status + the device loop streaming windows);
  * :class:`HttpServer` — accept loop with a bounded handler pool
    (excess connections get an immediate 503) and a two-phase drain:
    ``begin_drain`` stops accepting, ``finish_drain`` force-closes
    whatever half-open connections remain so no abandoned client pins a
    handler thread (or a warm-pool entry) past shutdown.
"""
from __future__ import annotations

import json
import socket
import threading
from typing import Any, Callable, Dict, Iterator, Optional
from urllib.parse import parse_qs, unquote, urlsplit

MAX_REQUEST_LINE = 8192
MAX_HEADER_BYTES = 32768
MAX_HEADERS = 100

# The named status vocabulary of the ingress wire: every status an
# ingress module emits comes from these names, the JAX package's (its
# WIRE.lock.json pins each route's set).
OK = 200
BAD_REQUEST = 400
UNAUTHORIZED = 401
FORBIDDEN = 403
NOT_FOUND = 404
METHOD_NOT_ALLOWED = 405
CONFLICT = 409
PAYLOAD_TOO_LARGE = 413
TOO_MANY_REQUESTS = 429
HEADERS_TOO_LARGE = 431
# nginx convention: the client went away mid-request — never sent on
# the wire, only a metrics label (vft_ingress_requests_total{code=})
CLIENT_CLOSED = 499
INTERNAL_ERROR = 500
SERVICE_UNAVAILABLE = 503

# HTTP status → reason phrases we actually emit (write-once)
_REASONS = {OK: 'OK', BAD_REQUEST: 'Bad Request',
            UNAUTHORIZED: 'Unauthorized',
            FORBIDDEN: 'Forbidden', NOT_FOUND: 'Not Found',
            METHOD_NOT_ALLOWED: 'Method Not Allowed',
            CONFLICT: 'Conflict', PAYLOAD_TOO_LARGE: 'Payload Too Large',
            TOO_MANY_REQUESTS: 'Too Many Requests',
            HEADERS_TOO_LARGE: 'Request Header Fields Too Large',
            INTERNAL_ERROR: 'Internal Server Error',
            SERVICE_UNAVAILABLE: 'Service Unavailable'}


class HttpError(Exception):
    """A request-level failure with a structured JSON body: ``status``
    is the HTTP code, ``code`` a machine-readable slug (``body_too_
    large``, ``bad_request`` …), ``extra`` rides into the body."""

    def __init__(self, status: int, code: str, message: str,
                 **extra: Any) -> None:
        super().__init__(message)
        self.status = status
        self.code = code
        self.extra = dict(extra)

    def body(self) -> Dict[str, Any]:
        out = {'ok': False, 'error': self.code, 'message': str(self)}
        out.update(self.extra)
        return out


class HttpRequest:
    """One parsed request head; the body stays ON THE WIRE until the
    handler asks for it (``read_body`` / ``iter_chunks``), so a rejected
    request never pays for — or buffers — its payload."""

    def __init__(self, method: str, target: str, rfile,
                 headers: Dict[str, str]) -> None:
        self.method = method
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self.query: Dict[str, str] = {
            k: v[-1] for k, v in parse_qs(parts.query).items()}
        self.headers = headers
        self._rfile = rfile

    @property
    def chunked(self) -> bool:
        return 'chunked' in self.headers.get('transfer-encoding',
                                             '').lower()

    def content_length(self) -> Optional[int]:
        raw = self.headers.get('content-length')
        if raw is None:
            return None
        try:
            n = int(raw)
        except ValueError:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'malformed Content-Length {raw!r}')
        if n < 0:
            raise HttpError(BAD_REQUEST, 'bad_request', 'negative Content-Length')
        return n

    def read_body(self, max_bytes: int) -> bytes:
        """The whole (non-chunked) body, bounded. The bound is checked
        against the DECLARED length first — an over-limit body is
        rejected without reading it."""
        if self.chunked:
            return read_chunked(self._rfile, max_bytes)
        n = self.content_length() or 0
        if n > max_bytes:
            raise HttpError(PAYLOAD_TOO_LARGE, 'body_too_large',
                            f'request body is {n} bytes; the ingress '
                            f'accepts at most {max_bytes}',
                            max_bytes=max_bytes, got_bytes=n)
        body = self._rfile.read(n) if n else b''
        if len(body) != n:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'connection closed mid-body')
        return body

    def json_body(self, max_bytes: int) -> Dict[str, Any]:
        body = self.read_body(max_bytes)
        if not body:
            return {}
        try:
            obj = json.loads(body.decode('utf-8'))
        except (ValueError, UnicodeDecodeError) as e:
            raise HttpError(BAD_REQUEST, 'bad_request', f'malformed JSON body: {e}')
        if not isinstance(obj, dict):
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'request body must be a JSON object')
        return obj

    def iter_chunks(self, max_chunk_bytes: int) -> Iterator[bytes]:
        """The chunked body, one wire chunk at a time (live sessions:
        each chunk is one client message). Ends after the zero-length
        terminator chunk."""
        if not self.chunked:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'this endpoint requires Transfer-Encoding: '
                            'chunked')
        return iter_chunks(self._rfile, max_chunk_bytes)


def read_request(rfile) -> Optional[HttpRequest]:
    """Parse one request head off ``rfile``; None on a cleanly closed
    connection (client connected and went away without sending)."""
    line = rfile.readline(MAX_REQUEST_LINE + 1)
    if not line:
        return None
    if len(line) > MAX_REQUEST_LINE:
        raise HttpError(BAD_REQUEST, 'bad_request', 'request line too long')
    try:
        method, target, version = line.decode('latin-1').split()
    except ValueError:
        raise HttpError(BAD_REQUEST, 'bad_request',
                        f'malformed request line {line!r}')
    if not version.startswith('HTTP/1.'):
        raise HttpError(BAD_REQUEST, 'bad_request',
                        f'unsupported HTTP version {version!r}')
    headers: Dict[str, str] = {}
    total = 0
    for _ in range(MAX_HEADERS + 1):
        raw = rfile.readline(MAX_HEADER_BYTES + 1)
        total += len(raw)
        if total > MAX_HEADER_BYTES:
            raise HttpError(HEADERS_TOO_LARGE, 'headers_too_large',
                            'header block too large')
        if raw in (b'\r\n', b'\n', b''):
            break
        try:
            name, _, value = raw.decode('latin-1').partition(':')
        except UnicodeDecodeError:
            raise HttpError(BAD_REQUEST, 'bad_request', 'undecodable header')
        headers[name.strip().lower()] = value.strip()
    else:
        raise HttpError(BAD_REQUEST, 'bad_request', 'too many headers')
    return HttpRequest(method.upper(), target, rfile, headers)


def read_chunked(rfile, max_bytes: int) -> bytes:
    """Assemble a whole chunked body, bounded at ``max_bytes`` TOTAL."""
    out = []
    total = 0
    for chunk in iter_chunks(rfile, max_bytes):
        total += len(chunk)
        if total > max_bytes:
            raise HttpError(PAYLOAD_TOO_LARGE, 'body_too_large',
                            f'chunked body exceeded {max_bytes} bytes',
                            max_bytes=max_bytes)
        out.append(chunk)
    return b''.join(out)


def iter_chunks(rfile, max_chunk_bytes: int) -> Iterator[bytes]:
    """Yield each wire chunk of a chunked body; stops after the
    terminator. A single chunk larger than ``max_chunk_bytes`` is a
    structured 413 — the reader never buffers unbounded client input."""
    while True:
        size_line = rfile.readline(64)
        if not size_line:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'connection closed mid-chunked-body')
        if not size_line.endswith(b'\n'):
            # readline hit its bound mid-line (an over-long chunk
            # extension): parsing the size anyway would leave the line's
            # tail to be consumed as payload — misframed forever after
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'chunk-size line too long')
        try:
            size = int(size_line.split(b';', 1)[0].strip(), 16)
        except ValueError:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'malformed chunk size {size_line!r}')
        if size < 0:
            # int(_, 16) happily parses '-1'; rfile.read(-1) would then
            # buffer to EOF — the exact unbounded read the max-chunk
            # bound exists to prevent
            raise HttpError(BAD_REQUEST, 'bad_request',
                            f'negative chunk size {size_line!r}')
        if size > max_chunk_bytes:
            raise HttpError(PAYLOAD_TOO_LARGE, 'body_too_large',
                            f'chunk of {size} bytes exceeds the '
                            f'{max_chunk_bytes}-byte bound',
                            max_bytes=max_chunk_bytes, got_bytes=size)
        if size == 0:
            rfile.readline(8)           # trailing CRLF (no trailers)
            return
        data = rfile.read(size)
        if len(data) != size:
            raise HttpError(BAD_REQUEST, 'bad_request',
                            'connection closed mid-chunk')
        rfile.readline(8)               # chunk's trailing CRLF
        yield data


class ResponseWriter:
    """Serialized writes onto one connection's ``wfile``.

    The lock matters for live sessions: the device loop streams window
    chunks from a worker thread while the handler thread owns the final
    chunk — interleaved partial writes would corrupt the chunk framing.
    """

    def __init__(self, wfile) -> None:
        self._wfile = wfile
        self._lock = threading.Lock()
        self.started = False
        self._chunked = False

    def _head(self, status: int, headers: Dict[str, str]) -> bytes:
        lines = [f'HTTP/1.1 {status} {_REASONS.get(status, "Unknown")}']
        lines += [f'{k}: {v}' for k, v in headers.items()]
        lines += ['Connection: close', '', '']
        return '\r\n'.join(lines).encode('latin-1')

    def send(self, status: int, body: bytes,
             content_type: str = 'application/json') -> None:
        with self._lock:
            if self.started:
                return
            self.started = True
            self._wfile.write(self._head(status, {
                'Content-Type': content_type,
                'Content-Length': str(len(body))}) + body)
            self._wfile.flush()

    def send_json(self, status: int, obj: Dict[str, Any]) -> None:
        self.send(status, json.dumps(obj).encode('utf-8') + b'\n')

    def start_chunked(self, status: int = 200,
                      content_type: str = 'application/json') -> None:
        with self._lock:
            if self.started:
                return
            self.started = True
            self._chunked = True
            self._wfile.write(self._head(status, {
                'Content-Type': content_type,
                'Transfer-Encoding': 'chunked'}))
            self._wfile.flush()

    def write_chunk(self, data: bytes) -> None:
        if not data:
            return
        with self._lock:
            if not self._chunked:
                raise RuntimeError('start_chunked first')
            self._wfile.write(b'%x\r\n' % len(data) + data + b'\r\n')
            self._wfile.flush()

    def end_chunked(self) -> None:
        with self._lock:
            if not self._chunked:
                return
            self._chunked = False
            self._wfile.write(b'0\r\n\r\n')
            self._wfile.flush()


class HttpServer:
    """Accept loop + bounded handler pool + two-phase drain.

    ``handler(request, response, conn)`` runs on its own thread per
    connection; at ``max_connections`` concurrent handlers, further
    connects get an immediate 503 (shed at the transport, before any
    parsing). Every live connection is tracked so ``finish_drain`` can
    force-close stragglers — an abandoned half-open client never pins a
    handler thread past the serve daemon's drain grace.
    """

    def __init__(self, handler: Callable, host: str = '127.0.0.1',
                 port: int = 0, max_connections: int = 64) -> None:
        self.handler = handler
        self.host, self._port_req = host, int(port)
        self.max_connections = int(max_connections)
        self._sock: Optional[socket.socket] = None
        self._conns: set = set()
        self._lock = threading.Lock()
        self._active = 0
        self._draining = False
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._sock is not None, 'ingress not started'
        return self._sock.getsockname()[1]

    @property
    def open_connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def start(self) -> 'HttpServer':
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._port_req))
        self._sock.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='ingress-accept', daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                     # socket closed: draining
            with self._lock:
                if self._draining:
                    reject = 'draining'
                elif self._active >= self.max_connections:
                    reject = 'overloaded'
                else:
                    reject = None
                    self._active += 1
                    self._conns.add(conn)
            if reject is not None:
                threading.Thread(target=self._reject,
                                 args=(conn, reject), daemon=True).start()
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name='ingress-conn', daemon=True).start()

    def _reject(self, conn: socket.socket,
                reason: str = 'overloaded') -> None:
        """503 with an honest reason: 'overloaded' (retry with backoff)
        vs 'draining' (fail over — this process is exiting; a client
        retrying against it is wasting its own deadline)."""
        try:
            with conn:
                message = ('server is draining; fail over'
                           if reason == 'draining'
                           else 'connection limit reached; retry with '
                                'backoff')
                body = json.dumps({
                    'ok': False, 'error': reason,
                    'message': message}).encode() + b'\n'
                conn.sendall(
                    b'HTTP/1.1 503 Service Unavailable\r\n'
                    b'Content-Type: application/json\r\n'
                    b'Content-Length: %d\r\nConnection: close\r\n\r\n'
                    % len(body) + body)
        except OSError:
            pass

    # no byte read/written for this long → the connection is torn down
    # (slowloris guard: a silent client must not pin a handler slot —
    # the live endpoint RAISES the timeout after auth, it never waives
    # it)
    READ_TIMEOUT_S = 30.0

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(self.READ_TIMEOUT_S)
                rfile = conn.makefile('rb')
                wfile = conn.makefile('wb')
                resp = ResponseWriter(wfile)
                try:
                    req = read_request(rfile)
                    if req is not None:
                        self.handler(req, resp, conn)
                except HttpError as e:
                    # transport-level rejection (413/400/…): structured
                    # body, never a dropped connection mid-parse
                    try:
                        resp.send_json(e.status, e.body())
                    except (OSError, ValueError):
                        pass
                except (OSError, ValueError, ConnectionError):
                    pass                   # client went away
                except Exception as e:
                    # reported to the client as a structured 500; the
                    # connection loop survives one handler's crash
                    try:
                        resp.send_json(INTERNAL_ERROR, {
                            'ok': False, 'error': 'internal',
                            'message': f'{type(e).__name__}: {e}'})
                    except (OSError, ValueError):
                        pass
        finally:
            with self._lock:
                self._active -= 1
                self._conns.discard(conn)

    # -- drain ---------------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop accepting; in-flight handlers keep running."""
        with self._lock:
            self._draining = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def finish_drain(self, grace_s: float = 5.0) -> None:
        """Force-close every connection still open after ``grace_s`` —
        the half-open-reap: a client that vanished mid-request (or never
        finished its live stream) must not pin a handler thread."""
        import time
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._conns:
                    return
            time.sleep(0.05)
        with self._lock:
            stragglers = list(self._conns)
        for conn in stragglers:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
