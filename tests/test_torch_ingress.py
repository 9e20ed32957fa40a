"""The port's network front door (video_features_torch/ingress/) and the
segment and live paths beneath it, on the CPU: one case for each case of
tests/test_ingress.py (transport bounds, tenants and quotas, segment
queries, live sessions, drain), the windowers against the JAX package's
over seeded cases, and the port's gateway against the JAX gateway on one
seeded checkpoint and clip (rel L2 <= 1e-5 per key, the same file names
and cache keys; live rows against the JAX session's and against the
port's file-backed run of the same frames), in process and through the
decode farm."""
import io
import json
import pickle
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.utils.output import make_path

API_KEY = 'test-key-interactive'
BATCH_KEY = 'test-key-batch'
LIMITED_KEY = 'test-key-limited'
REL_L2 = 1e-5
# the families of the JAX parity cases, at the sizes of
# tests/test_torch_packing.py (i3d: the rgb tower alone)
PARITY = {
    'resnet': dict(model_name='resnet18', batch_size=4),
    'i3d': dict(streams='rgb', stack_size=10, step_size=10, batch_size=2,
                concat_rgb_flow=False),
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# -- units ------------------------------------------------------------------------


def test_token_bucket_and_quota_manager():
    from video_features_torch.ingress.auth import Tenant
    from video_features_torch.ingress.quota import QuotaManager, TokenBucket

    assert TokenBucket(None, 1).try_acquire()       # unlimited
    q = QuotaManager()
    slow = Tenant('slow', rate_rps=0.001, burst=2)
    assert q.acquire(slow) == (True, None)
    assert q.acquire(slow) == (True, None)
    assert q.acquire(slow) == (False, 'rate_limited')
    one = Tenant('one', max_concurrent=1)
    assert q.acquire(one) == (True, None)
    assert q.acquire(one) == (False, 'concurrency')
    q.release('one')
    assert q.acquire(one) == (True, None)
    snap = q.snapshot()
    assert snap['slow']['shed'] == 1 and snap['one']['shed'] == 1
    assert snap['one']['inflight'] == 1


def test_auth_file_parsing_and_header_auth(tmp_path):
    from video_features_torch.ingress.auth import ApiKeyAuth

    p = tmp_path / 'keys.json'
    p.write_text(json.dumps({'keys': {
        'k1': {'tenant': 'acme', 'priority': 'batch', 'rate_rps': 10},
        'k2': {'tenant': 'acme', 'priority': 'batch', 'rate_rps': 10},
        'k3': {'tenant': 'zeta', 'max_concurrent': 2},
    }}))
    auth = ApiKeyAuth.from_file(str(p))
    assert auth.n_tenants == 2
    t = auth.authenticate({'authorization': 'Bearer k1'})
    assert t.name == 'acme' and t.priority == 'batch'
    assert auth.authenticate({'x-api-key': 'k3'}).name == 'zeta'
    assert auth.authenticate({'authorization': 'Bearer nope'}) is None
    assert auth.authenticate({}) is None
    # the flat YAML form
    y = tmp_path / 'keys.yml'
    y.write_text('kY:\n  tenant: yak\n  rate_rps: 2\n  burst: 3\n')
    yak = ApiKeyAuth.from_file(str(y)).authenticate({'x-api-key': 'kY'})
    assert (yak.name, yak.rate_rps, yak.burst) == ('yak', 2.0, 3.0)

    bad = tmp_path / 'conflict.json'
    bad.write_text(json.dumps({'keys': {
        'kA': {'tenant': 'acme', 'rate_rps': 5},
        'kB': {'tenant': 'acme', 'rate_rps': 500}}}))
    with pytest.raises(ValueError, match='conflicting policies'):
        ApiKeyAuth.from_file(str(bad))
    bad.write_text(json.dumps({'keys': {'k': {'priority': 'interactive'}}}))
    with pytest.raises(ValueError, match='no tenant'):
        ApiKeyAuth.from_file(str(bad))
    bad.write_text(json.dumps({'keys': {'k': {'tenant': 't', 'shoe_size': 9}}}))
    with pytest.raises(ValueError, match='unknown fields'):
        ApiKeyAuth.from_file(str(bad))


def test_http_oversized_body_is_structured_413():
    import http.client

    from video_features_torch.ingress.http import HttpServer

    def handler(req, resp, conn):
        if req.chunked:
            for _ in req.iter_chunks(max_chunk_bytes=64):
                pass
        else:
            req.read_body(max_bytes=128)
        resp.send_json(200, {'ok': True})

    srv = HttpServer(handler).start()
    try:
        c = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=10)
        c.request('POST', '/x', body=b'y' * 1024)
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 413 and body['error'] == 'body_too_large'
        assert body['max_bytes'] == 128 and body['got_bytes'] == 1024

        s = socket.create_connection(('127.0.0.1', srv.port), timeout=10)
        s.sendall(b'POST /x HTTP/1.1\r\nHost: a\r\n'
                  b'Transfer-Encoding: chunked\r\n\r\n')
        s.sendall(b'%x\r\n%s\r\n' % (4096, b'z' * 4096))
        resp = s.makefile('rb').read()
        assert b'413' in resp.split(b'\r\n', 1)[0] and b'body_too_large' in resp

        s2 = socket.create_connection(('127.0.0.1', srv.port), timeout=10)
        s2.sendall(b'POST /x HTTP/1.1\r\nHost: a\r\n'
                   b'Transfer-Encoding: chunked\r\n\r\n-1\r\n' + b'y' * 1024)
        resp2 = s2.makefile('rb').read()
        assert b'400' in resp2.split(b'\r\n', 1)[0]
        assert b'negative chunk size' in resp2

        # an oversized header block is a structured 431
        s3 = socket.create_connection(('127.0.0.1', srv.port), timeout=10)
        s3.sendall(b'GET /x HTTP/1.1\r\n'
                   + b''.join(b'X-%d: %s\r\n' % (i, b'v' * 1000)
                              for i in range(40)) + b'\r\n')
        resp3 = s3.makefile('rb').read()
        assert b'431' in resp3.split(b'\r\n', 1)[0]
        assert b'headers_too_large' in resp3
    finally:
        srv.begin_drain()
        srv.finish_drain(grace_s=1.0)


def test_connection_cap_and_draining_answer_structured_503():
    """One connection more than ``max_connections`` is answered 503
    ``overloaded`` before it is parsed; after ``begin_drain`` nothing is
    accepted, and ``finish_drain`` force-closes a held connection."""
    from video_features_torch.ingress.http import HttpServer
    release = threading.Event()

    def handler(req, resp, conn):
        release.wait(10)
        resp.send_json(200, {'ok': True})

    srv = HttpServer(handler, max_connections=1).start()
    try:
        held = socket.create_connection(('127.0.0.1', srv.port), timeout=10)
        held.sendall(b'GET /a HTTP/1.1\r\nHost: a\r\n\r\n')
        deadline = time.monotonic() + 10
        while srv.open_connections < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        extra = socket.create_connection(('127.0.0.1', srv.port), timeout=10)
        answer = extra.makefile('rb').read()
        assert b'503' in answer.split(b'\r\n', 1)[0]
        assert json.loads(answer.split(b'\r\n\r\n', 1)[1])['error'] == 'overloaded'
        srv.begin_drain()
        with pytest.raises(OSError):
            socket.create_connection(('127.0.0.1', srv.port), timeout=2)
        t0 = time.monotonic()
        srv.finish_drain(grace_s=0.2)
        assert time.monotonic() - t0 < 5
        assert held.recv(16) == b''           # shut down under the client
        release.set()
        deadline = time.monotonic() + 10
        while srv.open_connections and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.open_connections == 0
    finally:
        release.set()
        srv.begin_drain()
        srv.finish_drain(grace_s=1.0)


def test_segment_name_and_cache_key_distinctness(tmp_path):
    from video_features_torch.cache.key import video_cache_key
    from video_features_torch.parallel.packing import VideoTask, segment_name
    from video_features_tpu.cache.key import video_cache_key as jax_key
    from video_features_tpu.parallel.packing import segment_name as jax_name

    clip = tmp_path / 'a.mp4'
    clip.write_bytes(b'notavideo but hashable')
    assert segment_name(str(clip), None) == str(clip)
    named = segment_name(str(clip), (1.5, 3.0))
    assert named.endswith('a_seg1500-3000ms.mp4')
    assert segment_name(str(clip), (1.5000001, 3.0)) == named
    full = video_cache_key(str(clip), 'fp')
    seg = video_cache_key(str(clip), 'fp', segment=(1.5, 3.0))
    seg2 = video_cache_key(str(clip), 'fp', segment=(1.5, 4.0))
    assert len({full, seg, seg2}) == 3
    t = VideoTask(str(clip), segment=(1.5, 3.0))
    assert t.name_path == named and t.segment == (1.5, 3.0)
    assert VideoTask(str(clip)).name_path == str(clip)
    # the JAX package's names, and its keys' equalities: the port's keys
    # carry a backend tag of their own (a JAX entry never answers the
    # port), so two ranges share a port key exactly when they share a JAX
    # key
    segments = (None, (1.5, 3.0), (1.5000001, 3.0), (1.5, 3.0004),
                (0.0004, 2.0006), (0.0, 2.001), (0.2, 0.6))
    for segment in segments:
        assert segment_name(str(clip), segment) == jax_name(str(clip), segment)
    ours = [video_cache_key(str(clip), 'fp', segment=g) for g in segments]
    theirs = [jax_key(str(clip), 'fp', segment=g) for g in segments]
    assert [[a == b for b in ours] for a in ours] == \
        [[a == b for b in theirs] for a in theirs]
    assert not set(ours) & set(theirs)


def test_stream_windows_frame_range_bounds_decode():
    from video_features_torch.extract.streaming import FLUSH, stream_windows

    frames = [np.full((2, 2), i, np.uint8) for i in range(100)]

    class Counting:
        def __init__(self):
            self.pulled = 0

        def __iter__(self):
            for i in range(0, 100, 8):
                self.pulled += 1
                yield frames[i:i + 8], None, None

    full_src = Counting()
    full = list(stream_windows(iter(full_src), 4, 2))
    assert len(full) == 49
    src = Counting()
    seg = list(stream_windows(iter(src), 4, 2, frame_range=(10, 20)))
    assert [int(w[0, 0, 0]) for w in seg] == [8, 10, 12, 14, 16, 18]
    for w in seg:
        assert np.array_equal(w, full[int(w[0, 0, 0]) // 2])
    assert src.pulled < full_src.pulled and src.pulled <= 3
    assert list(stream_windows(iter(Counting()), 4, 2, frame_range=(5, 5))) == []
    # a bare FLUSH passes through, mid-stream, without breaking a window
    batches = [(frames[0:3], None, None), FLUSH, (frames[3:6], None, None)]
    got = list(stream_windows(iter(batches), 4, 2))
    assert got[0] is FLUSH and [int(w[0, 0, 0]) for w in got[1:]] == [0, 2]


@pytest.mark.parametrize('seed', range(12))
def test_segment_windows_match_the_jax_windowers(seed):
    """``segment_frame_range``, ``stream_windows(frame_range=)`` and
    ``framewise_segment_windows`` pick the frames and windows the JAX
    package's do, over seeded (frames, fps, window, step, range) cases."""
    from video_features_torch.extract import streaming as ours
    from video_features_tpu.extract import streaming as theirs
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    fps = float(rng.choice([5.0, 12.5, 24.0, 25.0, 29.97]))
    win, step = int(rng.integers(1, 18)), int(rng.integers(1, 18))
    start = round(float(rng.uniform(0, n / fps)), 3)
    end = round(start + float(rng.uniform(0.001, n / fps)), 3)
    segment = (start, end)
    fr = ours.segment_frame_range(segment, fps)
    assert fr == theirs.segment_frame_range(segment, fps)
    frames = [np.full((1,), i, np.int32) for i in range(n)]
    bs = int(rng.integers(1, 9))

    def batches():
        for i in range(0, n, bs):
            idx = list(range(i, min(i + bs, n)))
            yield [frames[k] for k in idx], [k / fps * 1000 for k in idx], idx

    def starts(windows):
        return [int(w[0, 0]) for w in windows]

    assert starts(ours.stream_windows(batches(), win, step, frame_range=fr)) \
        == starts(theirs.stream_windows(batches(), win, step, frame_range=fr))
    got = [(int(f[0]), t) for f, t in ours.framewise_segment_windows(batches(), fr)]
    want = [(int(f[0]), t)
            for f, t in theirs.framewise_segment_windows(batches(), fr)]
    assert got == want


def test_live_session_windowing_unit():
    from video_features_torch.extract.streaming import FLUSH
    from video_features_torch.ingress.live import LiveSession

    class StubEx:
        feature_type = 'stub'

        def live_window_spec(self):
            return (4, 2, None, False)

    s = LiveSession('s1', 'acme', fps=10.0, idle_flush_s=0.01)
    gen = s.windows(StubEx())
    assert next(gen) is FLUSH                # nothing pushed: a lull
    frames = np.arange(10, dtype=np.uint8).reshape(10, 1, 1, 1) * \
        np.ones((1, 2, 2, 3), np.uint8)
    s.push(frames[:6])
    s.push(frames[6:])
    s.end_input()
    got = [item for item in gen if item is not FLUSH]
    assert [int(w[0, 0, 0, 0]) for w, _ in got] == [0, 2, 4, 6]
    assert s.windows_in == 4

    class StubFrameEx:
        feature_type = 'stubf'

        def live_window_spec(self):
            return (1, 1, None, True)

    s2 = LiveSession('s2', 'acme', fps=10.0, idle_flush_s=0.01)
    s2.push(frames[:3])
    s2.end_input()
    got2 = [item for item in s2.windows(StubFrameEx()) if item is not FLUSH]
    assert [m for _, m in got2] == [0.0, 100.0, 200.0]


def test_decode_frame_chunk_validation():
    from video_features_torch.ingress.live import (
        LiveSessionError, decode_frame_chunk,
    )

    def npy(arr, **kw):
        buf = io.BytesIO()
        np.save(buf, arr, **kw)
        return buf.getvalue()

    assert decode_frame_chunk(npy(np.zeros((2, 4, 4, 3), np.uint8))).shape \
        == (2, 4, 4, 3)
    assert decode_frame_chunk(npy(np.zeros((4, 4, 3), np.uint8))).shape \
        == (1, 4, 4, 3)
    with pytest.raises(LiveSessionError, match='undecodable'):
        decode_frame_chunk(b'not npy')
    with pytest.raises(LiveSessionError, match='uint8'):
        decode_frame_chunk(npy(np.zeros((4, 4, 3), np.float32)))
    with pytest.raises(LiveSessionError, match=r'\(H, W, 3\)'):
        decode_frame_chunk(npy(np.zeros((2, 4, 4, 4), np.uint8)))
    with pytest.raises(LiveSessionError, match='exceeds'):
        decode_frame_chunk(npy(np.zeros((3, 1, 1, 3), np.uint8)), max_frames=2)
    # never unpickles: an object array and a raw pickle are refused
    with pytest.raises(LiveSessionError, match='undecodable'):
        decode_frame_chunk(npy(np.array([{'a': 1}], dtype=object),
                               allow_pickle=True))
    with pytest.raises(LiveSessionError, match='undecodable'):
        decode_frame_chunk(pickle.dumps(np.zeros((4, 4, 3), np.uint8)))


def test_protocol_version_check_unit():
    from video_features_torch.serve import protocol

    assert protocol.check_version({'cmd': 'ping'}) is None
    assert protocol.check_version({'v': '1.0'}) is None
    assert protocol.check_version({'v': '1.7'}) is None
    err = protocol.check_version({'v': '99.0', 'request_id': 'r42'})
    assert err['ok'] is False and 'unsupported protocol' in err['error']
    assert err['request_id'] == 'r42' and err['v'] == protocol.VERSION
    err = protocol.check_version({'v': 'abc'})
    assert err['ok'] is False and 'malformed' in err['error']


def test_client_connect_retries_until_late_binding_listener():
    from video_features_torch.serve import protocol
    from video_features_torch.serve.client import ServeClient

    probe = socket.socket()
    probe.bind(('127.0.0.1', 0))
    port = probe.getsockname()[1]
    probe.close()

    def late_listener():
        time.sleep(0.4)
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(('127.0.0.1', port))
        srv.listen(1)
        conn, _ = srv.accept()
        with conn, conn.makefile('rb') as rf:
            msg = protocol.decode(rf.readline())
            assert msg['cmd'] == 'ping' and msg['v'] == protocol.VERSION
            conn.sendall(protocol.encode(protocol.ok(draining=False)))
        srv.close()

    t = threading.Thread(target=late_listener, daemon=True)
    t.start()
    assert ServeClient(port, connect_timeout_s=10.0).ping()
    t.join(5.0)
    probe = socket.socket()
    probe.bind(('127.0.0.1', 0))
    dead = probe.getsockname()[1]
    probe.close()
    t0 = time.monotonic()
    with pytest.raises((ConnectionRefusedError, OSError)):
        ServeClient(dead, connect_timeout_s=0.3).ping()
    assert time.monotonic() - t0 < 5.0


# -- end to end: one shared server and gateway (resnet18, random weights) --------


@pytest.fixture(scope='module')
def ingress_clips(tmp_path_factory):
    d = tmp_path_factory.mktemp('ingressvids')
    return [str(write_noise_clip(d / f'iv{i}.mp4', n, seed=10 + i))
            for i, n in enumerate((16, 6))]


def _base_overrides(root: Path, family='resnet', **extra):
    return {'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'decode_backend': 'cv2',
            'tmp_path': str(root / 'ing_tmp'),
            'output_path': str(root / 'ing_out_default'),
            **PARITY[family], **extra}


def _make_auth(auth_cls=None, tenant_cls=None):
    from video_features_torch.ingress.auth import ApiKeyAuth, Tenant
    auth_cls, tenant_cls = auth_cls or ApiKeyAuth, tenant_cls or Tenant
    return auth_cls({
        API_KEY: tenant_cls('acme'),
        BATCH_KEY: tenant_cls('bulkco', priority='batch'),
        LIMITED_KEY: tenant_cls('capped', rate_rps=0.001, burst=1,
                                max_concurrent=1)})


def _start(root, family='resnet', **extra):
    from video_features_torch.ingress.gateway import IngressGateway
    from video_features_torch.serve.server import ExtractionServer
    server = ExtractionServer(base_overrides=_base_overrides(root, family, **extra),
                              queue_depth=8, pool_size=2,
                              batch_shed_fraction=0.5).start()
    return server, IngressGateway(server, auth=_make_auth()).start()


def _start_jax(root, family='resnet', **extra):
    from video_features_tpu.ingress.auth import ApiKeyAuth, Tenant
    from video_features_tpu.ingress.gateway import IngressGateway
    from video_features_tpu.serve.server import ExtractionServer
    server = ExtractionServer(base_overrides=_base_overrides(root, family,
                                                             **extra),
                              queue_depth=8, pool_size=2).start()
    return server, IngressGateway(server, auth=_make_auth(ApiKeyAuth,
                                                          Tenant)).start()


@pytest.fixture(scope='module')
def gatewayed(tmp_path_factory):
    root = tmp_path_factory.mktemp('ingress_srv')
    server, gateway = _start(root)
    yield server, gateway, root
    server.drain(wait=True, grace_s=120)


def _api(gateway, method, path, body=None, key=API_KEY, timeout=180,
         headers=None):
    import http.client
    c = http.client.HTTPConnection('127.0.0.1', gateway.port, timeout=timeout)
    headers = dict(headers or {})
    if key:
        headers['Authorization'] = f'Bearer {key}'
    c.request(method, path, body=json.dumps(body) if body is not None else None,
              headers=headers)
    r = c.getresponse()
    raw = r.read()
    c.close()
    try:
        return r.status, json.loads(raw)
    except ValueError:
        return r.status, raw


def _wait_done(gateway, rid, key=API_KEY, timeout_s=180.0):
    deadline = time.monotonic() + timeout_s
    while True:
        st, doc = _api(gateway, 'GET', f'/v1/requests/{rid}', key=key)
        assert st == 200, doc
        if doc['state'] != 'running':
            return doc
        assert time.monotonic() < deadline, f'request {rid} stuck: {doc}'
        time.sleep(0.1)


def test_health_auth_and_metrics_surfaces(gatewayed):
    server, gateway, _ = gatewayed
    st, doc = _api(gateway, 'GET', '/healthz', key=None)
    assert st == 200 and doc['ok'] and doc['draining'] is False
    st, doc = _api(gateway, 'GET', '/v1/metrics', key='wrong-key')
    assert st == 401 and doc['error'] == 'unauthorized'
    st, doc = _api(gateway, 'GET', '/v1/metrics')
    assert st == 200 and doc['metrics']['ingress']['enabled'] is True
    st, text = _api(gateway, 'GET', '/metrics')
    assert st == 200 and b'vft_ingress_requests_total' in text
    st, doc = _api(gateway, 'GET', '/v1/nope')
    assert st == 404
    # /v1/search on a daemon without index_enabled: the JAX gateway's 503
    # index_disabled, before any quota is spent
    st, doc = _api(gateway, 'POST', '/v1/search',
                   {'family': 'resnet', 'vector': [0.0] * 512})
    assert st == 503 and doc['error'] == 'index_disabled', doc
    assert doc['message'] == ('the feature index is not enabled on this '
                              'server (index_enabled=true)')
    st, doc = _api(gateway, 'POST', '/v1/search', {'surprise': 1})
    assert st == 400 and doc['error'] == 'bad_request'


def test_segment_query_parity_ingress_vs_loopback(gatewayed, ingress_clips):
    from video_features_torch.serve.client import ServeClient
    server, gateway, root = gatewayed
    clip = ingress_clips[0]
    seg = [0.2, 0.6]
    out_ing = str(root / 'seg_ing')
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [clip], 'range': seg,
        'overrides': {'output_path': out_ing}})
    assert st == 200 and doc['tenant'] == 'acme', doc
    status = _wait_done(gateway, doc['request_id'])
    assert status['state'] == 'done' and status['range'] == seg
    assert status['tenant'] == 'acme'
    out_loop = str(root / 'seg_loop')
    client = ServeClient(port=server.port)
    rid = client.submit('resnet', [clip], overrides={'output_path': out_loop},
                        range_s=seg)
    assert client.wait(rid, timeout_s=180)['state'] == 'done'
    stem = Path(clip).stem + '_seg200-600ms.mp4'
    for key_ in ('resnet', 'timestamps_ms', 'fps'):
        a = Path(make_path(str(Path(out_ing) / 'resnet' / 'resnet18'),
                           stem, key_, '.npy')).read_bytes()
        b = Path(make_path(str(Path(out_loop) / 'resnet' / 'resnet18'),
                           stem, key_, '.npy')).read_bytes()
        assert a == b, key_
    ts = np.load(make_path(str(Path(out_ing) / 'resnet' / 'resnet18'),
                           stem, 'timestamps_ms', '.npy'))
    assert ts.min() >= 200.0 - 1e-6 and ts.max() < 600.0
    assert 0 < len(ts) < 16


def test_trace_route_tenant_scoped_and_traceparent_adopted(gatewayed,
                                                           ingress_clips):
    server, gateway, root = gatewayed
    clip = ingress_clips[1]
    caller_trace = 'feedc0de' * 4
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [clip],
        'overrides': {'output_path': str(root / 'trace_out_dir')}},
        headers={'traceparent': f'00-{caller_trace}-00f067aa0ba902b7-01'})
    assert st == 200 and doc['trace_id'] == caller_trace, doc
    rid = doc['request_id']
    assert _wait_done(gateway, rid)['state'] == 'done'
    st, tr = _api(gateway, 'GET', f'/v1/requests/{rid}/trace')
    assert st == 200, tr
    assert tr['trace_id'] == caller_trace and tr['tenant'] == 'acme'
    assert tr['request_id'] == rid and isinstance(tr['events'], list)
    st, err = _api(gateway, 'GET', f'/v1/requests/{rid}/trace', key=BATCH_KEY)
    assert st == 403 and err['error'] == 'forbidden', err
    st, err = _api(gateway, 'GET', f'/v1/requests/{rid}', key=BATCH_KEY)
    assert st == 404
    st, err = _api(gateway, 'GET', '/v1/requests/r999999/trace')
    assert st == 404
    st, doc2 = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [clip],
        'overrides': {'output_path': str(root / 'trace_out_dir2')}},
        headers={'traceparent': 'garbage'})
    assert st == 200 and len(doc2['trace_id']) == 32
    assert doc2['trace_id'] != caller_trace
    _wait_done(gateway, doc2['request_id'])


def test_segment_decode_is_tracer_bounded_to_range(ingress_clips, tmp_path):
    from video_features_torch.config import load_config
    from video_features_torch.obs.spans import SpanRecorder
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    from video_features_torch.utils.tracing import Tracer

    clip = ingress_clips[0]                      # 16 frames at 25 fps
    ex = create_extractor(load_config('resnet', overrides=dict(
        _base_overrides(tmp_path), video_paths=[clip],
        output_path=str(tmp_path / 'out'))))

    def run(segment, tag):
        rec = SpanRecorder()
        ex.tracer = Tracer(enabled=True, recorder=rec)
        ex.extract_packed([VideoTask(clip, out_root=str(tmp_path / tag),
                                     segment=segment)])
        return sum(1 for ev in rec.snapshot()
                   if ev.get('name') == 'decode+preprocess')

    full = run(None, 'full')
    seg = run((0.0, 0.2), 'seg')                 # 5 of 16 frames
    assert full >= 16
    assert 0 < seg <= 6 and seg < full / 2


def test_quota_exhausted_sheds_without_admission_slot(gatewayed, ingress_clips):
    server, gateway, root = gatewayed
    depth_before = server.metrics()['queue']['depth']
    st1, d1 = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [ingress_clips[1]],
        'overrides': {'output_path': str(root / 'q_out')}}, key=LIMITED_KEY)
    assert st1 == 200, d1
    st2, d2 = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [ingress_clips[1]]},
        key=LIMITED_KEY)
    assert st2 == 429, d2
    assert d2['error'] in ('rate_limited', 'concurrency')
    assert d2['tenant'] == 'capped' and 'request_id' in d2
    m = server.metrics()
    assert m['queue']['depth'] <= depth_before + 1
    assert m['ingress']['tenants']['capped']['shed'] >= 1
    st, text = _api(gateway, 'GET', '/metrics')
    assert st == 200
    shed_lines = [ln for ln in text.decode().splitlines()
                  if ln.startswith('vft_ingress_shed_total{')
                  and 'tenant="capped"' in ln]
    assert shed_lines and any('class="interactive"' in ln and not ln.endswith(' 0')
                              for ln in shed_lines), shed_lines
    _wait_done(gateway, d1['request_id'], key=LIMITED_KEY)


def test_batch_priority_shed_before_interactive(gatewayed):
    server, gateway, root = gatewayed
    fakes = [f'/nonexistent/batchvid{i}.mp4' for i in range(5)]
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': fakes}, key=BATCH_KEY)
    assert st == 503 and doc['error'] == 'queue_full', doc
    assert doc['priority'] == 'batch' and doc['capacity'] == 4
    assert doc['tenant'] == 'bulkco'
    assert server.metrics()['queue']['depth'] == 0
    st, text = _api(gateway, 'GET', '/metrics')
    assert any('class="batch"' in ln and 'reason="queue_full"' in ln
               for ln in text.decode().splitlines()
               if ln.startswith('vft_ingress_shed_total{'))
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': fakes,
        'priority': 'interactive'}, key=BATCH_KEY)
    assert st == 403 and doc['error'] == 'priority_forbidden', doc
    assert doc['tenant'] == 'bulkco'
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': fakes,
        'priority': 'interactive',
        'overrides': {'output_path': str(root / 'b_out')}})
    assert st == 200, doc
    status = _wait_done(gateway, doc['request_id'])
    assert status['state'] == 'failed'
    assert set(status['videos'].values()) == {'failed'}


def test_deadline_expired_over_ingress(gatewayed, ingress_clips):
    server, gateway, root = gatewayed
    st, doc = _api(gateway, 'POST', '/v1/extract', {
        'feature_type': 'resnet', 'video_paths': [ingress_clips[0]],
        'timeout_s': 0.0, 'overrides': {'output_path': str(root / 'dl_out')}})
    assert st == 200, doc
    status = _wait_done(gateway, doc['request_id'])
    assert status['state'] == 'failed'
    assert set(status['videos'].values()) == {'expired'}
    assert status['tenant'] == 'acme'
    assert status['request_id'] == doc['request_id']
    assert server.metrics()['requests']['expired_videos'] >= 1


def _live_connect(gateway, sid, key=API_KEY, timeout=180):
    s = socket.create_connection(('127.0.0.1', gateway.port), timeout=timeout)
    s.sendall(f'POST /v1/live/{sid} HTTP/1.1\r\nHost: t\r\n'
              f'Authorization: Bearer {key}\r\n'
              f'Transfer-Encoding: chunked\r\n\r\n'.encode())
    return s


def _send_chunk(s, payload: bytes):
    s.sendall(b'%x\r\n%s\r\n' % (len(payload), payload))


def _npy(frames) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(frames))
    return buf.getvalue()


def _frames_chunk(rng, n=3, h=48, w=64):
    return _npy(rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8))


class _ChunkReader:
    """A chunked-response reader over a raw socket."""

    def __init__(self, s):
        self.rf = s.makefile('rb')

    def read_headers(self):
        status = int(self.rf.readline().split()[1])
        while self.rf.readline() not in (b'\r\n', b''):
            pass
        return status

    def read_chunk(self):
        size = int(self.rf.readline().split(b';')[0], 16)
        if size == 0:
            self.rf.readline()
            return None
        data = self.rf.read(size)
        self.rf.readline()
        return data

    def rows_and_final(self):
        rows = []
        while True:
            row = json.loads(self.read_chunk())
            if row.get('done'):
                return rows, row
            rows.append(row)


def _live_session(gateway, sid, feature_type, chunks, fps=25.0,
                  overrides=None):
    """One whole live session: the header, every frame chunk, the end;
    returns (hello, rows, final)."""
    s = _live_connect(gateway, sid)
    try:
        header = {'feature_type': feature_type, 'fps': fps}
        if overrides:
            header['overrides'] = overrides
        _send_chunk(s, json.dumps(header).encode())
        for c in chunks:
            _send_chunk(s, c)
        s.sendall(b'0\r\n\r\n')
        reader = _ChunkReader(s)
        assert reader.read_headers() == 200
        hello = json.loads(reader.read_chunk())
        rows, final = reader.rows_and_final()
        return hello, rows, final
    finally:
        s.close()


def test_live_session_streams_windows_before_final(gatewayed):
    server, gateway, _ = gatewayed
    rng = np.random.default_rng(7)
    s = _live_connect(gateway, 'live-a')
    try:
        _send_chunk(s, json.dumps({'feature_type': 'resnet', 'fps': 5.0}).encode())
        reader = _ChunkReader(s)
        assert reader.read_headers() == 200
        hello = json.loads(reader.read_chunk())
        assert hello['ok'] and hello['session'] == 'live-a'
        rid = hello['request_id']
        _send_chunk(s, _frames_chunk(rng, n=3))
        _send_chunk(s, _frames_chunk(rng, n=3))
        rows = []
        while len(rows) < 6:
            row = json.loads(reader.read_chunk())
            assert 'window' in row and not row.get('done'), row
            rows.append(row)
        assert len(rows[0]['feats']['resnet']) == 512
        assert rows[1]['timestamp_ms'] == pytest.approx(200.0)
        s.sendall(b'0\r\n\r\n')
        _, final = reader.rows_and_final()
        assert final['state'] == 'done' and final['windows'] == 6
        assert final['request_id'] == rid
    finally:
        s.close()


def test_live_session_tail_windows_survive_immediate_end(gatewayed):
    server, gateway, _ = gatewayed
    rng = np.random.default_rng(13)
    hello, rows, final = _live_session(gateway, 'tail-sid', 'resnet',
                                       [_frames_chunk(rng, n=3)], fps=5.0)
    assert hello['ok'] and len(rows) == 3, rows
    assert final['state'] == 'done' and final['windows'] == 3


def test_range_validation_rejects_nonfinite_and_bad_order(gatewayed):
    server, gateway, _ = gatewayed
    for bad in ([1.0], [2.0, 1.0], [-1.0, 2.0], [0.0, 1e999], ['a', 'b']):
        st, doc = _api(gateway, 'POST', '/v1/extract', {
            'feature_type': 'resnet', 'video_paths': ['/nonexistent/r.mp4'],
            'range': bad})
        assert st == 400, (bad, st, doc)
        assert doc['tenant'] == 'acme'


def test_duplicate_live_session_id_rejected(gatewayed):
    server, gateway, _ = gatewayed
    rng = np.random.default_rng(8)
    s1 = _live_connect(gateway, 'dup-sid')
    try:
        _send_chunk(s1, json.dumps({'feature_type': 'resnet', 'fps': 5.0}).encode())
        r1 = _ChunkReader(s1)
        assert r1.read_headers() == 200
        assert json.loads(r1.read_chunk())['ok']
        s2 = _live_connect(gateway, 'dup-sid')
        try:
            _send_chunk(s2, json.dumps({'feature_type': 'resnet'}).encode())
            assert _ChunkReader(s2).read_headers() == 409
        finally:
            s2.close()
        _send_chunk(s1, _frames_chunk(rng, n=2))
        assert 'window' in json.loads(r1.read_chunk())
        s1.sendall(b'0\r\n\r\n')
        _, final = r1.rows_and_final()
        assert final['state'] == 'done'
    finally:
        s1.close()
    # the session leaves the table in its handler's cleanup, just after
    # the final chunk went out
    st, _doc = _api(gateway, 'GET', '/v1/metrics')
    assert st == 200
    deadline = time.monotonic() + 10
    while server.metrics()['ingress']['live_sessions'] \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert server.metrics()['ingress']['live_sessions'] == 0


def test_live_session_rejected_for_nonlive_family(monkeypatch):
    from video_features_torch.serve import server as server_mod

    class FakeSession:
        pseudo_path = 'x.live'

        def bind(self, req):
            pass

    monkeypatch.setattr(server_mod, 'LIVE_FEATURES', frozenset({'resnet'}))
    server = server_mod.ExtractionServer(base_overrides={'device': 'cpu'})
    out = server.submit_live('r21d', FakeSession())
    assert out['ok'] is False and 'live-session support' in out['error']
    assert out['code'] == 'unsupported'


def test_protocol_version_rejected_over_socket(gatewayed):
    from video_features_torch.serve import protocol
    server, _, _ = gatewayed

    def roundtrip(msg):
        s = socket.create_connection(('127.0.0.1', server.port), timeout=30)
        with s, s.makefile('rb') as rf:
            s.sendall(protocol.encode(msg))
            return protocol.decode(rf.readline())

    bad = roundtrip({'cmd': 'status', 'request_id': 'r000001', 'v': '99.1'})
    assert bad['ok'] is False and 'unsupported protocol' in bad['error']
    assert bad['request_id'] == 'r000001' and bad['v'] == protocol.VERSION
    assert roundtrip({'cmd': 'ping', 'v': protocol.VERSION})['ok'] is True


def test_drain_reaps_half_open_live_session(tmp_path):
    server, gateway = _start(tmp_path)
    rng = np.random.default_rng(9)
    s = _live_connect(gateway, 'half-open')
    _send_chunk(s, json.dumps({'feature_type': 'resnet', 'fps': 5.0}).encode())
    reader = _ChunkReader(s)
    assert reader.read_headers() == 200
    assert json.loads(reader.read_chunk())['ok']
    _send_chunk(s, _frames_chunk(rng, n=2))
    # ... and the client goes silent with the connection held open
    t0 = time.monotonic()
    server.drain(wait=True, grace_s=60)
    assert server.drained and time.monotonic() - t0 < 45
    deadline = time.monotonic() + 10
    while gateway.http.open_connections and time.monotonic() < deadline:
        time.sleep(0.05)
    assert gateway.http.open_connections == 0
    assert server.metrics()['ingress']['live_sessions'] == 0
    s.close()


def test_serve_cli_prints_the_ingress_line_and_answers(ingress_clips, tmp_path):
    """``python -m video_features_torch serve serve_ingress_port=0
    serve_ingress_auth_file=<keys.yml>`` prints the JAX package's
    ``ingress on host:port`` line after its endpoint line, answers a
    segment query over HTTP and drains on SIGTERM."""
    import os
    import re
    import signal
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    keys = tmp_path / 'keys.yml'
    keys.write_text(f'keys:\n  {API_KEY}:\n    tenant: acme\n')
    base = _base_overrides(tmp_path)
    args = [f'{k}={v}' for k, v in base.items()] + [
        'serve_ingress_port=0', f'serve_ingress_auth_file={keys}']
    proc = subprocess.Popen(
        [sys.executable, '-m', 'video_features_torch', 'serve', *args],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=str(repo)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert re.match(r'serving on [\d.]+:\d+ ', proc.stdout.readline())
        line = proc.stdout.readline()
        m = re.match(r'ingress on ([\d.]+):(\d+) \(tenants=1\)$', line.strip())
        assert m, (line, proc.stderr.read() if proc.poll() is not None else '')

        class _Port:
            port = int(m.group(2))

        out = str(tmp_path / 'cli_seg')
        st, doc = _api(_Port, 'POST', '/v1/extract', {
            'feature_type': 'resnet', 'video_paths': [ingress_clips[0]],
            'range': [0.0, 0.2], 'overrides': {'output_path': out}})
        assert st == 200, doc
        assert _wait_done(_Port, doc['request_id'])['state'] == 'done'
        assert Path(make_path(str(Path(out) / 'resnet' / 'resnet18'),
                              Path(ingress_clips[0]).stem + '_seg0-200ms.mp4',
                              'resnet', '.npy')).exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        assert 'serve: drained, exiting' in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# -- the port against the JAX package's gateway ----------------------------------


def _clip_frames(clip):
    """The clip's raw decoded frames, as the port's loader gives them."""
    from video_features_torch.io.video import VideoLoader
    with VideoLoader(clip, batch_size=64, backend='cv2') as loader:
        return np.stack([f for batch, _, _ in loader for f in batch]), loader.fps


def _rows(rows, key):
    return np.asarray([r['feats'][key] for r in rows], np.float32)


# a segment of the parity clip (45 frames at 25 fps): frames 12 … 22, so
# resnet rows 12 … 22 of 45 and i3d windows 1 … 2 of 4 (11 frames, step 10)
SEGMENT = [0.5, 0.9]
SEGMENT_TAG = '_seg500-900ms'
K_MIN = {'resnet': 12, 'i3d': 1}


@pytest.fixture(scope='module')
def parity_clip(tmp_path_factory):
    d = tmp_path_factory.mktemp('parityvid')
    return str(write_noise_clip(d / 'pv.mp4', 45, seed=31))


@pytest.fixture(scope='module', params=list(PARITY))
def both_sides(request, parity_clip, tmp_path_factory):
    """Per family: a segment query, a full query and a live session of
    the clip's frames through the port's gateway, and the segment query
    and the live session through the JAX gateway, on one seeded
    checkpoint (the seeded random init both packages share)."""
    family = request.param
    frames, fps = _clip_frames(parity_clip)
    chunks = [_npy(frames[i:i + 7]) for i in range(0, len(frames), 7)]
    seg = SEGMENT
    out = {}
    for side, start in (('port', _start), ('jax', _start_jax)):
        root = tmp_path_factory.mktemp(f'{family}_{side}')
        server, gateway = start(root, family)
        try:
            res = {'root': root}
            for name, body in (('seg', {'range': seg}), ('full', {})):
                if side == 'jax' and name == 'full':
                    continue
                st, doc = _api(gateway, 'POST', '/v1/extract', {
                    'feature_type': family, 'video_paths': [parity_clip],
                    'overrides': {'output_path': str(root / name)}, **body})
                assert st == 200, doc
                res[name] = _wait_done(gateway, doc['request_id'])
            res['live'] = _live_session(gateway, f'{family}-{side}', family,
                                        chunks, fps=fps)
            out[side] = res
        finally:
            server.drain(wait=True, grace_s=120)
    return family, seg, out


def _tree(root):
    return {str(f.relative_to(root)): np.load(f)
            for f in sorted(Path(root).rglob('*.npy'))}


def _saved(root, video_path, key):
    """The array saved under ``root`` for ``video_path`` (a name path) and
    ``key``, wherever the family's subdirectory is."""
    for d in sorted({f.parent for f in Path(root).rglob('*.npy')}):
        p = Path(make_path(str(d), video_path, key, '.npy'))
        if p.exists():
            return np.load(p)
    raise AssertionError(f'no {key} file for {video_path} under {root}')


def test_segment_query_matches_the_jax_gateway(both_sides, parity_clip):
    from video_features_torch.parallel.packing import segment_name
    family, seg, out = both_sides
    port, jax = out['port'], out['jax']
    assert port['seg']['state'] == jax['seg']['state'] == 'done'
    assert port['seg']['range'] == jax['seg']['range'] == seg
    got, want = _tree(port['root'] / 'seg'), _tree(jax['root'] / 'seg')
    assert sorted(got) == sorted(want) and got
    assert all(SEGMENT_TAG in name for name in got), sorted(got)
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name.endswith(('_fps.npy', '_timestamps_ms.npy')):
            np.testing.assert_array_equal(got[name], want[name])
        else:
            assert rel_l2(got[name], want[name]) <= REL_L2, name
    # the segment's rows are rows k_min … k_max of the full extraction
    key = 'resnet' if family == 'resnet' else 'rgb'
    seg_rows = _saved(port['root'] / 'seg',
                      segment_name(parity_clip, SEGMENT), key)
    full_rows = _saved(port['root'] / 'full', parity_clip, key)
    k_min = K_MIN[family]
    assert 0 < len(seg_rows) < len(full_rows)
    assert len(seg_rows) == (11 if family == 'resnet' else 2)
    np.testing.assert_array_equal(seg_rows, full_rows[k_min:k_min + len(seg_rows)])


def test_segment_cache_entry_is_keyed_on_its_range(parity_clip, tmp_path):
    """A segment query with ``cache_enabled`` publishes one entry under
    its range's key (never the whole video's), and a second query of the
    range is answered from the cache at admission, byte-equal."""
    from video_features_torch.cache.key import video_cache_key
    server, gateway = _start(tmp_path, cache_enabled=True,
                             cache_dir=str(tmp_path / 'fc'))
    try:
        states = []
        for name in ('a', 'b'):
            st, doc = _api(gateway, 'POST', '/v1/extract', {
                'feature_type': 'resnet', 'video_paths': [parity_clip],
                'range': SEGMENT,
                'overrides': {'output_path': str(tmp_path / name)}})
            assert st == 200, doc
            states.append(_wait_done(gateway, doc['request_id'])['videos'])
        assert states == [{parity_clip: 'saved'}, {parity_clip: 'cached'}]
        a, b = _tree(tmp_path / 'a'), _tree(tmp_path / 'b')
        assert a.keys() == b.keys() and all(SEGMENT_TAG in n for n in a)
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
        fp = server.pool.entries()[0].ex.run_fingerprint
        key = video_cache_key(parity_clip, fp, segment=tuple(SEGMENT))
        assert key != video_cache_key(parity_clip, fp)
        stored = sorted(p.name for p in (tmp_path / 'fc').rglob('*')
                        if p.is_dir() and len(p.name) == 64)
        assert stored == [key]
    finally:
        server.drain(wait=True, grace_s=120)


def test_live_rows_match_the_jax_session_and_the_file_backed_run(both_sides,
                                                                parity_clip):
    family, _, out = both_sides
    port, jax = out['port'], out['jax']
    (hello, rows, final), (_, jrows, jfinal) = port['live'], jax['live']
    assert hello['ok'] and final['state'] == jfinal['state'] == 'done'
    assert final['windows'] == jfinal['windows'] == len(rows) == len(jrows) > 1
    assert [r['window'] for r in rows] == list(range(len(rows)))
    keys = sorted(rows[0]['feats'])
    assert keys == sorted(jrows[0]['feats'])
    full = port['root'] / 'full'
    for key in keys:
        assert rel_l2(_rows(rows, key), _rows(jrows, key)) <= REL_L2, key
        np.testing.assert_array_equal(_rows(rows, key),
                                      _saved(full, parity_clip, key))
    if family == 'resnet':
        assert [r['timestamp_ms'] for r in rows] == \
            [r['timestamp_ms'] for r in jrows]
        np.testing.assert_allclose([r['timestamp_ms'] for r in rows],
                                   _saved(full, parity_clip, 'timestamps_ms'))


# -- through the decode farm -------------------------------------------------------


def test_segment_through_the_decode_farm_equals_in_process(parity_clip, tmp_path):
    """The farm's worker processes replay the segment's frame filter: the
    segment's files are those of in-process decode, for a frame-wise and
    a stack family."""
    from video_features_torch.config import load_config
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    seg = tuple(SEGMENT)
    for family in PARITY:
        ex = create_extractor(load_config(family, overrides=dict(
            _base_overrides(tmp_path, family), video_paths=[parity_clip],
            decode_farm_ring_mb=8)))
        trees = {}
        for tag, workers in (('inproc', 1), ('farm', 2)):
            ex.decode_workers = workers
            root = tmp_path / f'{family}_{tag}'
            ex.extract_packed([VideoTask(parity_clip, out_root=str(root),
                                         segment=seg)])
            trees[tag] = {n: p.read_bytes() for n, p in (
                (str(f.relative_to(root)), f) for f in root.rglob('*.npy'))}
        assert trees['inproc'] and trees['inproc'] == trees['farm']
        assert ex._farm.stats()['ran'] and ex._farm.stats()['videos_done'] == 1
        assert all(SEGMENT_TAG in n for n in trees['farm'])


def test_live_session_through_the_decode_farm(parity_clip, tmp_path):
    """A farm-backed warm worker (decode_workers=2) runs a live session on
    a feeder thread of the parent, with the rows of in-process decode."""
    frames, fps = _clip_frames(parity_clip)
    chunks = [_npy(frames[i:i + 9]) for i in range(0, len(frames), 9)]
    rows = {}
    for workers in (1, 2):
        server, gateway = _start(tmp_path / f'w{workers}',
                                 decode_workers=workers,
                                 decode_farm_ring_mb=8)
        try:
            hello, rows[workers], final = _live_session(
                gateway, f'farm-live-{workers}', 'resnet', chunks, fps=fps)
            assert hello['ok'] and final['state'] == 'done'
            assert final['windows'] == len(frames) == len(rows[workers])
            if workers == 2:
                farms = server.metrics()['farm']
                assert farms['decode_workers'] == 2
        finally:
            server.drain(wait=True, grace_s=120)
    np.testing.assert_array_equal(_rows(rows[1], 'resnet'),
                                  _rows(rows[2], 'resnet'))
