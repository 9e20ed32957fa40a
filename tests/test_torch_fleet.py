"""The port's fleet tier (video_features_torch/fleet/) held to the JAX
package's (video_features_tpu/fleet/) on the CPU:

  * the consistent-hash ring: owners and failover order over 1000 keys,
    a host removed and the eligibility filter;
  * ``split_fleet_config`` on the same dotlists: the same knobs and the
    same errors; ``merge_expositions`` on the same texts;
  * the router against fake backends: every scenario of the JAX
    package's fake-backend tests (tests/test_fleet.py) runs against both
    routers over backends on the same ports, with the same responses,
    call logs and counters;
  * the command line (``python -m video_features_torch fleet``): the
    endpoint lines, a SIGTERM, no torch in the router process; the
    health table of ``fleet/status.py`` against ``tools/fleet_status.py``;
  * a real fleet: two port daemons (resnet18 on the CPU) behind the port
    router route each video to its ring owner, and their outputs hold the
    JAX fleet's at rel L2 <= 1e-5.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.fleet.ring import HashRing
from video_features_torch.serve import protocol
from video_features_torch.serve.client import ServeClient, ServeError

REPO = Path(__file__).resolve().parents[1]
PKGS = ('jax', 'port')


def _router_cls(pkg):
    if pkg == 'jax':
        from video_features_tpu.fleet.router import FleetRouter
    else:
        from video_features_torch.fleet.router import FleetRouter
    return FleetRouter


# -- the ring, the config, the aggregation ---------------------------------


@pytest.mark.parametrize('replicas', [1, 64])
def test_ring_owners_and_failover_order_equal_the_jax_rings(replicas):
    from video_features_tpu.fleet.ring import HashRing as JaxRing
    hosts = [f'10.0.0.{i}:93{i:02d}' for i in range(5)]
    keys = [f'sha256:{i:06d}' for i in range(1000)]
    jax_ring, ring = JaxRing(hosts, replicas), HashRing(hosts, replicas)
    assert ring._points == jax_ring._points
    assert ring._owners == jax_ring._owners
    assert [ring.host_for(k) for k in keys] == [jax_ring.host_for(k)
                                                for k in keys]
    assert [ring.hosts_for(k) for k in keys] == [jax_ring.hosts_for(k)
                                                 for k in keys]
    victim = hosts[2]
    less, jax_less = ring.without(victim), jax_ring.without(victim)
    assert [less.host_for(k) for k in keys] == [jax_less.host_for(k)
                                                for k in keys]
    eligible = set(hosts) - {victim}
    assert [ring.hosts_for(k, eligible) for k in keys] == \
        [jax_ring.hosts_for(k, eligible) for k in keys]
    moved = [k for k in keys if ring.host_for(k) != less.host_for(k)]
    assert all(ring.host_for(k) == victim for k in moved)
    assert HashRing(hosts + hosts).hosts == hosts
    with pytest.raises(ValueError, match='empty hash ring'):
        HashRing([]).host_for('x')


FLEET_DOTLISTS = [
    ['fleet_hosts=[127.0.0.1:9301,127.0.0.1:9302]', 'fleet_port=0',
     'feature_type=resnet'],
    ['fleet_hosts=9301', 'fleet_max_attempts=2', 'fleet_ring_replicas=8'],
    ['fleet_hots=127.0.0.1:1'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_http_port=8080'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_http_port=8080',
     'fleet_auth_file=/k.yml'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_probe_interval_s=0'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_port=-1'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_max_attempts=0'],
    ['fleet_hosts=[127.0.0.1:1]', 'fleet_slo_availability=1'],
    ['fleet_hosts=[]'],
]


@pytest.mark.parametrize('dotlist', FLEET_DOTLISTS,
                         ids=[str(i) for i in range(len(FLEET_DOTLISTS))])
def test_split_fleet_config_equals_the_jax_split(dotlist):
    from video_features_tpu import config as jax_config
    from video_features_torch import config
    out = {}
    for name, mod in (('jax', jax_config), ('port', config)):
        try:
            fleet, extra = mod.split_fleet_config(mod.parse_dotlist(dotlist))
            out[name] = ('ok', dict(fleet), dict(extra))
        except ValueError as e:
            out[name] = ('error', str(e))
    assert out['port'] == out['jax']
    assert config.FLEET_DEFAULTS == jax_config.FLEET_DEFAULTS


def test_merge_expositions_equals_the_jax_merge():
    from video_features_tpu.fleet import aggregate as jax_aggregate
    from video_features_torch.fleet import aggregate
    texts = {
        'a:1': ('# HELP vft_up liveness\n# TYPE vft_up gauge\nvft_up 1\n'
                '# HELP vft_lat_seconds lat\n# TYPE vft_lat_seconds histogram\n'
                'vft_lat_seconds_bucket{le="0.1"} 3\n'
                'vft_lat_seconds_sum 0.2\nvft_lat_seconds_count 3\n'
                '# free comment\nnot exposition at all\n'),
        'b:2': ('# TYPE vft_up gauge\nvft_up{x="q\\"z"} 0 1700000000\n'
                '# HELP vft_only_headers h\n'),
        'c:3': None, 'd:4': '',
    }
    assert aggregate.merge_expositions(texts) == \
        jax_aggregate.merge_expositions(texts)
    assert aggregate.merge_expositions({}) == ''


# -- the router against fake backends ---------------------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('127.0.0.1', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _FakeBackend:
    """The JAX tests' fake backend, bound to a given port so that both
    routers see the same addresses (and so the same ring)."""

    def __init__(self, respond, port):
        self.respond = respond
        self.calls = []
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(('127.0.0.1', port))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.addr = f'127.0.0.1:{self.port}'
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            with conn:
                rfile, wfile = conn.makefile('rb'), conn.makefile('wb')
                for line in rfile:
                    msg = protocol.decode(line)
                    self.calls.append(msg['cmd'])
                    wfile.write(protocol.encode(self.respond(msg)))
                    wfile.flush()
        except (OSError, ValueError):
            pass

    def kill(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _healthy(msg, **submit_fields):
    if msg['cmd'] == protocol.CMD_PING:
        return protocol.ok(draining=False, v=protocol.VERSION)
    if msg['cmd'] == protocol.CMD_SUBMIT:
        return protocol.ok(request_id='r1', **submit_fields)
    if msg['cmd'] == protocol.CMD_STATUS:
        return protocol.ok(request_id=msg.get('request_id'), state='done')
    if msg['cmd'] == protocol.CMD_METRICS:
        return protocol.ok(metrics={'queue': {'depth': 2},
                                    'cache': {'hit_rate': 0.25},
                                    'warm_pool': {'builds_compiled': 1,
                                                  'builds_loaded': 0}})
    return protocol.error('unknown', code=protocol.ERR_INVALID)


def _router(pkg, hosts, **kw):
    opts = dict(port=0, probe_interval_s=30.0, backoff_base_s=0.005,
                connect_timeout_s=0.5)
    opts.update(kw)
    return _router_cls(pkg)(hosts, **opts).start()


def _call(client, msg):
    """A response, or the structured error it raised, as data."""
    try:
        return client._call(dict(msg))
    except ServeError as e:
        return {'error_code': e.code, 'retryable': e.retryable}


def _counters(client):
    fleet = client.metrics()['fleet']
    return {k: fleet[k] for k in ('routed', 'failovers', 'rejected',
                                  'eligible', 'hosts', 'draining')} | {
        'backends': {a: {k: r.get(k) for k in (
            'healthy', 'draining', 'consecutive_failures', 'queue_depth',
            'cache_hit_rate', 'builds_compiled', 'builds_loaded')}
            for a, r in fleet['backends'].items()}}


def scenario_sheds_failover_and_code_propagation(pkg, ports):
    ok = _FakeBackend(_healthy, ports[0])
    shed = _FakeBackend(lambda m: _healthy(m) if m['cmd'] != 'submit'
                        else protocol.error('queue full (64/64)',
                                            code=protocol.ERR_SHED), ports[1])
    router = _router(pkg, [shed.addr, ok.addr])
    try:
        client = ServeClient(router.port)
        rec = {'ping': client.ping(),
               'submits': [_call(client, {'cmd': 'submit',
                                          'video_paths': [f'/v/{i}.mp4']})
                           for i in range(8)]}
        rec['counters'] = _counters(client)
        rec['status'] = [_call(client, {'cmd': 'status', 'request_id': r})
                         for r in ('r1', 'never')]
        assert rec['counters']['routed'][ok.addr] == 8
        assert rec['counters']['failovers'] > 0
        assert rec['status'][1]['error_code'] == protocol.ERR_NOT_FOUND
    finally:
        router.stop()
        ok.kill()
        shed.kill()
    return rec, {'ok': ok.calls, 'shed': shed.calls}


def scenario_invalid_request_never_retries(pkg, ports):
    def invalid(msg):
        if msg['cmd'] == protocol.CMD_PING:
            return protocol.ok(draining=False)
        return protocol.error('unknown feature_type zzz',
                              code=protocol.ERR_INVALID)
    b1, b2 = _FakeBackend(invalid, ports[0]), _FakeBackend(invalid, ports[1])
    router = _router(pkg, [b1.addr, b2.addr])
    try:
        client = ServeClient(router.port)
        rec = {'submit': _call(client, {'cmd': 'submit', 'feature_type': 'zzz',
                                        'video_paths': ['/v/a.mp4']})}
        assert rec['submit']['error_code'] == protocol.ERR_INVALID
        assert (b1.calls + b2.calls).count('submit') == 1
    finally:
        router.stop()
        b1.kill()
        b2.kill()
    return rec, {'b1': b1.calls, 'b2': b2.calls}


def scenario_kill_midstream_survivor_takes_over(pkg, ports):
    b1, b2 = _FakeBackend(_healthy, ports[0]), _FakeBackend(_healthy, ports[1])
    router = _router(pkg, [b1.addr, b2.addr], max_attempts=2)
    try:
        client = ServeClient(router.port)
        rec = {'eligible0': sorted(router.eligible())}
        b1.kill()
        rec['submits'] = [_call(client, {'cmd': 'submit',
                                         'video_paths': [f'/v/{i}.mp4']})
                          for i in range(8)]
        rec['eligible1'] = router.eligible()
        table = router.probe()
        rec['probe'] = {a: (r['healthy'], r['draining']) for a, r in
                        table.items()}
        b2.kill()
        router.probe()
        rec['both_dead'] = _call(client, {'cmd': 'submit',
                                          'video_paths': ['/v/z.mp4']})
        rec['counters'] = _counters(client)
        assert all(s.get('backend') == b2.addr for s in rec['submits'])
        assert rec['both_dead'] == {'error_code': protocol.ERR_SHED,
                                    'retryable': True}
    finally:
        router.stop()
    return rec, {'b1': b1.calls, 'b2': b2.calls}


def scenario_drain_aware_membership(pkg, ports):
    state = {'draining': False}

    def drainable(msg):
        if msg['cmd'] == protocol.CMD_PING:
            return protocol.ok(draining=state['draining'])
        return _healthy(msg)
    d, ok = _FakeBackend(drainable, ports[0]), _FakeBackend(_healthy, ports[1])
    router = _router(pkg, [d.addr, ok.addr])
    try:
        client = ServeClient(router.port)
        rec = {'eligible0': sorted(router.eligible())}
        state['draining'] = True
        router.probe()
        rec['eligible1'] = router.eligible()
        rec['submits'] = [_call(client, {'cmd': 'submit',
                                         'video_paths': [f'/v/{i}.mp4']})
                          for i in range(4)]
        state['draining'] = False
        router.probe()
        rec['eligible2'] = sorted(router.eligible())
        rec['counters'] = _counters(client)
        rec['drain'] = _call(client, {'cmd': 'drain'})
        rec['after_drain'] = _call(client, {'cmd': 'submit',
                                            'video_paths': ['/v/x.mp4']})
        assert rec['eligible1'] == [ok.addr]
    finally:
        router.stop()
        d.kill()
        ok.kill()
    return rec, {'d': d.calls, 'ok': ok.calls}


def scenario_failover_yields_one_merged_trace(pkg, ports):
    captured = {}

    def traced(tag, shed_submit=False):
        def respond(msg):
            if msg['cmd'] == protocol.CMD_PING:
                return protocol.ok(draining=False)
            if msg['cmd'] == protocol.CMD_SUBMIT:
                captured[tag] = msg.get('traceparent')
                if shed_submit:
                    return protocol.error('queue full (64/64)',
                                          code=protocol.ERR_SHED)
                return protocol.ok(request_id='r-trace')
            if msg['cmd'] == protocol.CMD_TRACE:
                tid = captured[tag].split('-')[1]
                return protocol.ok(
                    request_id=msg.get('request_id'), trace_id=tid,
                    state='done',
                    events=[{'name': f'{tag}_admission', 'ph': 'X',
                             'ts': 10.0 if shed_submit else 20.0,
                             'dur': 5.0, 'pid': 1, 'tid': 1,
                             'args': {'trace_id': tid}}])
            return protocol.error('unknown', code=protocol.ERR_INVALID)
        return respond
    shed = _FakeBackend(traced('shed', shed_submit=True), ports[0])
    ok = _FakeBackend(traced('ok'), ports[1])
    router = _router(pkg, [shed.addr, ok.addr])
    cls = _router_cls(pkg)
    try:
        path = next(p for p in (f'/v/trace{i}.mp4' for i in range(200))
                    if router.ring.host_for(cls.route_key(
                        {'video_paths': [p]})) == shed.addr)
        client = ServeClient(router.port)
        resp = client._call({'cmd': 'submit', 'video_paths': [path]})
        w3c = re.compile(r'^00-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}$')
        tid = captured['ok'].split('-')[1]
        trace = client.trace(resp['request_id'])
        by_host = {}
        for e in trace['events']:
            if e.get('ph') != 'M':
                host = {shed.addr: 'shed', ok.addr: 'ok'}.get(
                    e['args']['host'], e['args']['host'])
                by_host.setdefault(host, []).append(e['name'])
        ts = [e['ts'] for e in trace['events'] if e.get('ph') != 'M']
        rec = {'path': path, 'backend': resp['backend'],
               'w3c': [bool(w3c.match(captured[t])) for t in ('shed', 'ok')],
               'one_trace_id': captured['shed'].split('-')[1] == tid
               == trace['trace_id'],
               'hosts': sorted(trace['hosts']), 'state': trace['state'],
               'by_host': {h: sorted(v) for h, v in by_host.items()},
               'ts_sorted': ts == sorted(ts),
               'counters': _counters(client)}
        assert rec['by_host']['router'].count('backend_call') == 2
        assert 'failover' in rec['by_host']['router']
    finally:
        router.stop()
        shed.kill()
        ok.kill()
    return rec, {'shed': shed.calls, 'ok': ok.calls}


def _prom_shape(text):
    """Sample names with their labels, values left out (times differ)."""
    return [line.rsplit(' ', 1)[0] if not line.startswith('#') else line
            for line in text.splitlines()]


def scenario_metrics_prom_aggregates_host_labeled_families(pkg, ports):
    def with_prom(msg):
        if msg['cmd'] == protocol.CMD_METRICS_PROM:
            return protocol.ok(text='# HELP vft_up liveness\n'
                                    '# TYPE vft_up gauge\n'
                                    'vft_up 1\n')
        return _healthy(msg)
    b1, b2 = _FakeBackend(with_prom, ports[0]), _FakeBackend(with_prom,
                                                             ports[1])
    router = _router(pkg, [b1.addr, b2.addr])
    try:
        client = ServeClient(router.port)
        rec = {'submit': _call(client, {'cmd': 'submit',
                                        'video_paths': ['/v/a.mp4']})}
        text = client.metrics_prom()
        rec['prom'] = _prom_shape(text)
        assert text.count('# TYPE vft_up gauge') == 1
        assert f'vft_up{{host="{b1.addr}"}} 1' in text
        b2.kill()
        router.probe()
        text = router.metrics_prom()
        rec['prom_one_dead'] = _prom_shape(text)
        assert f'vft_fleet_backend_up{{host="{b2.addr}"}} 0' in text
    finally:
        router.stop()
        b1.kill()
        b2.kill()
    return rec, {'b1': b1.calls, 'b2': b2.calls}


SCENARIOS = [scenario_sheds_failover_and_code_propagation,
             scenario_invalid_request_never_retries,
             scenario_kill_midstream_survivor_takes_over,
             scenario_drain_aware_membership,
             scenario_failover_yields_one_merged_trace,
             scenario_metrics_prom_aggregates_host_labeled_families]


def _scrub(rec):
    """Traceparents are minted per run: leave them out."""
    text = json.dumps(rec, sort_keys=True)
    return json.loads(re.sub(r'00-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}',
                             'TRACEPARENT', text))


@pytest.mark.parametrize('scenario', SCENARIOS,
                         ids=[s.__name__[len('scenario_'):] for s in SCENARIOS])
def test_router_scenarios_equal_the_jax_routers(scenario):
    ports = _free_ports(2)
    runs = {pkg: scenario(pkg, ports) for pkg in PKGS}
    assert _scrub(runs['port'][0]) == _scrub(runs['jax'][0])
    assert runs['port'][1] == runs['jax'][1]


def test_route_key_is_the_content_hash(tmp_path):
    from video_features_torch.cache.key import hash_file
    JaxRouter, PortRouter = _router_cls('jax'), _router_cls('port')
    clip = tmp_path / 'c.bin'
    clip.write_bytes(b'x' * 1000)
    for msg in ({'video_paths': [str(clip)]}, {'video_path': str(clip)},
                {'video_paths': ['/no/such.mp4']}, {'family': 'resnet'}):
        assert PortRouter.route_key(msg) == JaxRouter.route_key(msg)
    assert PortRouter.route_key({'video_paths': [str(clip)]}) == \
        hash_file(str(clip))


# -- the command line and the health table -----------------------------------


def _start_cli(argv, n_lines):
    proc = subprocess.Popen([sys.executable, '-m', *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines = [proc.stdout.readline().rstrip('\n') for _ in range(n_lines)]
    return proc, lines


def test_fleet_command_lines_equal_the_jax_routers(tmp_path):
    keys = tmp_path / 'keys.yml'
    keys.write_text('keys:\n  k1: {tenant: acme}\n')
    b = _FakeBackend(_healthy, 0)
    pattern = re.compile(
        r'^fleet router on 127\.0\.0\.1:(\d+) \(pid (\d+); backends='
        + re.escape(b.addr) + r', eligible=1\)$')
    try:
        for module in ('video_features_tpu', 'video_features_torch'):
            proc, lines = _start_cli(
                [module, 'fleet', f'fleet_hosts=[{b.addr}]', 'fleet_port=0',
                 'fleet_http_port=0', f'fleet_auth_file={keys}'], 2)
            try:
                m = pattern.match(lines[0])
                assert m, lines
                assert re.match(r'^fleet ingress on 127\.0\.0\.1:\d+$',
                                lines[1]), lines
                client = ServeClient(int(m.group(1)))
                assert client.ping()
                if module == 'video_features_torch':
                    maps = Path(f'/proc/{proc.pid}/maps').read_text()
                    assert 'libtorch' not in maps and 'libcuda' not in maps
            finally:
                proc.send_signal(signal.SIGTERM)
                out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
            assert out.strip().splitlines()[-1] == 'fleet: stopped, exiting'
        for module in ('video_features_tpu', 'video_features_torch'):
            proc = subprocess.run([sys.executable, '-m', module, 'fleet',
                                   'feature_type=resnet',
                                   f'fleet_hosts=[{b.addr}]'], cwd=REPO,
                                  capture_output=True, text=True, timeout=60)
            assert proc.returncode != 0
            assert "unknown fleet keys: ['feature_type']" in proc.stderr
    finally:
        b.kill()


def _status_pair(capsys, argv):
    import tools.fleet_status as jax_status
    from video_features_torch.fleet import status
    out = {}
    for name, fn in (('jax', jax_status.main), ('port', status.main)):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        text = re.sub(r'uptime=[0-9.]+s', 'uptime=Us', cap.out)
        text = re.sub(r'(healthy|DOWN)( +)[0-9.]+ ', r'\1\2A ', text)
        out[name] = (rc, text, cap.err)
    return out


@pytest.mark.parametrize('case', ['healthy', 'degraded', 'down', 'json'])
def test_fleet_status_rows_and_exit_codes_equal_the_jax_tools(capsys, case):
    state = {'draining': case == 'degraded'}

    def respond(msg):
        if msg['cmd'] == protocol.CMD_PING:
            return protocol.ok(draining=state['draining'])
        return _healthy(msg)
    ports = _free_ports(2)
    b1, b2 = _FakeBackend(respond, ports[0]), _FakeBackend(_healthy, ports[1])
    router = _router('port', [b1.addr, b2.addr])
    try:
        if case == 'down':
            b1.kill()
            b2.kill()
            router.probe()
        argv = ['--port', str(router.port)] + (['--json'] if case == 'json'
                                               else [])
        out = _status_pair(capsys, argv)
        if case == 'json':
            docs = {n: json.loads(o[1]) for n, o in out.items()}
            for d in docs.values():
                d.pop('uptime_s')
                for row in d['backends'].values():
                    row.pop('probe_age_s')
                    row.pop('last_probe_t')
            assert docs['port'] == docs['jax']
        else:
            assert out['port'] == out['jax']
        assert out['port'][0] == {'healthy': 0, 'degraded': 1, 'down': 2,
                                  'json': 0}[case]
    finally:
        router.stop()
        b1.kill()
        b2.kill()
    unreachable = _status_pair(capsys, ['--port', str(_free_ports(1)[0]),
                                        '--timeout-s', '0.2'])
    assert unreachable['port'][0] == unreachable['jax'][0] == 2


# -- a real fleet --------------------------------------------------------------


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet_base(root, tag, ckpt):
    return {'device': 'cpu', 'model_name': 'resnet18', 'batch_size': 4,
            'checkpoint_path': ckpt, 'on_extraction': 'save_numpy',
            'tmp_path': str(root / f'{tag}_tmp'), 'cache_enabled': True,
            'cache_dir': str(root / f'{tag}_cache'),
            'cache_l2_dir': str(root / 'shared')}


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def test_two_port_daemons_behind_the_port_router_hold_the_jax_fleet(
        tmp_path):
    from video_features_tpu.serve.server import ExtractionServer as JaxServer
    from video_features_torch.models import resnet
    from video_features_torch.serve.server import ExtractionServer
    from video_features_torch.utils.output import load_numpy, make_path
    ckpt = tmp_path / 'resnet18.pt'
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet.init_state_dict(seed=0, arch='resnet18').items()}, ckpt)
    clips = [str(write_noise_clip(tmp_path / f'fl{i}.mp4', n, seed=60 + i))
             for i, n in enumerate((4, 3, 5))]
    outputs = {}
    for pkg, server_cls in (('jax', JaxServer), ('port', ExtractionServer)):
        root = tmp_path / pkg
        servers = [server_cls(base_overrides=_fleet_base(root, t, str(ckpt)),
                              queue_depth=16, pool_size=2).start()
                   for t in ('a', 'b')]
        addrs = [f'127.0.0.1:{s.port}' for s in servers]
        router = _router(pkg, addrs)
        try:
            client = ServeClient(router.port)
            out = str(root / 'out')
            for clip in clips:
                resp = client._call({'cmd': 'submit', 'feature_type': 'resnet',
                                     'video_paths': [clip],
                                     'overrides': {'output_path': out}})
                owner = router.ring.host_for(_router_cls(pkg).route_key(
                    {'video_paths': [clip]}))
                assert resp['backend'] == owner
                st = client.wait(resp['request_id'], timeout_s=240)
                assert st['state'] == 'done' and st['videos'][clip] == 'saved'
            routed = client.metrics()['fleet']['routed']
            assert sum(routed.values()) == len(clips)
            outputs[pkg] = {c: load_numpy(make_path(
                os.path.join(out, 'resnet', 'resnet18'), c, 'resnet', '.npy'))
                for c in clips}
        finally:
            router.stop()
            for s in servers:
                s.drain(wait=True, grace_s=60)
    for clip in clips:
        assert outputs['port'][clip].shape == outputs['jax'][clip].shape
        assert _rel_l2(outputs['port'][clip], outputs['jax'][clip]) <= 1e-5
