"""The port's warm-pool daemon (video_features_torch/serve/) on the CPU,
over real loopback sockets: against the JAX package's daemon on the same
checkpoint and clips (the same files, arrays within 1e-5, the same
status states, metric keys and Prometheus families), its lifecycle (one
build for two requests, the CLI's bytes, a broken video failing alone, a
SIGTERMed ``python -m video_features_torch serve`` draining, a restart
resuming), admission (deadlines, shedding ``batch`` before
``interactive``, every refused field named) and fused requests."""
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.serve.client import ServeClient, ServeError
from video_features_torch.serve.server import ExtractionServer
from video_features_torch.utils.output import make_path

REPO = Path(__file__).resolve().parents[1]
REL_L2 = 1e-5
RESNET_KEYS = ('resnet', 'fps', 'timestamps_ms')
# the metrics document's section that differs by design: the JAX
# package's executable store (the port has none, README's port section)
DIVERGENT_SECTIONS = {'aot'}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp('servevids')
    return [write_noise_clip(d / f'sv{i}.mp4', n, seed=i)
            for i, n in enumerate((9, 4))]


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """One seeded resnet18 state_dict, loaded by both daemons."""
    from video_features_torch.models import resnet
    path = tmp_path_factory.mktemp('ckpt') / 'resnet18.pt'
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet.init_state_dict(seed=0, arch='resnet18').items()}, path)
    return str(path)


def _base(tmp_path, ckpt=None, **extra):
    base = {'device': 'cpu', 'model_name': 'resnet18', 'batch_size': 4,
            'on_extraction': 'save_numpy', 'tmp_path': str(tmp_path / 'tmp')}
    if ckpt is None:
        base['allow_random_weights'] = True
    else:
        base['checkpoint_path'] = ckpt
    base.update(extra)
    return base


def _npys(root):
    return {str(f.relative_to(root)): f for f in sorted(Path(root).rglob('*.npy'))}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _families(prom_text):
    return {m.group(1) for m in re.finditer(r'^# TYPE (\S+) ', prom_text,
                                             re.MULTILINE)}


def _keys(doc, depth=2):
    """The document's key paths down to ``depth``, leaving out the stage
    tables (their stage names are each loop's own) and what is inside the
    divergent sections."""
    out = set()
    for k, v in doc.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict) and k not in (
                'stages', 'stages_merged', 'placements', *DIVERGENT_SECTIONS):
            out |= {f'{k}.{sub}' for sub in _keys(v, depth - 1)}
    return out


# -- (a) the same answers as the JAX package's daemon ---------------------------


def test_answers_equal_the_jax_daemons(clips, ckpt, tmp_path):
    import logging

    from video_features_tpu.obs.events import event as jax_event
    from video_features_tpu.serve.client import ServeClient as JaxClient
    from video_features_tpu.serve.server import ExtractionServer as JaxServer
    from video_features_torch.obs.events import event
    # vft_events_total renders once a process has counted an event, which
    # depends on what ran before in this process: count one on each side
    for emit in (jax_event, event):
        emit(logging.INFO, 'serve parity test', subsystem='test')
    results = {}
    for name, server_cls, client_cls in (
            ('jax', JaxServer, JaxClient), ('port', ExtractionServer,
                                            ServeClient)):
        server = server_cls(base_overrides=_base(tmp_path / name, ckpt),
                            queue_depth=32, pool_size=2).start()
        try:
            # a client of the JAX wire talks to both daemons
            client = JaxClient(port=server.port)
            out = tmp_path / name / 'out'
            rid = client.submit('resnet', clips,
                                overrides={'output_path': str(out)})
            st = client.wait(rid, timeout_s=300)
            results[name] = (out, st, client.metrics(), client.metrics_prom())
        finally:
            server.drain(wait=True, grace_s=120)
    (jout, jst, jm, jprom), (out, st, m, prom) = results['jax'], results['port']
    assert st['state'] == jst['state'] == 'done'
    assert set(st) == set(jst) and st['videos'] == {
        p: s for p, s in zip(clips, ('saved', 'saved'))} == jst['videos']
    got, want = _npys(out), _npys(jout)
    assert sorted(got) == sorted(want) and len(got) == 2 * len(RESNET_KEYS)
    for rel, path in want.items():
        a, b = np.load(got[rel]), np.load(path)
        assert a.shape == b.shape and a.dtype == b.dtype, rel
        assert rel_l2(a, b) <= REL_L2, rel
    assert _keys(m) == _keys(jm)
    assert m['aot'] == {} and m['warm_pool']['builds_compiled'] == 1
    assert (m['requests'], m['warm_pool']['misses']) == (jm['requests'], 1)
    assert _families(prom) == {f for f in _families(jprom)
                               if not f.startswith('vft_aot_')}


# -- (b) the lifecycle ------------------------------------------------------------


def _serve_subprocess(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, '-m', 'video_features_torch', 'serve', *args],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    m = re.match(r'serving on ([\d.]+):(\d+) ', line)
    assert m, (line, proc.stderr.read() if proc.poll() is not None else '')
    return proc, int(m.group(2))


def test_lifecycle_warm_cli_bytes_fault_sigterm_resume(clips, tmp_path,
                                                       monkeypatch):
    import video_features_torch.serve.server as server_mod
    from video_features_torch import cli
    builds = []
    real_create = server_mod.create_extractor
    monkeypatch.setattr(server_mod, 'create_extractor',
                        lambda args: builds.append(args['feature_type'])
                        or real_create(args))
    server = ExtractionServer(base_overrides=_base(tmp_path),
                              queue_depth=32, pool_size=2).start()
    try:
        client = ServeClient(port=server.port)
        assert client.ping()
        roots = []
        for i in range(2):
            out = str(tmp_path / f'p{i}')
            rid = client.submit('resnet', clips, overrides={'output_path': out})
            st = client.wait(rid, timeout_s=180)
            assert st['state'] == 'done' and set(st['videos'].values()) == {
                'saved'}, st
            roots.append(os.path.join(out, 'resnet', 'resnet18'))
        assert builds == ['resnet']            # warm: built once
        m = client.metrics()
        assert (m['warm_pool']['misses'], m['warm_pool']['hits']) == (1, 1)
        assert m['requests']['completed'] == 2
        # the port's CLI (the per-video loop) writes the same bytes
        ref = tmp_path / 'ref'
        assert cli.main([f'{k}={v}' for k, v in _base(tmp_path).items()]
                        + ['feature_type=resnet', f'output_path={ref}',
                           f'video_paths=[{",".join(clips)}]']) in (0, None)
        want = _npys(ref / 'resnet' / 'resnet18')
        for root in roots:
            got = _npys(root)
            assert sorted(got) == sorted(want)
            for rel in want:
                assert got[rel].read_bytes() == want[rel].read_bytes(), rel
        # a broken video in the batch fails alone
        bad = str(tmp_path / 'missing.mp4')
        rid = client.submit('resnet', [clips[0], bad, clips[1]],
                            overrides={'output_path': str(tmp_path / 'p3')})
        st = client.wait(rid, timeout_s=180)
        assert st['state'] == 'partial'
        assert st['videos'] == {clips[0]: 'saved', bad: 'failed',
                                clips[1]: 'saved'}
    finally:
        server.drain(wait=True, grace_s=120)

    # SIGTERM drains a daemon started from the command line
    out = str(tmp_path / 'p4')
    args = [f'{k}={v}' for k, v in _base(tmp_path).items()]
    proc, port = _serve_subprocess(args, tmp_path)
    try:
        rid = ServeClient(port=port).submit('resnet', clips,
                                            overrides={'output_path': out})
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr
    assert 'serve: drained, exiting' in stdout
    root = Path(out) / 'resnet' / 'resnet18'
    files = {p: Path(make_path(str(root), p, 'resnet', '.npy')) for p in clips}
    assert all(f.exists() for f in files.values()), rid
    mtimes = {p: f.stat().st_mtime_ns for p, f in files.items()}
    # a restarted server skips what is done
    server = ExtractionServer(base_overrides=_base(tmp_path)).start()
    try:
        client = ServeClient(port=server.port)
        st = client.wait(client.submit('resnet', clips,
                                       overrides={'output_path': out}),
                         timeout_s=180)
        assert st['state'] == 'done'
        assert set(st['videos'].values()) == {'skipped'}
        assert {p: f.stat().st_mtime_ns for p, f in files.items()} == mtimes
    finally:
        server.drain(wait=True, grace_s=120)


# -- (c) admission and refusals -----------------------------------------------------


@pytest.fixture(scope='module')
def small_server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('small')
    server = ExtractionServer(base_overrides=_base(tmp), queue_depth=4,
                              batch_shed_fraction=0.5).start()
    yield server, tmp
    server.drain(wait=True, grace_s=120)


def test_deadlines_and_shedding_batch_before_interactive(small_server, clips):
    server, tmp = small_server
    client = ServeClient(port=server.port)
    missing = [str(tmp / f'x{i}.mp4') for i in range(3)]
    out = {'output_path': str(tmp / 'o')}
    with pytest.raises(ServeError, match='queue_full') as e:
        client.submit('resnet', missing, overrides=out, priority='batch')
    assert e.value.code == 'shed' and e.value.extra['capacity'] == 2
    st = client.wait(client.submit('resnet', missing, overrides=out,
                                   priority='interactive'), timeout_s=180)
    assert st['state'] == 'failed' and set(st['videos'].values()) == {'failed'}
    with pytest.raises(ServeError, match='queue_full'):
        client.submit('resnet', missing + [clips[0], clips[1]], overrides=out)
    st = client.wait(client.submit('resnet', clips, timeout_s=0.0,
                                   overrides={'output_path': str(tmp / 'od')}),
                     timeout_s=120)
    assert st['state'] == 'failed'
    assert set(st['videos'].values()) == {'expired'}
    m = client.metrics()
    assert m['requests']['expired_videos'] == 2
    assert m['requests']['rejected'] >= 2
    with pytest.raises(ServeError, match='unknown submit fields'):
        client._call({'cmd': 'submit', 'feature_type': 'resnet',
                      'video_paths': clips, 'surprise': 1})
    with pytest.raises(ServeError, match='vggish'):
        client.submit('vggish', clips, overrides=out)


@pytest.mark.parametrize('field', ['range', 'search', 'index_status', 'live'])
def test_unported_fields_answer_naming_themselves(small_server, clips, field):
    server, tmp = small_server
    client = ServeClient(port=server.port)
    if field == 'live':
        resp = server.submit_live('resnet', session=object())
        assert resp['ok'] is False and resp['code'] == 'unsupported'
        assert resp['error'].startswith('live is not ported yet: live sessions')
        with pytest.raises(NotImplementedError, match='attach_ingress'):
            server.attach_ingress(object())
        return
    with pytest.raises(ServeError) as e:
        if field == 'range':
            client.submit('resnet', clips, range_s=[0.0, 0.1],
                          overrides={'output_path': str(tmp / 'r')})
        elif field == 'search':
            client.search(family='resnet', vector=[0.0] * 512)
        else:
            client.index_status()
    assert str(e.value).startswith(f'{field} is not ported yet')
    assert e.value.code == 'unsupported'


def test_no_gpu_without_device_cpu_names_device(clips, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    base = _base(tmp_path)
    del base['device']
    server = ExtractionServer(base_overrides=base).start()
    try:
        with pytest.raises(ServeError, match='device') as e:
            ServeClient(port=server.port).submit(
                'resnet', clips, overrides={'output_path': str(tmp_path / 'o')})
        assert e.value.code == 'invalid'
    finally:
        server.drain(wait=True, grace_s=60)


# -- (d) fused requests --------------------------------------------------------------


def test_fused_request_equals_the_solo_requests(clips, tmp_path):
    server = ExtractionServer(base_overrides=_base(tmp_path)).start()
    try:
        client = ServeClient(port=server.port)
        fused_out = str(tmp_path / 'fused')
        rid = client._call({'cmd': 'submit', 'features': ['resnet', 'clip'],
                            'video_paths': clips,
                            'overrides': {'output_path': fused_out,
                                          'clip.model_name': 'ViT-B/32'}}
                           )['request_id']
        st = client.wait(rid, timeout_s=300)
        assert st['state'] == 'done' and st['features'] == ['resnet', 'clip']
        assert set(st['requests']) == {'resnet', 'clip'}
        for fam in ('resnet', 'clip'):
            assert set(st['videos'][fam].values()) == {'saved'}
        for fam, overrides in (('resnet', {}),
                               ('clip', {'model_name': 'ViT-B/32'})):
            solo_out = str(tmp_path / f'solo_{fam}')
            st = client.wait(client.submit(
                fam, clips, overrides={'output_path': solo_out, **overrides}),
                timeout_s=300)
            assert st['state'] == 'done'
            sub = {'resnet': 'resnet/resnet18', 'clip': 'clip/ViT-B_32'}[fam]
            want = _npys(Path(solo_out) / sub)
            got = _npys(Path(fused_out) / sub)
            assert sorted(got) == sorted(want) and want
            for rel in want:
                assert got[rel].read_bytes() == want[rel].read_bytes(), rel
        # each family's solo request found the fused request's entry warm
        assert client.metrics()['warm_pool']['misses'] == 2
    finally:
        server.drain(wait=True, grace_s=120)


# -- (e) the stall watchdog on the decode farm ---------------------------------------


def test_watchdog_reports_one_stall_of_a_held_worker(clips, tmp_path):
    """``watchdog_stall_s`` with two decode farm workers: a request that
    flows trips nothing; one whose device step is held past the deadline
    trips exactly one stall report, then completes."""
    from video_features_torch.obs import events
    server = ExtractionServer(base_overrides=_base(
        tmp_path, decode_workers=2, watchdog_stall_s=8.0)).start()
    try:
        client = ServeClient(port=server.port)
        st = client.wait(client.submit(
            'resnet', clips, overrides={'output_path': str(tmp_path / 'a')}),
            timeout_s=180)
        assert st['state'] == 'done'
        m = client.metrics()
        assert m['watchdog']['enabled'] and m['watchdog']['stalls_total'] == 0
        assert m['farm']['decode_workers'] == 2 and m['farm']['windows'] > 0
        before = events.event_counts().get(('ERROR', 'watchdog'), 0)
        ex = server.pool.entries()[0].ex
        step, tripped = ex.packed_step, threading.Event()

        def held_step(batch):
            # hold the card's step until the watchdog has seen the stall
            deadline = time.monotonic() + 60
            while server.watchdog.stalls_total == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            tripped.set()
            return step(batch)
        ex.packed_step = held_step
        st = client.wait(client.submit(
            'resnet', clips, overrides={'output_path': str(tmp_path / 'b')}),
            timeout_s=180)
        assert tripped.is_set() and st['state'] == 'done'
        m = client.metrics()
        assert m['watchdog']['stalls_total'] == 1
        assert events.event_counts()[('ERROR', 'watchdog')] == before + 1
        stall = [e for e in events.events_tail(50)
                 if e['msg'] == 'watchdog: worker stalled with queued work']
        assert stall[-1]['fields']['worker'].startswith('resnet/resnet18#')
        assert 'vft_watchdog_stalls_total' in client.metrics_prom()
    finally:
        server.drain(wait=True, grace_s=120)


def test_prewarm_builds_and_steps_each_spec_once(clips, tmp_path):
    """``serve_prewarm``: each spec is built and stepped once on a zero
    batch of its window (a duplicate spec is one entry; ``index`` names
    the refused feature index); the first request then finds it warm."""
    server = ExtractionServer(base_overrides=_base(tmp_path)).start()
    try:
        report = server.prewarm(['resnet', 'resnet', 'index'])
        assert report == {'entries': 1, 'programs_loaded': 0,
                          'programs_compiled': 1,
                          'errors': ['index: index_enabled is false']}
        ex = server.pool.entries()[0].ex
        assert ex.warm_window().shape == (224, 224, 3)
        client = ServeClient(port=server.port)
        st = client.wait(client.submit(
            'resnet', clips, overrides={'output_path': str(tmp_path / 'o')}),
            timeout_s=180)
        assert st['state'] == 'done'
        pool = client.metrics()['warm_pool']
        assert (pool['hits'], pool['misses'], pool['builds_compiled']) == (1, 0, 1)
    finally:
        server.drain(wait=True, grace_s=120)
