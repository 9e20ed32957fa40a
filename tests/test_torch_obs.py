"""The port's flight recorder (video_features_torch/obs/ and its hooks in
utils/tracing.py, extract/base.py, parallel/packing.py, farm/farm.py and
the CLI) on the CPU, held against the JAX package's (video_features_tpu/
obs/, tests/test_obs.py): the stage names, the key sets of the tracer's
records, of trace events and of the run manifest, Prometheus text, trace
context, trace validity (tools/trace_view.py), black-box bundles (the
JAX package's ``validate_bundle``), and CLI runs whose manifests give the
JAX runs' outcomes on the same clips.
"""
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tools.make_sample_video import write_noise_clip
from tools.trace_view import main as trace_view_main
from tools.trace_view import validate_events as jax_validate_events
from video_features_torch.obs import blackbox, context, events, metrics, spans
from video_features_torch.obs.manifest import RunManifest
from video_features_torch.utils import tracing

from video_features_tpu.obs import blackbox as jax_blackbox
from video_features_tpu.obs import context as jax_context
from video_features_tpu.obs import metrics as jax_metrics
from video_features_tpu.obs import spans as jax_spans
from video_features_tpu.utils import tracing as jax_tracing

REPO = Path(__file__).resolve().parent.parent

# tests/test_obs.py's schema contracts
TRACER_RECORD_KEYS = {'count', 'total_s', 'mean_s', 'max_s', 'first_s',
                      'ramp', 'occupancy', 'occ_valid', 'occ_capacity',
                      'occ_device'}
TRACE_EVENT_KEYS = {'name', 'ph', 'ts', 'dur', 'pid', 'tid', 'args', 's'}
MANIFEST_KEYS = {'schema', 'version', 'started_at_unix_s', 'wall_s',
                 'config', 'fingerprints', 'videos', 'outcomes', 'stages',
                 'compile', 'executables', 'farm', 'mesh', 'ingress',
                 'programs_lock', 'aot', 'index', 'slo'}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several workers per machine."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the vocabulary and the key sets ------------------------------------------


def test_stages_equal_the_jax_packages():
    assert tracing.STAGES == jax_tracing.STAGES


def _traced(mod):
    rec_mod = spans if mod is tracing else jax_spans
    rec = rec_mod.SpanRecorder(capacity=64)
    t = mod.Tracer(enabled=True, recorder=rec)
    for _ in range(2):
        with t.stage('model', video='v.mp4', valid=3):
            pass
    t.add('decode', 0.25, t0=10.0, span_pid=4242, span_tid=7, video='w.mp4',
          worker=7)
    t.add_occupancy('model', 3, 4)
    return t, rec


def test_tracer_records_and_events_have_the_jax_key_sets():
    """The same stage calls give report records and span events with the
    JAX package's keys, within tests/test_obs.py's contracts."""
    (t, rec), (jt, jrec) = _traced(tracing), _traced(jax_tracing)
    got, want = t.report(), jt.report()
    assert {k: set(v) for k, v in got.items()} == \
        {k: set(v) for k, v in want.items()}
    for r in got.values():
        assert set(r) <= TRACER_RECORD_KEYS
    assert got['model']['occupancy'] == 0.75
    evs, jevs = rec.snapshot(origin=0.0), jrec.snapshot(origin=0.0)
    assert [(e['name'], e['ph'], sorted(e)) for e in evs] == \
        [(e['name'], e['ph'], sorted(e)) for e in jevs]
    for ev in evs:
        assert set(ev) <= TRACE_EVENT_KEYS and set(ev) <= spans.TRACE_EVENT_KEYS
    decode = next(e for e in evs if e['name'] == 'decode')
    assert (decode['pid'], decode['tid'], decode['ts'], decode['dur']) == \
        (4242, 7, 10e6, 0.25e6)


def test_manifest_document_has_the_jax_key_set():
    doc = RunManifest({'feature_type': 'resnet'}).document()
    jax_doc = __import__('video_features_tpu.obs.manifest', fromlist=['x']) \
        .RunManifest({'feature_type': 'resnet'}).document()
    assert set(doc) == set(jax_doc) == MANIFEST_KEYS
    assert doc['schema'] == 'video_features_torch.run_manifest/1'
    assert doc['compile'] == {} and doc['farm'] == {}
    assert set(doc['fingerprints']) == set(jax_doc['fingerprints'])
    for key in ('mesh', 'ingress', 'programs_lock', 'aot', 'index', 'slo'):
        assert doc[key] == {}


def test_null_tracer_never_records():
    with tracing.NULL_TRACER.stage('x', video='v'):
        pass
    tracing.NULL_TRACER.add('y', 1.0, span_pid=1, video='v')
    assert tracing.NULL_TRACER.report() == {}


def test_disabled_recorder_is_noop():
    rec = spans.SpanRecorder(capacity=8, enabled=False)
    rec.span('x', 0.0, 1.0)
    rec.instant('y')
    assert [e for e in rec.snapshot() if e['ph'] != 'M'] == []


# -- metrics: the same operations, the same Prometheus text -------------------


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter('vft_requests_total', 'requests',
                labels={'outcome': 'completed'}).inc(3)
    reg.counter('vft_requests_total', labels={'outcome': 'failed'}).inc()
    reg.gauge('vft_queue_depth', 'queued videos').set(7)
    reg.gauge('vft_up', 'backend "up"\nby host (C:\\fleet)',
              labels={'host': 'bad"host\\with\nnewline'}).set(1)
    reg.gauge('vft_ratio').set(0.1 + 0.2)
    h = reg.histogram('vft_latency_seconds', 'latency',
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, float('inf')):
        h.observe(v)
    d = reg.histogram('vft_stage_seconds', 'default buckets',
                      labels={'stage': 'model'})
    for v in (0.0, 0.004, 0.3, 7.0, 301.0):
        d.observe(v)
    return reg


def test_prometheus_text_is_byte_equal_to_the_jax_packages():
    """Counters with labels, gauges (a HELP with quotes, backslashes and
    a newline, a hostile label value), a histogram with its own buckets
    and one with the default buckets render the same bytes."""
    got, want = _drive_registry(metrics), _drive_registry(jax_metrics)
    assert got.render() == want.render()
    assert json.dumps(got.collect(), sort_keys=True, default=str) == \
        json.dumps(want.collect(), sort_keys=True, default=str)
    assert metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    assert 'vft_up{host="bad\\"host\\\\with\\nnewline"} 1' in \
        got.render().splitlines()


def test_registry_rejects_type_conflicts_and_negative_inc():
    reg = metrics.MetricsRegistry()
    reg.counter('x_total')
    with pytest.raises(ValueError):
        reg.gauge('x_total')
    with pytest.raises(ValueError):
        reg.counter('y_total').inc(-1)
    assert reg.gauge('g').value == 0 and reg.gauge('g') is reg.gauge('g')


# -- trace context -------------------------------------------------------------


BAD_TRACEPARENTS = (None, '', 'not-a-traceparent',
                    '00-' + '0' * 32 + '-00f067aa0ba902b7-01',
                    '00-' + 'a' * 32 + '-' + '0' * 16 + '-01',
                    'ff-' + 'a' * 32 + '-00f067aa0ba902b7-01', '00-a' * 20)


def test_traceparent_mint_parse_and_round_trip_agree_with_jax():
    """Each package parses the other's minted header to the same trace;
    malformed, all-zero and version-ff headers are None in both (and
    mint in ``accept_traceparent``); uppercase hex normalizes."""
    for mint, parse in ((context.mint, jax_context.parse_traceparent),
                        (jax_context.mint, context.parse_traceparent)):
        ctx = mint()
        assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
        hop = parse(ctx.traceparent())
        assert hop.trace_id == ctx.trace_id and hop.span_id != ctx.span_id
    ctx = context.mint()
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert ctx.attrs() == {'trace_id': ctx.trace_id, 'span_id': ctx.span_id}
    for bad in BAD_TRACEPARENTS:
        assert context.parse_traceparent(bad) is None, bad
        assert jax_context.parse_traceparent(bad) is None, bad
        assert isinstance(context.accept_traceparent(bad), context.TraceContext)
    up = '00-' + 'A' * 32 + '-00F067AA0BA902B7-01'
    assert context.parse_traceparent(up).trace_id == \
        jax_context.parse_traceparent(up).trace_id == 'a' * 32


def test_trace_attrs_and_trace_ids_of_tasks():
    from video_features_torch.parallel.packing import VideoTask
    assert context.trace_attrs(VideoTask('a.mp4')) == {}
    assert context.trace_attrs(object()) == {}
    ctx = context.mint()
    tasks = [VideoTask('a.mp4', trace=ctx.child()), VideoTask('b.mp4'),
             VideoTask('c.mp4', trace=ctx.child())]
    assert context.trace_attrs(tasks[0])['trace_id'] == ctx.trace_id
    assert context.trace_ids_of(tasks) == [ctx.trace_id]


@pytest.mark.parametrize('value', [
    b'hello', b'\xff\x00ok', b'x' * 10_000, (1, 'a', None), {3: [b'z']},
    {'k': {1.5, 2.5}}, Path('/a/b'), 7, 0.5, True])
def test_jsonable_equals_the_jax_packages(value):
    assert spans._jsonable(value) == jax_spans._jsonable(value)
    json.dumps(spans._jsonable(value))


# -- span recorder ---------------------------------------------------------


def _record(mod, capacity):
    rec = mod.SpanRecorder(capacity=capacity)
    for i in range(10):
        rec.span(f's{i}', float(i), float(i) + 0.1, video=f'v{i}.mp4')
    rec.span('decode', 11.0, 11.5, pid=4242, tid=7, worker=7)
    rec.instant('video_done', outcome='saved')
    return rec


@pytest.mark.parametrize('capacity,limit', [(100, None), (4, None), (100, 3)])
def test_snapshots_equal_the_jax_recorders(capacity, limit):
    """The ring's drops, the limit and the pid/tid override give the JAX
    recorder's events; only the instant's clock reading differs."""
    rec, jrec = _record(spans, capacity), _record(jax_spans, capacity)
    assert rec.dropped == jrec.dropped == max(0, 12 - capacity)

    def body(r):
        return [{k: v for k, v in e.items() if not (e['ph'] == 'i' and k == 'ts')}
                for e in r.snapshot(origin=0.0, limit=limit)]
    assert body(rec) == body(jrec)
    assert spans.validate_events(rec.snapshot(limit=limit)) == []


def test_port_export_passes_trace_view(tmp_path):
    rec = _record(spans, 100)
    out = rec.export(str(tmp_path / 'sub' / 'trace.json'))
    doc = json.loads(Path(out).read_text())
    assert doc['otherData']['tool'] == 'video_features_torch'
    assert doc['otherData']['events_dropped'] == 0
    assert jax_validate_events(doc['traceEvents']) == []
    assert trace_view_main([out, '--quiet']) == 0


BAD_EVENTS = [
    {'name': 'a', 'ph': 'X', 'ts': 5.0, 'dur': 1.0, 'pid': 1, 'tid': 1},
    {'name': 'b', 'ph': 'X', 'ts': 2.0, 'dur': -1.0, 'pid': 1, 'tid': 1},
    {'name': 'c', 'ph': 'E', 'ts': 9.0, 'pid': 1, 'tid': 1},
    {'ph': 'X', 'ts': 1.0, 'pid': 1, 'tid': 1},
    {'name': 'd', 'ph': 'B', 'ts': 10.0, 'pid': 1, 'tid': 2},
    {'name': 'e', 'ph': 'X', 'ts': 11.0, 'dur': 1.0, 'pid': 1, 'tid': 1,
     'args': {'trace_id': 'a' * 32}},
]


@pytest.mark.parametrize('events', [BAD_EVENTS, BAD_EVENTS[:1],
                                    [BAD_EVENTS[0], BAD_EVENTS[4]]])
def test_port_validator_reports_what_trace_view_reports(events):
    assert spans.validate_events(events) == jax_validate_events(events)


def _merge_case(mod):
    a, b = mod.SpanRecorder(capacity=8), mod.SpanRecorder(capacity=8)
    return a, b


def test_merge_traces_aligns_recorders_on_common_origin():
    """Recorders built at different times share CLOCK; the merged export
    puts both on one origin. Each recorder's epoch is set whole, ``_t0``
    and ``_min_ts`` both, so the test holds whatever the machine's clock
    reads."""
    a, b = _merge_case(spans)
    a._t0 = a._min_ts = 100.0
    b._t0 = b._min_ts = 110.0              # b "built" 10 s later
    a.span('a_span', 100.0, 100.5)
    b.span('b_span', 110.0, 110.5)
    assert [e['ts'] for e in a.snapshot() if e['ph'] == 'X'] == [0.0]
    assert [e['ts'] for e in b.snapshot() if e['ph'] == 'X'] == [0.0]
    merged = {e['name']: e for e in spans.merge_traces([a, b])
              if e['ph'] == 'X'}
    assert merged['a_span']['ts'] == 0.0
    assert merged['b_span']['ts'] == pytest.approx(10e6)


@pytest.mark.parametrize('mod', [spans, jax_spans], ids=['port', 'jax'])
def test_overriding_t0_alone_leaves_the_construction_clock_in_origin(
        mod, monkeypatch):
    """The fault of the JAX package's version of the test above
    (tests/test_obs.py:54-70): it overrides ``_t0`` alone, and ``_min_ts``
    keeps the CLOCK reading taken at construction, which ``origin()``
    takes when it is older. On a machine up for less than 100 s (a fresh
    one) that is every time: each recorder's own snapshot is then not at
    0. Both packages' recorders behave so; the recorder is sound."""
    monkeypatch.setattr(mod, 'CLOCK', lambda: 5.0)   # 5 s after boot
    a, b = _merge_case(mod)
    a._t0, b._t0 = 100.0, 110.0
    a.span('a_span', 100.0, 100.5)
    b.span('b_span', 110.0, 110.5)
    assert a.origin() == b.origin() == 5.0
    assert [e['ts'] for e in a.snapshot() if e['ph'] == 'X'] == [95e6]
    merged = {e['name']: e for e in mod.merge_traces([a, b])
              if e['ph'] == 'X'}
    # the offsets between recorders still hold: only the origin moved
    assert merged['b_span']['ts'] - merged['a_span']['ts'] == \
        pytest.approx(10e6)


# -- the event log -------------------------------------------------------------


def test_event_counts_tail_and_stderr(caplog, capsys):
    before = events.event_counts().get(('WARNING', 'testsub'), 0)
    with caplog.at_level(logging.WARNING, logger='video_features_torch'):
        events.event(logging.WARNING, 'something odd', subsystem='testsub',
                     video='v.mp4', request_id=None, stage='decode')
        try:
            raise RuntimeError('boom for tail')
        except RuntimeError:
            events.event(logging.ERROR, 'it died', subsystem='testsub',
                         exc_info=True)
    assert events.event_counts()[('WARNING', 'testsub')] == before + 1
    rec = next(r for r in reversed(events.events_tail())
               if r['msg'] == 'something odd')
    assert rec['level'] == 'WARNING' and rec['subsystem'] == 'testsub'
    assert rec['fields'] == {'video': 'v.mp4', 'stage': 'decode'}
    assert 'boom for tail' in events.events_tail()[-1]['exc']
    captured = capsys.readouterr()
    assert captured.out == ''
    assert 'something odd [video=v.mp4 stage=decode]' in captured.err
    logged = next(r for r in caplog.records if r.getMessage().startswith(
        'something odd'))
    assert logged.name == 'video_features_torch.testsub'
    assert logged.video == 'v.mp4'


def _stub(tmp_path, on_extraction):
    from video_features_torch.extract.base import BaseExtractor

    class Stub(BaseExtractor):
        output_feat_keys = ['resnet']

        def extract(self, video_path):
            if 'bad' in video_path:
                raise RuntimeError('decode exploded')
            return {'resnet': np.ones((2, 3), np.float32)}

    return Stub({'feature_type': 'resnet', 'device': 'cpu',
                 'on_extraction': on_extraction,
                 'output_path': str(tmp_path / 'out')})


def test_a_failed_video_keeps_print_mode_stdout_clean(tmp_path, capsys, caplog):
    """The failure report goes to stderr through the event log, with the
    JAX package's message and fields; stdout carries the features only."""
    ex = _stub(tmp_path, 'print')
    with caplog.at_level(logging.WARNING, logger='video_features_torch'):
        assert ex._extract('/videos/bad.mp4') == 'failed'
        assert ex._extract('/videos/good.mp4') == 'printed'
    captured = capsys.readouterr()
    assert 'bad.mp4' not in captured.out and 'Traceback' not in captured.out
    assert captured.out.startswith('resnet\n')
    assert 'RuntimeError: decode exploded' in captured.err
    rec = next(r for r in caplog.records if getattr(r, 'video', None))
    assert rec.levelno == logging.WARNING and rec.exc_info is not None
    assert rec.video == '/videos/bad.mp4'
    assert rec.getMessage().startswith(
        'extraction failed; continuing with the next video')


def test_packed_batch_error_names_its_videos(capsys, caplog):
    with caplog.at_level(logging.WARNING, logger='video_features_torch'):
        try:
            raise RuntimeError('geometry will not fit')
        except RuntimeError:
            events.log_batch_error(['b.mp4', 'a.mp4'], valid=3, batch=4,
                                   stage='model')
    captured = capsys.readouterr()
    assert captured.out == '' and 'geometry will not fit' in captured.err
    rec = next(r for r in caplog.records if getattr(r, 'videos', None))
    assert (rec.videos, rec.valid, rec.batch, rec.stage) == (
        ['a.mp4', 'b.mp4'], 3, 4, 'model')


def test_cache_errors_go_through_the_event_log(capsys):
    from video_features_torch.cache import log_cache_error
    before = events.event_counts().get(('WARNING', 'cache'), 0)
    try:
        raise OSError('disk gone')
    except OSError:
        log_cache_error('lookup for v.mp4')
    assert events.event_counts()[('WARNING', 'cache')] == before + 1
    assert 'feature cache lookup for v.mp4 failed' in capsys.readouterr().err


# -- the manifest's compile section ------------------------------------------


def test_manifest_compile_counts_nvcc_builds_not_loads(tmp_path, monkeypatch):
    """A kernel built during the run is ``nvcc:<name>`` with its count and
    seconds; a library found built (a load) adds nothing, as a JAX cache
    hit adds nothing."""
    from video_features_torch.ops import _kernels

    def fake_nvcc(cmd, **kw):
        Path(cmd[cmd.index('-o') + 1]).write_bytes(b'elf')
        time.sleep(0.01)
        return subprocess.CompletedProcess(cmd, 0, 'ptxas info', '')
    monkeypatch.setattr(_kernels, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_kernels, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(_kernels.subprocess, 'run', fake_nvcc)
    man = RunManifest({'feature_type': 'i3d'})
    assert man.document()['compile'] == {}
    path, log = _kernels.build('corr_lookup')
    assert path.exists() and log
    assert _kernels.build('corr_lookup') == (path, '')        # a load
    comp = man.document()['compile']
    assert list(comp) == ['nvcc:corr_lookup']
    assert comp['nvcc:corr_lookup']['count'] == 1
    assert comp['nvcc:corr_lookup']['total_s'] >= 0.01
    later = RunManifest({'feature_type': 'i3d'})
    _kernels.build('corr_lookup')
    assert later.document()['compile'] == {}


# -- the black box -----------------------------------------------------------


def _blackbox(root, **kw):
    rec = spans.SpanRecorder(capacity=64)
    rec.span('model', 1.0, 2.0, video='v.mp4')
    kw.setdefault('recorders', lambda: [rec])
    kw.setdefault('min_interval_s', 0.0)
    return blackbox.BlackBox(str(root / 'postmortem'), **kw), rec


def test_bundle_layout_passes_both_validators(tmp_path):
    events.event(logging.WARNING, 'pre-crash breadcrumb', subsystem='obs')
    reg = metrics.MetricsRegistry()
    reg.counter('vft_x_total').inc()
    bb, _ = _blackbox(tmp_path, metrics_fn=reg.collect, prom_fn=reg.render,
                      manifest_fn=lambda: RunManifest(
                          {'feature_type': 'resnet'}).document())
    bundle = Path(bb.dump('worker_crash', label='resnet/resnet18'))
    assert blackbox.validate_bundle(str(bundle)) == []
    assert jax_blackbox.validate_bundle(str(bundle)) == []
    meta = json.loads((bundle / 'meta.json').read_text())
    assert meta['reason'] == 'worker_crash' and meta['pid'] == os.getpid()
    assert meta['extra'] == {'label': 'resnet/resnet18'}
    assert meta['sections'] == {'spans': True, 'events': True,
                                'metrics': True, 'manifest': True}
    doc = json.loads((bundle / 'spans.json').read_text())
    assert jax_validate_events(doc['traceEvents']) == []
    assert any('pre-crash breadcrumb' in ln for ln in
               (bundle / 'events.jsonl').read_text().splitlines())
    assert (bundle / 'metrics.prom').read_text() == reg.render()
    assert json.loads((bundle / 'manifest.json').read_text())['schema'] == \
        'video_features_torch.run_manifest/1'
    # a broken collector is a missing section, never a raise
    bb2, _ = _blackbox(tmp_path / 'b2', metrics_fn=lambda: 1 / 0)
    bundle2 = bb2.dump('watchdog_stall')
    assert bundle2 is not None and blackbox.validate_bundle(bundle2) == []
    assert json.loads((Path(bundle2) / 'meta.json').read_text()
                      )['sections']['metrics'] is False


def test_a_jax_bundle_passes_the_port_validator(tmp_path):
    rec = jax_spans.SpanRecorder(capacity=8)
    rec.span('model', 1.0, 2.0)
    bb = jax_blackbox.BlackBox(str(tmp_path), recorders=lambda: [rec],
                               min_interval_s=0.0)
    assert blackbox.validate_bundle(bb.dump('jax_side')) == []
    broken = tmp_path / 'broken'
    broken.mkdir()
    assert blackbox.validate_bundle(str(broken))[0].startswith(
        'meta.json unreadable')


def test_bundle_gc_keeps_the_newest_under_the_cap_and_rate_limits(tmp_path):
    bb, _ = _blackbox(tmp_path)
    first = bb.dump('r0')
    size = sum(f.stat().st_size for f in Path(first).rglob('*') if f.is_file())
    bb.max_bytes = int(size * 2.5)
    for i in range(1, 6):
        assert bb.dump(f'r{i}') is not None
    root = tmp_path / 'postmortem'
    bundles = sorted(p.name for p in root.iterdir())
    assert sum(f.stat().st_size for f in root.rglob('*') if f.is_file()) \
        <= bb.max_bytes
    assert any(b.endswith('-r5') for b in bundles)
    assert not any(b.endswith('-r0') for b in bundles)
    bb.max_bytes = 1                       # below one bundle: the newest stays
    assert bb.dump('r6') is not None
    assert [p.name[-3:] for p in root.iterdir()] == ['-r6']
    bb.min_interval_s = 60.0
    assert bb.dump('r7') is None and bb.suppressed == 1
    bb._last_dump_t = 0.0
    assert bb.dump('r8') is not None


FARM_DEATH = r'''
import json, sys
sys.path.insert(0, {repo!r})
from tests.test_torch_farm import SyntheticRecipe
from video_features_torch.farm import DecodeFarm
from video_features_torch.obs.blackbox import BlackBox
from video_features_torch.obs.metrics import REGISTRY
from video_features_torch.obs.spans import SpanRecorder
from video_features_torch.parallel.packing import NUDGE, VideoTask
from video_features_torch.utils.tracing import Tracer

rec = SpanRecorder()
bb = BlackBox({pm!r}, recorders=lambda: [rec], metrics_fn=REGISTRY.collect,
              prom_fn=REGISTRY.render, min_interval_s=0.0)
farm = DecodeFarm(SyntheticRecipe(n_windows=3), workers=2, ring_bytes=1 << 20,
                  tracer=Tracer(recorder=rec), blackbox=bb)
tasks = [VideoTask(p) for p in {paths!r}]
n = sum(1 for item in farm.stream(iter(tasks), lambda t: True)
        if isinstance(item, tuple))
print(json.dumps({{'failed': [t.path for t in tasks if t.failed], 'windows': n,
                  'gauges': [REGISTRY.gauge(g).value for g in (
                      'vft_farm_workers', 'vft_farm_busy_workers',
                      'vft_farm_ring_bytes')]}}))
'''


def test_a_killed_farm_worker_dumps_one_valid_bundle(tmp_path):
    """A worker SIGKILLed mid-video: the supervisor respawns it, fails that
    video alone and dumps one bundle naming ``farm_worker_death`` (the
    JAX package's reason) whose
    metrics read one respawn; the gauges read 0 once the farm retired."""
    pm = tmp_path / 'pm'
    paths = [str(tmp_path / 'a.bin'), str(tmp_path / 'CRASH.bin'),
             str(tmp_path / 'b.bin')]
    proc = subprocess.run(
        [sys.executable, '-c', FARM_DEATH.format(repo=str(REPO), pm=str(pm),
                                                 paths=paths)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['failed'] == [paths[1]] and out['gauges'] == [0, 0, 0]
    assert 'decode farm worker' in proc.stderr and 'died' in proc.stderr
    bundles = list(pm.iterdir())
    assert len(bundles) == 1
    assert blackbox.validate_bundle(str(bundles[0])) == []
    assert jax_blackbox.validate_bundle(str(bundles[0])) == []
    meta = json.loads((bundles[0] / 'meta.json').read_text())
    assert meta['reason'] == 'farm_worker_death'
    assert meta['extra']['victim'] == paths[1]
    assert meta['extra']['exitcode'] == -signal.SIGKILL
    series = json.loads((bundles[0] / 'metrics.json').read_text()
                        )['vft_farm_respawns_total']['series']
    assert [s['value'] for s in series] == [1]
    assert 'vft_farm_respawns_total 1' in (bundles[0] / 'metrics.prom').read_text()


# -- CLI runs, against the JAX package's ----------------------------------------


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp('obsclips')
    good = [str(write_noise_clip(d / f'v{i}.mp4', n, seed=10 + i))
            for i, n in enumerate((6, 9))]
    return good, good + [str(d / 'gone.mp4')]


RESNET = ['feature_type=resnet', 'model_name=resnet18', 'device=cpu',
          'batch_size=4', 'allow_random_weights=true',
          'on_extraction=save_numpy']


def _run_cli(main, root: Path, paths, *extra):
    trace, manifest = root / 'trace.json', root / 'manifest.json'
    rc = main(RESNET + [f'video_paths=[{",".join(paths)}]',
                        f'output_path={root / "out"}', f'tmp_path={root / "tmp"}',
                        f'trace_out={trace}', f'manifest_out={manifest}',
                        *extra])
    assert rc == 0
    return (json.loads(trace.read_text())['traceEvents'],
            json.loads(manifest.read_text()))


@pytest.fixture(scope='module')
def cli_runs(clips, tmp_path_factory):
    """The port's and the JAX package's CLI, per video and packed, on two
    clips and a missing path, with trace_out and manifest_out."""
    from video_features_torch.cli import main as port_main
    from video_features_tpu.cli import main as jax_main
    root = tmp_path_factory.mktemp('obscli')
    _, paths = clips
    runs = {}
    for mode, extra in (('one_shot', ()), ('packed', ('pack_across_videos=true',))):
        for name, main in (('port', port_main), ('jax', jax_main)):
            runs[name, mode] = _run_cli(main, root / f'{name}_{mode}', paths,
                                        *extra)
    return runs


@pytest.mark.parametrize('mode', ['one_shot', 'packed'])
def test_cli_manifests_give_the_jax_outcomes(cli_runs, clips, mode):
    (_, man), (_, jax_man) = cli_runs['port', mode], cli_runs['jax', mode]
    good, paths = clips
    assert man['outcomes'] == jax_man['outcomes'] == {'saved': 2, 'failed': 1}
    assert man['videos'] == jax_man['videos']
    assert set(man) == set(jax_man) == MANIFEST_KEYS
    assert man['schema'] == 'video_features_torch.run_manifest/1'
    assert man['fingerprints']['run'] and man['fingerprints']['config']
    assert man['config']['feature_type'] == 'resnet'
    assert 'model' in man['stages'] and man['stages']['model']['count'] > 0
    assert set(man['stages']) <= set(tracing.STAGES)
    assert man['compile'] == {}            # no kernel on this path


def test_one_shot_cli_trace_and_manifest(cli_runs, clips):
    """Per video: a ``video`` span per clip with its outcome, under one
    trace id, beside the stage spans, as the JAX run records."""
    good, paths = clips
    evs, man = cli_runs['port', 'one_shot']
    jax_evs, _ = cli_runs['jax', 'one_shot']
    assert spans.validate_events(evs) == [] == jax_validate_events(evs)
    vids = [e for e in evs if e['ph'] == 'X' and e['name'] == 'video']
    jax_vids = [e for e in jax_evs if e['ph'] == 'X' and e['name'] == 'video']
    assert {e['args']['video']: e['args']['outcome'] for e in vids} == \
        {e['args']['video']: e['args']['outcome'] for e in jax_vids}
    assert {e['args']['trace_id'] for e in vids} == \
        {next(iter({e['args']['trace_id'] for e in vids}))}
    assert {e['name'] for e in evs if e['ph'] == 'X'} <= \
        set(tracing.STAGES) | {'video'}
    assert man['stages']                   # folded across the resets
    assert man['executables'] == {}        # the per-video loop notes none


def test_packed_cli_trace_out_covers_every_video(cli_runs, clips):
    """Packed: decode, pack, model, d2h and save spans for every video that
    decodes, one model and one d2h span per batch, every model/d2h span
    naming the lane, one trace id, ``video_start``/``video_done``
    instants with the JAX run's outcomes, and the manifest's
    executables with batch and compute_dtype."""
    good, paths = clips
    evs, man = cli_runs['port', 'packed']
    jax_evs, _ = cli_runs['jax', 'packed']
    assert jax_validate_events(evs) == []
    by_name = {}
    for e in evs:
        by_name.setdefault(e['name'], []).append(e)
    for path in good:
        assert any(e['args'].get('video') == path
                   for e in by_name['decode+preprocess'] if 'args' in e)
        for name in ('pack', 'model', 'd2h'):
            assert any(path in e['args']['videos'] for e in by_name[name]), name
        assert any(e['args'].get('video') == path for e in by_name['save'])
    assert len(by_name['d2h']) == len(by_name['model'])
    for name in ('model', 'd2h'):
        assert all(e['args']['compute_dtype'] == 'float32'
                   and e['args']['capacity'] == 4 for e in by_name[name])
    tids = {e['args']['trace_id'] for e in evs
            if 'trace_id' in e.get('args', {})}
    assert len(tids) == 1

    def done(events_):
        return {e['args']['video']: e['args']['outcome'] for e in events_
                if e['name'] == 'video_done'}
    assert done(evs) == done(jax_evs)
    assert {e['args']['video'] for e in by_name['video_start']} == set(paths)
    assert man['executables'] == {
        'resnet:(4, 224, 224, 3):uint8': {'batch': 4,
                                          'compute_dtype': 'float32'}}
    assert man['farm'] == {}
    assert trace_view_main([str(Path(man['config']['trace_out'])), '--quiet']) == 0


def test_i3d_manifest_gives_the_jax_outcomes(tmp_path):
    """i3d at a small depth (stack 10, one RAFT iteration, 64 px), per
    video, over a clip and a missing path: the manifests' outcomes and
    per-video records agree, and each video span names its outcome."""
    from video_features_torch.cli import main as port_main
    from video_features_tpu.cli import main as jax_main
    clip = str(write_noise_clip(tmp_path / 'c.mp4', 12, w=96, h=72, seed=3))
    paths = [clip, str(tmp_path / 'gone.mp4')]
    docs = {}
    for name, main in (('port', port_main), ('jax', jax_main)):
        root = tmp_path / name
        rc = main(['feature_type=i3d', 'device=cpu', 'stack_size=10',
                   'step_size=10', 'batch_size=1', 'raft_iters=1',
                   'side_size=64', 'allow_random_weights=true',
                   'on_extraction=save_numpy', f'video_paths=[{",".join(paths)}]',
                   f'output_path={root / "out"}', f'tmp_path={root / "tmp"}',
                   f'manifest_out={root / "m.json"}',
                   f'trace_out={root / "t.json"}'])
        assert rc == 0
        docs[name] = (json.loads((root / 'm.json').read_text()),
                      json.loads((root / 't.json').read_text())['traceEvents'])
    (man, evs), (jax_man, _) = docs['port'], docs['jax']
    assert man['outcomes'] == jax_man['outcomes'] == {'saved': 1, 'failed': 1}
    assert man['videos'] == jax_man['videos']
    assert {e['args']['video']: e['args']['outcome'] for e in evs
            if e['name'] == 'video'} == {clip: 'saved', paths[1]: 'failed'}
    assert man['compile'] == {}            # the CPU runs the plain versions


def test_profile_dir_writes_a_torch_profiler_trace(clips, tmp_path, capsys):
    """``profile_dir``: the run inside ``torch.profiler``, its Chrome trace
    under the directory (on the CPU, the CPU ops; on the card also the
    kernels), the outputs as without it."""
    from video_features_torch.cli import main
    good, _ = clips
    prof = tmp_path / 'prof'
    rc = main(RESNET + [f'video_paths=[{good[0]}]',
                        f'output_path={tmp_path / "out"}',
                        f'tmp_path={tmp_path / "tmp"}', f'profile_dir={prof}'])
    assert rc == 0
    traces = list(prof.glob('*.pt.trace.json'))
    assert len(traces) == 1
    names = {e.get('name') for e in json.loads(traces[0].read_text())
             ['traceEvents']}
    assert any('conv' in str(n) for n in names)
    assert list((tmp_path / 'out').rglob('*.npy'))


def test_telemetry_that_cannot_be_written_is_a_warning(clips, tmp_path, capsys):
    """A manifest or trace path that cannot be written costs a warning
    event; the run's outputs stand and the CLI returns 0."""
    from video_features_torch.cli import main
    good, _ = clips
    blocker = tmp_path / 'file'
    blocker.write_text('x')
    rc = main(RESNET + [f'video_paths=[{good[0]}]',
                        f'output_path={tmp_path / "out"}',
                        f'tmp_path={tmp_path / "tmp"}',
                        f'trace_out={blocker / "t.json"}',
                        f'manifest_out={blocker / "m.json"}'])
    assert rc == 0
    err = capsys.readouterr().err
    assert 'run-manifest write failed' in err and 'trace export failed' in err
    assert list((tmp_path / 'out').rglob('*.npy'))


def test_extractors_record_nothing_without_the_knobs(clips, tmp_path):
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    good, _ = clips
    ex = create_extractor(load_config('resnet', overrides={
        'model_name': 'resnet18', 'device': 'cpu', 'video_paths': good,
        'allow_random_weights': True, 'output_path': str(tmp_path)}))
    assert (ex.tracer.enabled, ex.tracer.recorder, ex.manifest, ex.blackbox,
            ex.trace_ctx) == (False, None, None, None, None)
    assert ex.executable_cost(None) is None
    ex.finish_obs()                        # nothing to write
    assert list(tmp_path.iterdir()) == []


def test_sigterm_on_a_cli_run_writes_one_valid_bundle(clips, tmp_path):
    """``postmortem_dir``: a CLI run sent SIGTERM dumps one bundle (the
    spans of its trace, the event tail, the metrics, the manifest so far)
    and then dies of the signal."""
    good, _ = clips
    corpus = []
    for i in range(40):
        corpus.append(str(tmp_path / f'c{i}.mp4'))
        shutil.copyfile(good[i % 2], corpus[-1])
    pm = tmp_path / 'pm'
    proc = subprocess.Popen(
        [sys.executable, '-u', '-m', 'video_features_torch'] + RESNET + [
            f'video_paths=[{",".join(corpus)}]',
            f'output_path={tmp_path / "out"}', f'tmp_path={tmp_path / "tmp"}',
            f'postmortem_dir={pm}', f'trace_out={tmp_path / "t.json"}',
            f'manifest_out={tmp_path / "m.json"}'],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith('[2/'):      # inside the worklist
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGTERM, err
    bundles = list(pm.iterdir())
    assert len(bundles) == 1
    assert blackbox.validate_bundle(str(bundles[0])) == []
    assert jax_blackbox.validate_bundle(str(bundles[0])) == []
    meta = json.loads((bundles[0] / 'meta.json').read_text())
    assert meta['reason'] == f'signal_{int(signal.SIGTERM)}'
    assert meta['sections']['spans'] and meta['sections']['manifest']
    manifest = json.loads((bundles[0] / 'manifest.json').read_text())
    assert manifest['outcomes'].get('saved', 0) >= 1
