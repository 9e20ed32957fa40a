"""The serve daemon's pure parts (video_features_torch/serve/protocol.py,
pool.py, metrics.py, config.py::split_serve_config, obs/watchdog.py,
obs/slo.py), driven through both packages on the same inputs: the
results must be equal. None of these needs a server, a model or JAX's
runtime."""
import types

import pytest

from video_features_tpu.config import split_serve_config as jax_split
from video_features_tpu.obs import slo as jax_slo
from video_features_tpu.obs import watchdog as jax_watchdog
from video_features_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from video_features_tpu.serve import metrics as jax_metrics
from video_features_tpu.serve import pool as jax_pool
from video_features_tpu.serve import protocol as jax_protocol
from video_features_torch.config import split_serve_config
from video_features_torch.obs import slo, watchdog
from video_features_torch.obs.metrics import MetricsRegistry
from video_features_torch.serve import metrics, pool, protocol

PACKAGES = {'port': (protocol, pool, metrics, MetricsRegistry, watchdog, slo),
            'jax': (jax_protocol, jax_pool, jax_metrics, JaxRegistry,
                    jax_watchdog, jax_slo)}


# -- the wire's version gate ----------------------------------------------------


@pytest.mark.parametrize('msg', [
    {'v': '1.0'}, {'v': '1.1'}, {'v': '1.7'}, {'cmd': 'ping'},
    {'v': '2.0', 'request_id': 'r000042'}, {'v': 'banana'},
    {'v': '0.9', 'request_id': 'x'}])
def test_check_version_matches_jax(msg):
    assert protocol.VERSION == jax_protocol.VERSION == '1.5'
    assert protocol.MAJOR == jax_protocol.MAJOR
    assert protocol.check_version(dict(msg)) == \
        jax_protocol.check_version(dict(msg))


def test_wire_vocabulary_matches_jax():
    """Commands, submit fields, priorities and error codes: one wire."""
    for name in ('COMMANDS', 'SUBMIT_FIELDS', 'PRIORITIES', 'ERR_SHED',
                 'ERR_INVALID', 'ERR_UNSUPPORTED', 'ERR_NOT_FOUND',
                 'ERR_INTERNAL', 'ERR_CONNECT_REFUSED', 'ERR_DEADLINE'):
        assert getattr(protocol, name) == getattr(jax_protocol, name), name
    msg = {'cmd': 'submit', 'video_paths': ['a', 'b'], 'v': '1.5'}
    assert protocol.encode(msg) == jax_protocol.encode(msg)
    assert protocol.decode(jax_protocol.encode(msg)) == msg


# -- the warm pool --------------------------------------------------------------


def _pool_story(pool_mod):
    """The JAX package's LRU scenario; returns what each step observed."""
    class FakeEntry:
        def __init__(self, name, busy=False):
            self.name, self.busy, self.closed = name, busy, False

        def idle(self):
            return not self.busy

        def close(self):
            self.closed = True

    p = pool_mod.WarmPool(2)
    a, b, c = FakeEntry('a'), FakeEntry('b'), FakeEntry('c')
    log = [p.get(('a',))]
    p.put(('a',), a)
    p.put(('b',), b)
    log.append(p.get(('a',)).name)
    log.append([v.name for v in p.put(('c',), c)] + [b.closed])
    log.append(p.stats())
    a.busy = c.busy = True
    d, e = FakeEntry('d'), FakeEntry('e')
    log.append(p.put(('d',), d))
    log.append(p.stats()['size'])
    a.busy = False
    log.append(sorted(v.name for v in p.put(('e',), e)))
    log.append(p.stats())
    log.append(p.remove(('c',), d))
    log.append(p.remove(('c',), c).name)
    log.append([v.name for v in p.pop_all()])
    return log


def test_warm_pool_lru_matches_jax():
    got = _pool_story(pool)
    assert got == _pool_story(jax_pool)
    assert got[3]['hit_rate'] == 0.5 and got[3]['evictions'] == 1


# -- device placement -----------------------------------------------------------


def _placer_story(pool_mod, devices):
    placer = pool_mod.DevicePlacer()
    FP32, BF16, INT8 = 4000, 2000, 1000     # the lanes' byte ratios
    picks = {}
    for name, size in (('fp32_a', FP32), ('int8_a', INT8), ('int8_b', INT8),
                       ('bf16_a', BF16), ('fp32_b', FP32)):
        picks[name] = (placer.assign(devices, 1, nbytes=size), size)
    wide = placer.assign(devices, 2, nbytes=10)
    log = [{k: [devices.index(d) for d in v] for k, (v, _) in picks.items()},
           placer.snapshot(), placer.snapshot_bytes()]
    placer.release(wide, nbytes=10)
    for chosen, size in picks.values():
        placer.release(chosen, nbytes=size)
    log += [placer.snapshot(), placer.snapshot_bytes()]
    return log


@pytest.mark.parametrize('kind', ['fake', 'torch'])
def test_device_placer_byte_ledger_matches_jax(kind):
    """int8 and bf16 entries stack on one device before a second fp32 copy
    lands there; every release nets to zero. The JAX package sees fake
    devices with ``id``; the port also ``torch.device('cuda', i)``."""
    fake = [types.SimpleNamespace(id=i) for i in range(2)]
    want = _placer_story(jax_pool, fake)
    if kind == 'torch':
        import torch
        got = _placer_story(pool, [torch.device('cuda', i) for i in range(2)])
    else:
        got = _placer_story(pool, fake)
    assert got == want
    assert want[0]['int8_b'] == want[0]['int8_a'] == want[0]['bf16_a']
    assert want[0]['fp32_b'] == want[0]['fp32_a'] != want[0]['int8_a']
    assert set(want[3].values()) == set(want[4].values()) == {0}


# -- the serve command line -----------------------------------------------------


@pytest.mark.parametrize('cli', [
    {'serve_port': '8791', 'serve_queue_depth': 8, 'device': 'cpu',
     'batch_size': 4},
    {'serve_default_timeout_s': '2.5', 'serve_prewarm': 'resnet'},
    {'serve_prewarm': ['resnet', 'clip@bfloat16', 'index']},
    {'serve_batch_shed_fraction': 1, 'serve_idle_flush_s': '0.2'},
    {'serve_warm_pol_size': 2},
    {'serve_queue_depth': 0},
    {'serve_warm_pool_size': -1},
    {'serve_idle_flush_s': 0},
    {'serve_max_batch_wait_s': -1.0},
    {'serve_prewarm': 3},
    {'serve_prewarm': ['resnet', '']},
    {'serve_prewarm': ['vggish']},
    {'serve_batch_shed_fraction': 0},
    {'serve_batch_shed_fraction': 1.5},
    {'serve_ingress_port': 0},
    {'serve_ingress_max_body_mb': 0},
    {'serve_ingress_max_connections': 0},
])
def test_split_serve_config_matches_jax(cli):
    """The same values, or the same error type and text."""
    try:
        want = jax_split(dict(cli))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            split_serve_config(dict(cli))
        assert str(got.value) == str(e)
        return
    serve, base = split_serve_config(dict(cli))
    assert serve == dict(want[0]) and base == dict(want[1])


@pytest.mark.parametrize('key,value', [
    ('serve_ingress_port', 0),
    ('serve_ingress_host', '0.0.0.0'),
    ('serve_ingress_auth_file', 'keys.yml'),
    ('serve_ingress_max_body_mb', 16),
    ('serve_ingress_max_connections', 8),
])
def test_serve_ingress_knobs_are_refused_by_name(key, value):
    """A front-door knob the JAX package accepts, set away from its
    default, makes the port raise naming that knob: the port has no
    ``ingress/``, and a knob must not be taken and then ignored."""
    cli = {key: value}
    if key == 'serve_ingress_port':
        # the JAX rule: a port needs a key file (refused first by name)
        cli['serve_ingress_auth_file'] = 'keys.yml'
    jax_split(dict(cli))
    with pytest.raises(NotImplementedError, match=key):
        split_serve_config(dict(cli))


# -- the metrics document's Prometheus rendering --------------------------------


def _doc(with_devices):
    stage = {'count': 3, 'total_s': 1.5, 'mean_s': 0.5, 'max_s': 0.9,
             'first_s': 0.9, 'occupancy': 0.75, 'occ_valid': 9,
             'occ_capacity': 12}
    if with_devices:
        stage['occ_device'] = {'d0': {'occ_valid': 5, 'occ_capacity': 6,
                                      'occupancy': 5 / 6},
                               'd1': {'occ_valid': 4, 'occ_capacity': 6,
                                      'occupancy': 4 / 6}}
    return {
        'uptime_s': 12.5,
        'queue': {'depth': 3, 'capacity': 64, 'draining': with_devices},
        'warm_pool': {'size': 1, 'capacity': 4, 'hits': 2, 'misses': 1,
                      'hit_rate': 2 / 3, 'evictions': 0,
                      'builds_compiled': 1, 'builds_loaded': 0,
                      'placements': {'resnet/resnet18': ['d0']},
                      'device_residents': {'d0': 1, 'd1': 0},
                      'device_resident_bytes': {'d0': 46796448, 'd1': 0}},
        'inflight_batches': 1,
        'cache': {'hits': 4, 'misses': 2, 'hit_rate': 4 / 6, 'bytes': 100},
        'farm': {'decode_workers': 2, 'windows': 17, 'respawns': 0},
        'aot': {}, 'index': {'enabled': False, 'rows_live': 0},
        'ingress': {'enabled': False, 'requests_total': 0},
        'events': {'total': 5, 'counts': {'WARNING/serve': 2,
                                          'ERROR/farm': 3}},
        'trace': {'recorders': 2, 'events_dropped': 7},
        'watchdog': {'enabled': True, 'stalls_total': 1, 'workers': {}},
        'stages_merged': {'model': stage, 'decode': {'count': 2,
                                                     'total_s': 0.25}},
    }


@pytest.mark.parametrize('with_devices', [False, True])
def test_prometheus_text_matches_jax(with_devices):
    """One fixed document, the same request activity on a fresh registry
    each side: the same exposition text, twice (the mirrored counters
    must not double-count)."""
    texts = {}
    for name, (_, _, mod, registry_cls, _, _) in PACKAGES.items():
        registry = registry_cls()
        stats = mod.RequestStats(registry)
        for key in ('submitted', 'submitted', 'completed', 'failed',
                    'rejected', 'expired_videos', 'cached_videos'):
            stats.bump(key)
        for seconds in (0.02, 0.3, 4.0, 70.0):
            stats.observe_latency(seconds)
        doc = _doc(with_devices)
        texts[name] = [mod.prometheus_text(doc, registry) for _ in range(2)]
        texts[name].append(stats.snapshot())
    assert texts['port'] == texts['jax']
    assert 'vft_serve_requests_total{outcome="submitted"} 2' in texts['port'][1]


# -- the stall watchdog ---------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _watchdog_story(mod, script):
    clock = _Clock()
    registry = PACKAGES['port' if mod is watchdog else 'jax'][3]()
    wd = mod.StallWatchdog(5.0, registry=registry, clock=clock,
                           interval_s=60.0)
    fired = []
    for step in script:
        op, *a = step
        if op == 'tick':
            clock.t += a[0]
            fired.append(wd.check())
        else:
            getattr(wd, op)(*a)
    snap = wd.snapshot()
    return fired, snap, registry.collect().get('vft_watchdog_stalls_total')


@pytest.mark.parametrize('script', [
    # idle: never trips, whatever the time
    [('advance', 'w', 'decode'), ('tick', 60.0)],
    # work queued, nothing started: trips once at 'admission'
    [('set_pending', 'w', 2), ('tick', 4.0), ('tick', 2.0), ('tick', 30.0)],
    # stalled after a stage, re-armed by an advance, trips again
    [('set_pending', 'w', 1), ('tick', 1.0), ('advance', 'w', 'model'),
     ('tick', 6.0), ('advance', 'w', 'd2h'), ('tick', 4.0), ('tick', 2.0)],
    # 0 → positive resets the clock; a farm row goes with its prefix
    [('advance', 'w', 'decode'), ('tick', 50.0), ('set_pending', 'w', 1),
     ('set_pending', 'w/farm-w0', 3), ('tick', 4.0),
     ('forget_prefix', 'w/'), ('tick', 2.0), ('forget', 'w'),
     ('tick', 10.0)],
])
def test_stall_watchdog_check_matches_jax(script):
    got = _watchdog_story(watchdog, script)
    assert got == _watchdog_story(jax_watchdog, script)


# -- the SLO evaluator ----------------------------------------------------------


def _slo_story(name, objectives, script):
    _, _, mod, registry_cls, _, slo_mod = PACKAGES[name]
    clock = _Clock()
    registry = registry_cls()
    stats = mod.RequestStats(registry)
    ev = slo_mod.SloEvaluator(registry, clock=clock, **objectives)
    out = []
    for dt, latencies, failed in script:
        clock.t += dt
        for seconds in latencies:
            stats.bump('completed')
            stats.observe_latency(seconds)
        for _ in range(failed):
            stats.bump('failed')
        out.append(ev.tick())
    return out, registry.render()


@pytest.mark.parametrize('objectives,script', [
    ({'latency_p99_s': 1.0}, [(10, [0.1] * 50, 0), (60, [5.0] * 10, 0),
                              (400, [0.1] * 5, 0)]),
    ({'availability': 0.99}, [(1, [0.2] * 20, 0), (30, [0.2] * 10, 8),
                              (3700, [0.2], 0)]),
    ({'latency_p99_s': 60.0, 'availability': 0.999},
     [(5, [1.0, 2.0], 1), (5, [], 0), (7200, [90.0] * 3, 3)]),
])
def test_slo_tick_matches_jax(objectives, script):
    got = _slo_story('port', objectives, script)
    assert got == _slo_story('jax', objectives, script)
    assert got[0][-1]['enabled'] is True


def test_slo_disabled_shape_and_window_labels_match_jax():
    assert slo.disabled_stats() == jax_slo.disabled_stats()
    for s in (300, 3600, 90, 7200, 45):
        assert slo.window_label(s) == jax_slo.window_label(s)
