"""The port's streaming pieces (video_features_torch/extract/streaming.py,
io/video.py, utils/tracing.py) against the JAX package's, on the CPU:
the deferred readback, the producer-thread transfer, the prefetch's
error path, the decode thread pool, and the stage tracer."""
import sys
import threading

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.extract import streaming
from video_features_torch.extract.base import DeviceBatch, Readback
from video_features_torch.io import video
from video_features_torch.ops.host_transforms import resize_pil
from video_features_torch.utils import tracing
from video_features_tpu.extract import streaming as jax_streaming
from video_features_tpu.io import video as jax_video
from video_features_tpu.utils import tracing as jax_tracing


def _dispatch_log(overlap_fetch, n, depth):
    """The order of dispatches and fetches, and the results, of
    ``overlap_fetch`` over ``n`` items at ``depth``."""
    events = []

    def dispatched():
        for i in range(n):
            events.append(('dispatch', i))
            yield f'dev{i}', i * 10

    def fetch(dev):
        events.append(('fetch', int(dev[3:])))
        return 'host' + dev[3:]

    return list(overlap_fetch(dispatched(), fetch, depth=depth)), events


@pytest.mark.parametrize('n,depth', [(4, 1), (4, 2), (5, 3), (2, 4), (0, 2)])
def test_overlap_fetch_order_and_depth_match_jax(n, depth):
    """At depth k the oldest dispatch is fetched once k are in flight,
    results keep dispatch order, and depth 1 alternates (synchronous):
    the same event order as the JAX package's."""
    out, events = _dispatch_log(streaming.overlap_fetch, n, depth)
    assert (out, events) == _dispatch_log(jax_streaming.overlap_fetch, n, depth)
    assert out == [(f'host{i}', i * 10) for i in range(n)]
    if depth == 1:
        assert events == [(kind, i) for i in range(n)
                          for kind in ('dispatch', 'fetch')]
    for i in range(n):
        ahead = min(i + depth - 1, n - 1)
        assert events.index(('fetch', i)) > events.index(('dispatch', ahead))


def test_overlap_fetch_records_the_d2h_stage():
    t = tracing.Tracer()
    out = list(streaming.overlap_fetch(((x,) for x in 'ab'), str.upper,
                                       depth=3, tracer=t))
    assert out == [('A',), ('B',)] and t.report()['d2h']['count'] == 2


@pytest.mark.parametrize('keep_host', [False, True])
def test_transfer_batches_order_meta_and_keep_host_match_jax(keep_host):
    """``put`` runs on the producer thread in item order; device batch,
    host batch (kept or None) and meta come back in order, as from the
    JAX package's; a None batch passes through uncopied."""
    items = [(np.full((2,), i, np.float32), 10 * i, f'm{i}') for i in range(7)]
    items.insert(3, (None, -1, 'marker'))
    runs = {}
    for name, mod in (('torch', streaming), ('jax', jax_streaming)):
        threads = []

        def put(batch):
            threads.append(threading.current_thread())
            return batch + 1000.0

        runs[name] = list(mod.transfer_batches(iter(items), put,
                                               keep_host=keep_host))
        assert threading.current_thread() not in threads
        assert len(threads) == 7
    for got, ref in zip(runs['torch'], runs['jax'], strict=True):
        assert got[2:] == ref[2:]
        for a, b in zip(got[:2], ref[:2]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    dev, host, meta, tag = runs['torch'][3]
    assert (dev, host, meta, tag) == (None, None, -1, 'marker')
    dev, host, meta, _ = runs['torch'][5]
    assert float(dev[0]) == 1004.0 and meta == 40
    assert (host is None) != keep_host


@pytest.mark.parametrize('mod', [video, jax_video], ids=['torch', 'jax'])
def test_prefetch_reraises_the_producers_exception(mod):
    """The producer's exception is raised at the consumer's next(), after
    the items it yielded before it."""
    def source():
        yield 1
        yield 2
        raise OSError('decoder died')

    got = []
    with pytest.raises(OSError, match='decoder died'):
        for item in mod.prefetch(source(), depth=1):
            got.append(item)
    assert got == [1, 2]


def test_prefetch_runs_ahead_and_stops_with_the_consumer():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield i

    it = video.prefetch(source(), depth=3)
    assert next(it) == 0
    it.close()
    assert len(produced) < 100


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    return write_noise_clip(tmp_path_factory.mktemp('stream') / 'c.mp4', 23,
                            w=96, h=72, seed=4)


@pytest.mark.parametrize('workers', [1, 2, 4])
def test_video_loader_transform_workers_are_byte_equal(clip, tmp_path, workers):
    """The per-frame resize over 1, 2 or 4 threads gives the same frames,
    batches and timestamps as inline, and as the JAX package's loader."""
    def transform(f):
        return resize_pil(f, 64)

    def batches(mod, **kw):
        with mod.VideoLoader(clip, batch_size=5, transform=transform,
                             tmp_path=tmp_path, backend='cv2', **kw) as loader:
            return [(np.stack(b), list(t), list(i)) for b, t, i in loader]

    ref = batches(video)
    got = batches(video, transform_workers=workers)
    jax = batches(jax_video, transform_workers=workers)
    assert len(got) == len(ref) == len(jax) == 5
    for (a, ta, ia), (b, tb, ib), (c, tc, ic) in zip(got, ref, jax):
        assert a.tobytes() == b.tobytes() == c.tobytes()
        assert ta == tb == tc and ia == ib == ic


def test_video_loader_refuses_zero_workers(clip):
    with pytest.raises(ValueError, match='transform_workers'):
        video.VideoLoader(clip, transform_workers=0)


def test_parallel_map_keeps_order_and_bounds_lookahead():
    started = []

    def slow(i):
        started.append(i)
        return i * i

    it = video._parallel_map(slow, iter(range(50)), 3)
    assert next(it) == 0
    assert max(started) <= 2 * 3 + 1
    assert list(it) == [i * i for i in range(1, 50)]


def _traced(mod):
    """A tracer fed the same calls: two batches of 4 slots with 3 and 4
    real, a stage timed three times with a slow first call."""
    t = mod.Tracer()
    t.add('model', 0.5)
    t.add('model', 0.1)
    t.add('model', 0.1)
    t.add_occupancy('model', 3, 4)
    t.add_occupancy('model', 4, 4)
    t.add('d2h', 0.01)
    return t


def test_tracer_occupancy_ramp_and_merge_match_jax():
    got, ref = _traced(tracing).report(), _traced(jax_tracing).report()
    assert got == ref
    assert got['model']['occupancy'] == pytest.approx(7 / 8)
    assert got['model']['ramp'] == pytest.approx(5.0)
    assert 'ramp' not in got['d2h'] and 'occupancy' not in got['d2h']
    merged = tracing.merge_reports([got, _traced(tracing).report()])
    assert merged == jax_tracing.merge_reports([ref, ref])
    assert merged['model']['count'] == 6 and 'ramp' not in merged['model']
    assert tracing.round_report(got, 3) == jax_tracing.round_report(ref, 3)
    summary = _traced(tracing).summary()
    assert summary == _traced(jax_tracing).summary()
    assert 'occ%' in summary and ' 87.5 ' in summary and '   5.0' in summary


def test_tracer_stage_wrap_iter_and_null_tracer():
    t = tracing.Tracer()
    with pytest.raises(ValueError):
        with t.stage('boom'):
            raise ValueError
    assert list(t.wrap_iter('decode', iter(range(4)))) == [0, 1, 2, 3]
    rep = t.report()
    assert rep['boom']['count'] == 1 and rep['decode']['count'] == 5
    with tracing.NULL_TRACER.stage('x'):
        pass
    tracing.NULL_TRACER.add_occupancy('x', 1, 2)
    assert tracing.NULL_TRACER.report() == {}
    t.reset()
    assert t.summary() == '(no stages recorded)'


def test_tracer_is_thread_safe():
    t = tracing.Tracer()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(300):
                t.add('shared', 1e-6)
                t.add_occupancy('shared', 1, 2)
        threads = [threading.Thread(target=work) for _ in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    rep = t.report()['shared']
    assert rep['count'] == 3600 and rep['occ_valid'] == 3600


def test_device_batch_and_readback_on_the_cpu():
    """On the CPU a staged batch is the host tensor itself and a
    readback hands back the step's outputs as numpy."""
    x = torch.arange(6).reshape(2, 3)
    staged = DeviceBatch(x)
    assert staged.shape == (2, 3) and staged.take() is x
    rb = Readback({'a': x * 2}, inputs=staged)
    assert rb.done is None and rb.inputs is staged
