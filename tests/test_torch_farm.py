"""The port's decode farm (video_features_torch/farm/: the shared-memory
ring, the recipes, the worker processes and DecodeFarm) on the CPU,
against the JAX package's ring and recipes where they compute the same
thing, and through the packed loop and the CLI: windows arrive byte for
byte, a decode error or a worker crash fails one video, a worker imports
neither torch nor jax, and packed outputs are the bytes of
``decode_workers=1``.

The farms here run at most two workers on tiny clips. A spawned worker
unpickles this module's recipes by reference and so imports the module:
it imports neither torch nor jax at its top (torch and the packed loop,
which imports it, are imported inside the tests), which is what lets
:func:`test_spawned_worker_imports_neither_torch_nor_jax` see the
worker's own imports."""
import os
import re
import signal
import subprocess
import sys
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tools.make_sample_video import write_noise_clip
from video_features_torch.config import load_config
from video_features_torch.farm import (
    DecodeFarm, FarmUnavailable, StackRecipe, merge_farm_stats,
)
from video_features_torch.farm.ring import RingFull, RingProducer, read_window
from video_features_torch.farm.worker import MAX_UNACKED_WINQ
from video_features_torch.registry import create_extractor
from video_features_torch.utils.tracing import Tracer

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several workers per machine."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packing():
    """The packed loop's module (it imports torch)."""
    from video_features_torch.parallel import packing
    return packing


def _tasks(paths, out_root):
    return [_packing().VideoTask(p, out_root=str(out_root)) for p in paths]


# -- recipes for the farm's workers -----------------------------------------


def expected_window(path, i, nbytes=300_000):
    """Window ``i`` of ``path`` as :class:`SyntheticRecipe` makes it
    (seeded by crc32: the workers' hash seeds differ from the parent's)."""
    seed = zlib.crc32(os.path.basename(str(path)).encode()) % (2 ** 31)
    return np.random.RandomState(seed + i).randint(
        0, 255, size=(nbytes,)).astype(np.uint8)


class SyntheticRecipe:
    """Seeded windows derived from the path, no decode: the transport
    alone. A path with 'BAD' in its name raises after one window; 'CRASH'
    kills the worker after one window; 'FLOAT' yields a float window."""

    def __init__(self, n_windows=24, nbytes=300_000):
        self.n_windows = n_windows
        self.nbytes = nbytes

    def open(self, path):
        name = os.path.basename(path)

        def windows():
            for i in range(self.n_windows):
                if i == 1 and 'BAD' in name:
                    raise IOError(f'cannot decode {path}')
                if i == 1 and 'CRASH' in name:
                    os.kill(os.getpid(), signal.SIGKILL)
                w = expected_window(path, i, self.nbytes)
                yield (w.astype(np.float32) if 'FLOAT' in name else w), i

        return {'n': self.n_windows}, windows()


class ProbeRecipe:
    """Wraps a real recipe and reports, as the video's info, which of
    torch and jax the worker process has imported."""

    def __init__(self, inner):
        self.inner = inner

    def open(self, path):
        info, windows = self.inner.open(path)
        windows = list(windows)        # every import of the decode is done
        mods = sorted(m for m in ('torch', 'jax', 'video_features_tpu')
                      if m in sys.modules)
        return dict(info, modules=mods, pid=os.getpid()), iter(windows)


class HoldRecipe:
    """Wraps a real recipe: a path with 'HOLD' in its name waits, before
    it decodes, until the file ``release`` exists (at most 120 s), so the
    farm worker that took it holds one video and ships nothing."""

    def __init__(self, inner, release):
        self.inner = inner
        self.release = release

    def open(self, path):
        if 'HOLD' in os.path.basename(path):
            deadline = time.monotonic() + 120
            while not os.path.exists(self.release) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
        return self.inner.open(path)


# -- the ring, against the JAX package's ---------------------------------


def _rings(capacity):
    from video_features_tpu.farm.ring import RingProducer as JaxRing
    return (RingProducer(memoryview(bytearray(capacity)), capacity),
            JaxRing(memoryview(bytearray(capacity)), capacity))


def test_ring_roundtrip_with_wraps():
    """Odd-sized windows through a 4 KiB arena wrap many times and come
    back byte-exact; every (offset, adv) is the JAX ring's, and both
    sides agree on the total advance."""
    ring, jax_ring = _rings(1 << 12)
    rng = np.random.RandomState(0)
    inflight, freed = [], []

    def wait_free():
        assert inflight, 'alloc blocked with nothing to free'
        off, adv, expect = inflight.pop(0)
        got = read_window(ring.buf, off, expect.shape, expect.dtype.str)
        np.testing.assert_array_equal(got, expect)
        ring.freed(adv)
        jax_ring.freed(adv)
        freed.append(adv)

    for _ in range(64):
        arr = rng.randint(0, 255, size=(rng.randint(200, 600),)).astype(np.uint8)
        region = ring.alloc(arr.nbytes, wait_free)
        assert region == jax_ring.alloc(arr.nbytes, wait_free=lambda: None)
        off, adv = region
        assert adv >= arr.nbytes and off + arr.nbytes <= ring.capacity
        ring.write(off, arr)
        inflight.append((off, adv, arr))
    while inflight:
        wait_free()
    assert ring.write_pos == ring.read_pos == sum(freed) == jax_ring.write_pos


def test_ring_oversized_window_takes_queue_fallback():
    """A window over half the arena could need more than the arena after
    a wrap: alloc returns None (the queue transport) instead of waiting
    forever; exactly half still fits. The JAX ring agrees."""
    for ring in _rings(1 << 10):
        assert ring.alloc((1 << 9) + 1) is None
        assert ring.alloc(1 << 9) is not None


def test_ring_backpressure_blocks_until_freed():
    """A full arena makes the producer wait for frees (RingFull without
    a wait_free), then go on."""
    ring, _ = _rings(1 << 10)
    a = ring.alloc(400)
    assert ring.alloc(400) is not None
    with pytest.raises(RingFull):
        ring.alloc(400)
    calls = []

    def wait_free():
        ring.freed(a[1])
        calls.append(1)

    assert ring.alloc(400, wait_free) is not None and calls == [1]


# -- the farm's transport, with synthetic windows -------------------------


def _drain(farm, paths, admit=lambda t: True):
    """Run a farm stream to its end: the tasks, {path: [(meta, window)]}
    and the count of NUDGEs."""
    pk = _packing()
    tasks = [pk.VideoTask(str(p)) for p in paths]
    got = {t.path: [] for t in tasks}
    nudges = 0
    for item in farm.stream(iter(tasks), admit):
        if item is pk.NUDGE:
            nudges += 1
        elif item is not pk.FLUSH:
            task, window, meta = item
            got[task.path].append((meta, window))
    return tasks, got, nudges


def test_farm_ships_windows_byte_exact_across_workers(tmp_path):
    """Every window of every video arrives once, in order, byte-exact,
    through rings of ~3 windows that wrap and backpressure; the workers
    are reaped and every ring is unlinked afterwards."""
    paths = [tmp_path / f'v{i}.bin' for i in range(4)]
    farm = DecodeFarm(SyntheticRecipe(), workers=2, ring_bytes=1 << 20)
    tasks, got, nudges = _drain(farm, paths)
    for t in tasks:
        assert not t.failed and t.exhausted and t.emitted == 24
        assert t.info == {'n': 24}
        assert [m for m, _ in got[t.path]] == list(range(24))
        for i, (_, w) in enumerate(got[t.path]):
            np.testing.assert_array_equal(w, expected_window(t.path, i))
    st = farm.stats()
    assert (st['windows'], st['queue_fallback'], st['videos_assigned'],
            st['videos_failed'], st['respawns'], nudges) == (96, 0, 4, 0, 0, 0)
    assert st['ran'] and st['fallback'] is None and st['alive_workers'] == 0
    assert 0 <= st['start_s'] <= st['first_window_s']
    assert len(farm.ring_names) == 2
    assert not any(os.path.exists(f'/dev/shm/{n}') for n in farm.ring_names)


def test_farm_oversized_windows_fall_back_to_queue(tmp_path):
    """Windows over half the ring take the queue transport, credit-bounded
    by MAX_UNACKED_WINQ, and still arrive byte-exact under a slow consumer."""
    pk = _packing()
    path = tmp_path / 'big.bin'
    farm = DecodeFarm(SyntheticRecipe(n_windows=6, nbytes=400_000),
                      workers=1, ring_bytes=1 << 19)
    seen = 0
    for item in farm.stream(iter([pk.VideoTask(str(path))]), lambda t: True):
        if item is pk.FLUSH or item is pk.NUDGE:
            continue
        _, window, meta = item
        np.testing.assert_array_equal(window, expected_window(path, meta, 400_000))
        seen += 1
        time.sleep(0.03)
        for w in farm._workers:
            # unacknowledged windows, the start marker and clock replies
            assert w.out_q.qsize() <= MAX_UNACKED_WINQ + 3
    assert seen == 6 and farm.stats()['queue_fallback'] == 6


def test_farm_worker_crash_fails_one_video_and_respawns(tmp_path):
    """A worker killed mid-video fails that video alone; the videos queued
    behind it go to a respawned worker and arrive byte-exact."""
    paths = [tmp_path / n for n in ('a.bin', 'CRASH.bin', 'b.bin', 'c.bin',
                                    'd.bin')]
    farm = DecodeFarm(SyntheticRecipe(n_windows=8), workers=2,
                      ring_bytes=1 << 20)
    tasks, got, _ = _drain(farm, paths)
    for t in tasks:
        if os.path.basename(t.path) == 'CRASH.bin':
            assert t.failed and t.exhausted
            continue
        assert not t.failed and len(got[t.path]) == 8, t.path
        for i, (_, w) in enumerate(got[t.path]):
            np.testing.assert_array_equal(w, expected_window(t.path, i))
    st = farm.stats()
    assert st['respawns'] >= 1 and st['videos_failed'] == 1
    assert st['videos_done'] == 5
    assert not any(os.path.exists(f'/dev/shm/{n}') for n in farm.ring_names)


@pytest.mark.parametrize('name', ['BAD.bin', 'FLOAT.bin'])
def test_farm_decode_error_fails_one_video(tmp_path, capsys, name):
    """An exception inside one video's decode (an unreadable file, a
    window that is not uint8) is that video's error, reported as the
    per-video loop reports it; the worker stays up for the others."""
    paths = [tmp_path / 'a.bin', tmp_path / name, tmp_path / 'b.bin']
    farm = DecodeFarm(SyntheticRecipe(n_windows=3), workers=1,
                      ring_bytes=1 << 20)
    tasks, got, nudges = _drain(farm, paths)
    bad = tasks[1]
    assert bad.failed and bad.exhausted
    assert [len(got[t.path]) for t in tasks] == [3, int(name == 'BAD.bin'), 3]
    assert nudges == int(name == 'FLOAT.bin')
    assert not tasks[0].failed and not tasks[2].failed
    st = farm.stats()
    assert (st['respawns'], st['videos_failed']) == (0, 1)
    err = capsys.readouterr().err
    assert f'decode farm worker failed {bad.path}' in err
    assert ('cannot decode' if name == 'BAD.bin' else 'must be uint8') in err


def test_farm_admission_skips_without_decoding(tmp_path):
    """A video the gate turns away ends at once with a NUDGE and never
    reaches a worker; a gate that raises fails that video only."""
    paths = [tmp_path / n for n in ('a.bin', 'skip.bin', 'raise.bin')]

    def admit(task):
        name = os.path.basename(task.path)
        if name == 'raise.bin':
            raise RuntimeError('gate broke')
        return name != 'skip.bin'

    farm = DecodeFarm(SyntheticRecipe(n_windows=2), workers=1,
                      ring_bytes=1 << 20)
    tasks, got, nudges = _drain(farm, paths, admit)
    assert [len(got[t.path]) for t in tasks] == [2, 0, 0]
    assert [t.failed for t in tasks] == [False, False, True]
    assert all(t.exhausted for t in tasks) and nudges == 2
    assert farm.stats()['videos_assigned'] == 1


def test_farm_parks_a_duplicate_until_its_twin_finalizes(tmp_path):
    """Two tasks whose cache keys match: the second parks while the first
    decodes, and once the first is finalized its gate runs again, which
    (as a cache hit would) ends it without a decode, while the task
    stream is still open."""
    import threading
    pk = _packing()
    a, b = pk.VideoTask(str(tmp_path / 'a.bin')), pk.VideoTask(str(tmp_path / 'b.bin'))
    stop, timed_out = threading.Event(), []

    def feed():
        yield a
        yield b
        deadline = time.monotonic() + 20
        while not stop.is_set():     # an open stream, FLUSH between bursts
            if time.monotonic() > deadline:
                timed_out.append(True)
                return
            time.sleep(0.05)
            yield pk.FLUSH

    farm = DecodeFarm(SyntheticRecipe(n_windows=6), workers=2,
                      ring_bytes=1 << 20, cache_key_fn=lambda p: 'same-content')
    for item in farm.stream(feed(), lambda t: t is a or not a.finalized):
        if item is not pk.FLUSH and item is not pk.NUDGE:
            task, window, meta = item
            np.testing.assert_array_equal(window, expected_window(task.path, meta))
        if a.exhausted and not a.finalized:
            a.finalized = True            # the packed loop's finalize
        if b.exhausted:
            stop.set()
    assert not timed_out, 'the duplicate stayed parked until the stream ended'
    assert a.emitted == 6 and not a.failed
    assert b.exhausted and not b.failed and b.emitted == 0
    st = farm.stats()
    assert (st['deduped'], st['videos_assigned']) == (1, 1)
    assert merge_farm_stats([st, st])['deduped'] == 2


def test_farm_parked_duplicate_decodes_when_its_twin_failed(tmp_path):
    """A twin that fails publishes nothing: the parked task's gate lets
    it through and it decodes itself. A key function that raises skips
    parking."""
    pk = _packing()
    bad = pk.VideoTask(str(tmp_path / 'BAD.bin'))
    dup = pk.VideoTask(str(tmp_path / 'dup.bin'))
    odd = pk.VideoTask(str(tmp_path / 'odd.bin'))

    def key_fn(path):
        if 'odd' in path:
            raise OSError('unreadable')
        return 'same-content'

    farm = DecodeFarm(SyntheticRecipe(n_windows=3), workers=1,
                      ring_bytes=1 << 20, cache_key_fn=key_fn)
    got = {}
    for item in farm.stream(iter([bad, dup, odd]), lambda t: True):
        if item is not pk.FLUSH and item is not pk.NUDGE:
            got[item[0].path] = got.get(item[0].path, 0) + 1
        if bad.exhausted:
            bad.finalized = True
    assert bad.failed and not dup.failed and not odd.failed
    assert got[dup.path] == 3 and got[odd.path] == 3
    assert farm.stats()['deduped'] == 1 and farm.stats()['videos_assigned'] == 3


def test_farm_flush_waits_for_the_videos_before_it(tmp_path):
    """A FLUSH in the task stream comes out after every window of the
    videos before it, as the in-process windower yields it."""
    pk = _packing()
    paths = [tmp_path / 'a.bin', tmp_path / 'b.bin']
    tasks = [pk.VideoTask(str(p)) for p in paths]
    farm = DecodeFarm(SyntheticRecipe(n_windows=5), workers=2,
                      ring_bytes=1 << 20)
    order = []
    for item in farm.stream(iter([tasks[0], pk.FLUSH, tasks[1]]),
                            lambda t: True):
        if item is pk.FLUSH:
            order.append('FLUSH')
        elif item is not pk.NUDGE:
            order.append(item[0].path)
    assert order.index('FLUSH') > max(i for i, p in enumerate(order)
                                      if p == tasks[0].path)
    assert order.count(tasks[0].path) == order.count(tasks[1].path) == 5


def test_farm_traces_worker_decode_on_the_parents_clock(tmp_path):
    """With a tracer, each window adds a 'decode' row (its span placed on
    the parent's clock, inside the run, under its worker's pid lane) and
    an 'shm_copy' row whose occupancy is the ring's fill."""
    from video_features_torch.obs.spans import SpanRecorder
    tracer = Tracer(recorder=SpanRecorder())
    farm = DecodeFarm(SyntheticRecipe(n_windows=6), workers=2,
                      ring_bytes=1 << 20, tracer=tracer)
    t0 = time.perf_counter()
    _drain(farm, [tmp_path / 'a.bin', tmp_path / 'b.bin'])
    t1 = time.perf_counter()
    rep = tracer.report()
    assert rep['decode']['count'] == rep['shm_copy']['count'] == 12
    assert 0 < rep['shm_copy']['occupancy'] <= 1
    # origin 0: ts is the CLOCK reading itself, in microseconds
    decode = [e for e in tracer.recorder.snapshot(origin=0.0)
              if e['name'] == 'decode']
    assert len(decode) == 12
    for e in decode:
        start = e['ts'] / 1e6
        assert t0 <= start and start + e['dur'] / 1e6 <= t1 + 1e-6
        assert e['pid'] != os.getpid() and e['tid'] == e['args']['worker']
    assert len({e['pid'] for e in decode}) >= 1
    assert 'shm_copy' in tracer.summary()


def test_farm_clock_calibration_trusts_tight_exchanges_only():
    """A clock reply whose round trip spans the worker's start is not
    trusted (the offset stays 0); a tight one sets the offset, and a
    looser one after it, or one from before a respawn, changes nothing."""
    from video_features_torch.farm.farm import CLOCK_RTT_MAX_S, _Worker
    farm, w = DecodeFarm(None), _Worker(0, 0)
    now = time.perf_counter()
    farm._handle(w, ('clock', 0, 0, now - 0.8, now - 0.1))
    assert w.clock_offset == 0.0
    t = time.perf_counter()
    farm._handle(w, ('clock', 0, 0, t, t + 5.0))      # a worker clock 5 s ahead
    assert w.clock_rtt < CLOCK_RTT_MAX_S
    assert abs(w.clock_offset + 5.0) < CLOCK_RTT_MAX_S
    kept = w.clock_offset
    farm._handle(w, ('clock', 0, 0, time.perf_counter() - 0.04, 0.0))
    farm._handle(w, ('clock', 0, 1, time.perf_counter(), 0.0))
    assert w.clock_offset == kept


@pytest.mark.parametrize('early', [False, True], ids=['drained', 'stopped'])
@pytest.mark.parametrize('package', ['port', 'jax'])
def test_farm_pending_cb_mirrors_backlog_and_zeroes_on_shutdown(tmp_path,
                                                                package,
                                                                early):
    """The stall watchdog's feed: the farm mirrors each worker's backlog
    through ``pending_cb``, and shutdown leaves every row at 0 (also when
    the stream stops at its first window, with videos still assigned), so
    a retired farm never reads as a stall; the JAX package's farm on the
    same stream reports the same rows."""
    if package == 'jax':
        from video_features_tpu.farm import DecodeFarm as Farm
        from video_features_tpu.parallel.packing import FLUSH, NUDGE, VideoTask
    else:
        Farm, VideoTask = DecodeFarm, _packing().VideoTask
        FLUSH, NUDGE = _packing().FLUSH, _packing().NUDGE
    calls = []
    tasks = [VideoTask(str(tmp_path / f'pb{i}.bin')) for i in range(3)]
    farm = Farm(SyntheticRecipe(n_windows=6), workers=2, ring_bytes=1 << 20,
                pending_cb=lambda idx, n: calls.append((idx, n)))
    stream = farm.stream(iter(tasks), lambda t: True)
    for item in stream:
        if early and item is not FLUSH and item is not NUDGE:
            break
    if early:
        assert any(n > 0 for _, n in calls)      # work still assigned
        farm.shutdown()
        stream.close()
    else:
        assert all(t.exhausted and not t.failed for t in tasks)
    last, busy = {}, set()
    for idx, n in calls:
        last[idx] = n
        if n > 0:
            busy.add(idx)
    assert last == {0: 0, 1: 0}          # zeroed at shutdown
    if not early:
        assert busy == {0, 1}            # each worker's backlog was mirrored


def test_farm_without_a_recipe_does_not_start():
    farm = DecodeFarm(None, workers=2)
    with pytest.raises(FarmUnavailable, match='no decode recipe'):
        farm.start()
    st = farm.stats()
    assert not st['ran'] and 'no decode recipe' in st['fallback']
    assert farm.ring_names == []


def test_merge_farm_stats_sums_counters():
    a = {'windows': 3, 'respawns': 1, 'videos_assigned': 2, 'ran': True}
    b = {'windows': 4, 'queue_fallback': 2}
    merged = merge_farm_stats([a, b, None])
    assert (merged['windows'], merged['respawns'], merged['queue_fallback'],
            merged['videos_assigned'], merged['bytes']) == (7, 1, 2, 2, 0)
    assert 'ran' not in merged


# -- imports of the worker side --------------------------------------------


def test_farm_modules_import_no_torch():
    """What a worker imports (the farm, the recipes, io/video.py, the host
    transforms, the windowers, the tracer) pulls in neither torch nor jax."""
    code = ('import sys\n'
            'import video_features_torch.farm.worker, video_features_torch.farm\n'
            'import video_features_torch.io.video, video_features_torch.ops.host_transforms\n'
            'import video_features_torch.extract.streaming\n'
            'print(sorted(m for m in ("torch", "jax", "video_features_tpu") '
            'if m in sys.modules))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    return write_noise_clip(tmp_path_factory.mktemp('farmclip') / 'c.mp4', 14,
                            w=80, h=60, seed=3)


def test_spawned_worker_imports_neither_torch_nor_jax(clip, tmp_path):
    """A worker decoding and resizing a real clip through the i3d recipe
    has imported neither torch nor jax nor the JAX package."""
    recipe = StackRecipe(win=5, step=4, batch_size=8, fps=None, total=None,
                         tmp_path=str(tmp_path), keep_tmp=False, backend='cv2',
                         transform=('edge_resize', 32, 'bilinear'))
    farm = DecodeFarm(ProbeRecipe(recipe), workers=1, ring_bytes=1 << 20)
    tasks, got, _ = _drain(farm, [clip])
    assert not tasks[0].failed and len(got[clip]) == 3
    assert tasks[0].info['modules'] == []
    assert tasks[0].info['pid'] != os.getpid()


# -- the recipes, against the JAX package's and the in-process windows --------


FAMILIES = {
    'i3d': dict(streams='rgb', stack_size=10, step_size=4, batch_size=2),
    'i3d_device_resize': dict(streams='rgb', stack_size=10, step_size=4,
                              batch_size=2, device_resize=True),
    'resnet': dict(model_name='resnet18', batch_size=4),
    'clip': dict(model_name='ViT-B/32', batch_size=4),
}


def _jax_recipe(ft, ex):
    """The JAX package's recipe for the port extractor ``ex``'s settings,
    built by the JAX extractors' own methods (on a stand-in ``self``)."""
    from video_features_tpu.extract.clip import ExtractCLIP
    from video_features_tpu.extract.i3d import ExtractI3D
    from video_features_tpu.extract.resnet import ExtractResNet
    from video_features_tpu.farm.recipes import FramewiseRecipe
    if ft.startswith('i3d'):
        return ExtractI3D.farm_recipe(SimpleNamespace(
            stack_size=ex.stack_size, step_size=ex.step_size,
            extraction_fps=ex.extraction_fps, tmp_path=ex.tmp_path,
            keep_tmp_files=ex.keep_tmp_files, decode_backend=ex.decode_backend,
            device_resize=ex.device_resize))
    cls = {'resnet': ExtractResNet, 'clip': ExtractCLIP}[ft]
    return FramewiseRecipe(
        batch_size=ex.batch_size, fps=ex.extraction_fps,
        total=ex.extraction_total, tmp_path=ex.tmp_path,
        keep_tmp=ex.keep_tmp_files, backend=ex.decode_backend,
        transform=cls.host_transform_spec(ex))


@pytest.mark.parametrize('ft', list(FAMILIES))
def test_recipes_equal_the_jax_packages_and_the_in_process_windows(
        clip, tmp_path, ft):
    """On one cv2-written clip, the port extractor's farm recipe yields
    the windows of the JAX package's recipe and of its own in-process
    ``packed_windows``, byte for byte (i3d's host resize, i3d's raw
    frames under device_resize, resnet's bilinear and clip's bicubic
    resize and crop), with the same video info."""
    ex = create_extractor(load_config(ft.split('_')[0], overrides=dict(
        video_paths=clip, device='cpu', allow_random_weights=True,
        output_path=str(tmp_path / 'o'), tmp_path=str(tmp_path / 't'),
        decode_backend='cv2', **FAMILIES[ft])))
    info, windows = ex.farm_recipe().open(clip)
    jax_info, jax_windows = _jax_recipe(ft, ex).open(clip)
    task = _packing().VideoTask(clip)
    ours, theirs = list(windows), list(jax_windows)
    in_process = list(ex.packed_windows(task))
    assert len(ours) == len(theirs) == len(in_process) > 0
    for (w, m), (jw, jm), (pw, pm) in zip(ours, theirs, in_process):
        assert w.dtype == np.uint8 and w.tobytes() == jw.tobytes() == pw.tobytes()
        assert w.shape == jw.shape == pw.shape and m == jm == pm
    assert info == jax_info == task.info


# -- the packed loop and the CLI through the farm ---------------------------


def _npys(root):
    return {f.name: f.read_bytes() for f in sorted(Path(root).rglob('*.npy'))}


@pytest.fixture(scope='module')
def worklist(tmp_path_factory):
    d = tmp_path_factory.mktemp('farmvids')
    return [str(write_noise_clip(d / f'f{i}.mp4', n, w=64, h=48, seed=i))
            for i, n in enumerate((9, 4, 14))]


@pytest.fixture(scope='module')
def resnet(worklist, tmp_path_factory):
    """A resnet18 extractor and its packed outputs at decode_workers 1."""
    root = tmp_path_factory.mktemp('farmresnet')
    ex = create_extractor(load_config('resnet', overrides=dict(
        video_paths=worklist, device='cpu', allow_random_weights=True,
        model_name='resnet18', batch_size=4, on_extraction='save_numpy',
        output_path=str(root / 'cfg'), tmp_path=str(root / 'tmp'))))
    ex.extract_packed(_tasks(worklist, root / 'dw1'))
    assert ex._farm is None
    return ex, _npys(root / 'dw1')


def test_packed_farm_outputs_equal_in_process(resnet, worklist, tmp_path,
                                              monkeypatch):
    """resnet18 packed at decode_workers 2 (the farm) writes the bytes of
    decode_workers 1; the farm ran and shipped every frame through its
    rings."""
    ex, ref = resnet
    monkeypatch.setattr(ex, 'decode_workers', 2)
    ex.extract_packed(_tasks(worklist, tmp_path))
    assert _npys(tmp_path) == ref and len(ref) == 9
    st = ex._farm.stats()
    assert st['ran'] and (st['windows'], st['videos_assigned'], st['queue_fallback'],
                          st['respawns']) == (27, 3, 0, 0)


def test_packed_farm_falls_back_without_a_recipe(resnet, worklist, tmp_path,
                                                 monkeypatch):
    """A family with no recipe decodes in-process, with a warning naming
    decode_workers and the cause; the farm's stats say it did not run."""
    ex, ref = resnet
    monkeypatch.setattr(ex, 'decode_workers', 2)
    monkeypatch.setattr(ex, 'farm_recipe', lambda: None)
    with pytest.warns(UserWarning, match='decode_workers=2.*no decode recipe'):
        ex.extract_packed(_tasks(worklist, tmp_path))
    assert _npys(tmp_path) == ref
    st = ex._farm.stats()
    assert not st['ran'] and 'no decode recipe' in st['fallback']


def test_packed_farm_fault_isolation(resnet, worklist, tmp_path, monkeypatch,
                                     capsys):
    """Through the farm, a path that does not open fails alone; the other
    videos' files are those of a clean run."""
    ex, ref = resnet
    monkeypatch.setattr(ex, 'decode_workers', 2)
    bad = str(tmp_path / 'gone.mp4')
    paths = worklist[:1] + [bad] + worklist[1:]
    ex.extract_packed(_tasks(paths, tmp_path / 'o'))
    assert f'video={bad}' in capsys.readouterr().err
    assert _npys(tmp_path / 'o') == ref
    assert ex._farm.stats()['videos_failed'] == 1


def test_serve_watchdog_trips_on_a_held_farm_worker(worklist, tmp_path,
                                                   monkeypatch):
    """A serve daemon with ``decode_workers=2`` and ``watchdog_stall_s``:
    a farm worker held before its decode trips exactly one stall report
    on its own ``<entry>/farm-wN`` row (fed by the farm's ``pending_cb``)
    and none on the other worker's; once released, the request
    completes and every farm row is back at 0 pending."""
    import shutil

    from video_features_torch.extract.resnet import ExtractResNet
    from video_features_torch.obs import events
    from video_features_torch.serve.client import ServeClient
    from video_features_torch.serve.server import ExtractionServer
    release = tmp_path / 'release'
    recipe = ExtractResNet.farm_recipe
    monkeypatch.setattr(ExtractResNet, 'farm_recipe',
                        lambda self: HoldRecipe(recipe(self), str(release)))
    held = str(tmp_path / 'HOLD.mp4')
    shutil.copy(worklist[0], held)
    server = ExtractionServer(base_overrides=dict(
        device='cpu', model_name='resnet18', batch_size=4,
        allow_random_weights=True, on_extraction='save_numpy',
        tmp_path=str(tmp_path / 'tmp'), decode_workers=2,
        watchdog_stall_s=5.0)).start()
    try:
        client = ServeClient(port=server.port)
        # a first request boots both farm workers, so that the held
        # request's other video decodes at once
        st = client.wait(client.submit(
            'resnet', worklist[:2], overrides={'output_path': str(tmp_path / 'w')}),
            timeout_s=180)
        assert st['state'] == 'done', st
        farm_row = re.compile(re.escape(server.pool.entries()[0].wd_key)
                              + r'/farm-w\d+$')

        def farm_stalls():
            return [e['fields'] for e in events.events_tail(500)
                    if e['msg'] == 'watchdog: worker stalled with queued '
                    'work' and farm_row.match(e['fields']['worker'])]
        before = len(farm_stalls())
        rid = client.submit('resnet', [held, worklist[1]],
                            overrides={'output_path': str(tmp_path / 'o')})
        deadline = time.monotonic() + 90
        while len(farm_stalls()) == before and time.monotonic() < deadline:
            time.sleep(0.1)
        release.touch()
        st = client.wait(rid, timeout_s=180)
        assert st['state'] == 'done', st
        stalls = farm_stalls()[before:]
        assert len(stalls) == 1, stalls
        assert int(stalls[0]['pending']) >= 1
        rows = {w: r for w, r in server.watchdog.snapshot()['workers'].items()
                if farm_row.match(w)}
        assert len(rows) == 2 and stalls[0]['worker'] in rows
        assert all(r['pending'] == 0 for r in rows.values()), rows
    finally:
        release.touch()
        server.drain(wait=True, grace_s=120)


def test_cli_i3d_packed_runs_the_farm_at_the_yaml_default(tmp_path, monkeypatch,
                                                          capsys):
    """``feature_type=i3d pack_across_videos=true`` at the YAML's
    decode_workers 2 decodes through two worker processes, and both I3D
    towers (RAFT at one iteration) write the bytes of decode_workers=1."""
    from video_features_torch.cli import main
    from video_features_torch.farm import farm as farm_mod
    started = []
    start = farm_mod.DecodeFarm.start

    def spy(self):
        if not self._started:
            started.append(self.n_workers)
        return start(self)
    monkeypatch.setattr(farm_mod.DecodeFarm, 'start', spy)
    path = write_noise_clip(tmp_path / 'one.mp4', 11, w=64, h=48, seed=5)
    args = ['feature_type=i3d', 'device=cpu', 'allow_random_weights=true',
            f'video_paths=[{path}]', 'pack_across_videos=true', 'stack_size=10',
            'step_size=10', 'batch_size=1', 'raft_iters=1',
            f'tmp_path={tmp_path / "tmp"}']
    assert main(args + [f'output_path={tmp_path / "farm"}']) == 0
    assert 'decode_workers: 2' in capsys.readouterr().out
    assert started == [2]
    assert main(args + [f'output_path={tmp_path / "dw1"}', 'decode_workers=1']) == 0
    assert started == [2]
    farm, ref = _npys(tmp_path / 'farm'), _npys(tmp_path / 'dw1')
    assert farm == ref and len(ref) == 1
    assert np.load(tmp_path / 'farm' / 'i3d' / 'one.npy').shape == (1, 2048)
