"""Places where the port had drifted from the JAX package, held to it on
the CPU: the decode farm's death dump and warning text
(video_features_torch/farm/farm.py::DecodeFarm._supervise), RAFT's
flow-viz PNG write (video_features_torch/extract/raft.py::
ExtractRAFT.maybe_show_pred), which must report any failure through the
event log and never fail the extraction, and the TF32 flags that two
lanes share across threads (video_features_torch/utils/device.py::
precision_scope): a JAX program carries its own precision, so two lanes
at once must each run their own; and the decode farm's drain, which must
never let a live session's FLUSH overtake its last window
(video_features_torch/farm/farm.py::DecodeFarm._drain)."""
import inspect
import re
import threading

import numpy as np
import pytest

from video_features_torch.extract import raft as extract
from video_features_torch.io import video
from video_features_torch.obs import events

FPS = 25.0


def test_farm_death_reason_and_event_text_are_the_jax_packages():
    """The bundle reason and the warning's wording, read from both
    packages' ``_supervise`` source, are the same strings."""
    from video_features_tpu.farm import farm as jax_farm
    from video_features_torch.farm import farm as port_farm
    jax_src = inspect.getsource(jax_farm.DecodeFarm._supervise)
    port_src = inspect.getsource(port_farm.DecodeFarm._supervise)
    reason = re.compile(r"_blackbox\.dump\(\s*'(\w+)'")
    assert reason.findall(jax_src) == ['farm_worker_death']
    assert reason.findall(port_src) == reason.findall(jax_src)
    text = re.compile(r"died '\s*f'\(exitcode \{w\.proc\.exitcode\}\); '"
                      r"|respawning with \{len\(requeue\)\} queued video\(s\)"
                      r"|no video in flight|decode farm worker \{w\.idx\} ")
    jax_parts = text.findall(jax_src)
    assert len(set(jax_parts)) == 4
    assert set(text.findall(port_src)) == set(jax_parts)


@pytest.mark.parametrize('fault', ['output_path_is_a_file', 'imwrite_raises'])
def test_flow_viz_failure_is_an_event_and_extraction_goes_on(
        tmp_path, monkeypatch, fault):
    out = tmp_path / 'out'
    if fault == 'output_path_is_a_file':
        out.write_bytes(b'')            # flow_debug/ cannot be made under it
    else:
        import cv2

        def imwrite(*a, **k):
            raise cv2.error('imwrite refused')
        monkeypatch.setattr(cv2, 'imwrite', imwrite)
    ex = extract.ExtractRAFT({
        'feature_type': 'raft', 'batch_size': 2, 'raft_iters': 1,
        'device': 'cpu', 'allow_random_weights': True, 'show_pred': True,
        'on_extraction': 'save_numpy', 'output_path': str(out)})
    frames = list(np.random.RandomState(0).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    before = events.event_counts().get(('WARNING', 'raft'), 0)
    feats = ex.extract_frames(
        video.batch_frames(iter(frames), 3, FPS, overlap=1), FPS)
    assert feats['raft'].shape == (2, 2, 64, 64)
    assert events.event_counts()[('WARNING', 'raft')] == before + 1
    last = [e for e in events.events_tail(8) if e['subsystem'] == 'raft']
    assert last[-1]['msg'] == 'flow viz PNG write skipped'
    assert last[-1]['level'] == 'WARNING' and 'exc' in last[-1]


# -- precision_scope across threads ----------------------------------------

TF32 = {'highest': (False, False), 'tensorfloat32': (True, True)}
START = (False, True)
WAIT_S = 60


def _flags():
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(flags):
    import torch
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _signal_on_wait(monkeypatch):
    """An event set whenever a scope blocks on the scopes' condition, so a
    test can tell "B waits for A" from "B is inside" without sleeping."""
    from video_features_torch.utils import device
    blocked = threading.Event()

    class Signalling(threading.Condition):
        def wait(self, timeout=None):
            blocked.set()
            return super().wait(timeout)
    monkeypatch.setattr(device, '_scope_cond', Signalling(), raising=False)
    return blocked


def _run(*targets):
    errors = []

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as e:      # reported by the main thread
                errors.append(e)
        return run
    threads = [threading.Thread(target=guard(t), daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), 'a scope never returned'
    if errors:
        raise errors[0]


@pytest.fixture
def start_flags():
    saved = _flags()
    _set_flags(START)
    yield
    _set_flags(saved)


@pytest.mark.parametrize('first,second', [('tensorfloat32', 'highest'),
                                          ('highest', 'tensorfloat32')],
                         ids=['a_tf32_first', 'b_highest_first'])
def test_two_lanes_on_two_threads_each_run_their_own(start_flags, monkeypatch,
                                                      first, second):
    """(a), (b): thread A enters ``first``, then thread B asks for
    ``second``. A reads its own lane at every checkpoint while B waits
    (or, before the repair, overwrote it); B then reads its own; after
    both, the flags are the ones they started at."""
    from video_features_torch.utils.device import precision_scope
    blocked = _signal_on_wait(monkeypatch)
    a_in, b_progress = threading.Event(), threading.Event()
    a_checked, a_out = threading.Event(), threading.Event()
    seen = {'a': [], 'b': []}

    def thread_a():
        with precision_scope(first):
            seen['a'].append(_flags())
            a_in.set()
            assert b_progress.wait(WAIT_S)
            seen['a'].append(_flags())
            a_checked.set()
        a_out.set()

    def thread_b():
        assert a_in.wait(WAIT_S)
        # B's progress: it blocks on the condition, or (before the
        # repair) gets inside at once
        threading.Thread(target=lambda: (blocked.wait(WAIT_S),
                                          b_progress.set()),
                         daemon=True).start()
        with precision_scope(second):
            b_progress.set()
            seen['b'].append(_flags())
            # stay inside until A has read its flags and left
            assert a_checked.wait(WAIT_S) and a_out.wait(WAIT_S)
            seen['b'].append(_flags())
    _run(thread_a, thread_b)
    assert seen['a'] == [TF32[first]] * 2
    assert seen['b'] == [TF32[second]] * 2
    assert _flags() == START


def test_same_lane_scopes_overlap_across_threads(start_flags):
    """(c): two ``tensorfloat32`` scopes overlap; the first to leave does
    not restore the flags under the second, the last one does."""
    from video_features_torch.utils.device import precision_scope
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {'a': [], 'b': []}

    def thread_a():
        with precision_scope('tensorfloat32'):
            seen['a'].append(_flags())
            a_in.set()
            assert b_in.wait(WAIT_S)
            seen['a'].append(_flags())
        a_out.set()

    def thread_b():
        assert a_in.wait(WAIT_S)
        with precision_scope('tensorfloat32'):
            seen['b'].append(_flags())
            b_in.set()
            assert a_out.wait(WAIT_S)
            seen['b'].append(_flags())
    _run(thread_a, thread_b)
    assert seen == {'a': [TF32['tensorfloat32']] * 2,
                    'b': [TF32['tensorfloat32']] * 2}
    assert _flags() == START


def test_a_nested_scope_of_another_lane_raises(start_flags):
    """(d): on one thread, a nested scope of the same lane re-enters; one
    of the other lane raises at once (waiting would wait for itself), and
    the outer scope keeps its flags."""
    from video_features_torch.utils.device import precision_scope
    with precision_scope('highest'):
        with precision_scope('float32'):
            assert _flags() == TF32['highest']
        with pytest.raises(RuntimeError, match='one TF32 setting'):
            with precision_scope('tensorfloat32'):
                pass
        assert _flags() == TF32['highest']
    assert _flags() == START
    # the failed entry left nothing open: another thread's lane enters
    seen = []
    _run(lambda: seen.append(_scoped_flags('tensorfloat32')))
    assert seen == [TF32['tensorfloat32']] and _flags() == START


def test_a_waiting_lane_goes_before_new_scopes_of_the_lane_in_force(
        start_flags, monkeypatch):
    """(e): two ``tensorfloat32`` threads hand over so that one of them is
    always inside. A ``highest`` scope that asks meanwhile must not wait
    for ever: once it waits, new outermost ``tensorfloat32`` scopes queue
    behind it, and it enters as soon as the scopes open when it asked have
    exited (before the fix, A2 and A1's re-entry went first, and a longer
    hand-over chain kept it out for as long as the chain ran)."""
    from video_features_torch.utils import device
    from video_features_torch.utils.device import precision_scope
    waiting = {name: threading.Event() for name in ('a2', 'b')}

    class Signalling(threading.Condition):
        def wait(self, timeout=None):
            name = threading.current_thread().name
            if name in waiting:
                waiting[name].set()
            return super().wait(timeout)
    monkeypatch.setattr(device, '_scope_cond', Signalling(), raising=False)
    device.scope_wait_stats(reset=True)
    log = []
    a1_in, a2_progress = threading.Event(), threading.Event()

    def a1():
        with precision_scope('tensorfloat32'):
            log.append(('a1', _flags()))
            a1_in.set()
            # hand over: leave once A2 is inside or waiting to get in
            assert a2_progress.wait(WAIT_S)
        with precision_scope('tensorfloat32'):
            log.append(('a1 again', _flags()))

    def a2():
        assert waiting['b'].wait(WAIT_S)
        threading.Thread(target=lambda: (waiting['a2'].wait(WAIT_S),
                                          a2_progress.set()),
                         daemon=True).start()
        with precision_scope('tensorfloat32'):
            a2_progress.set()
            log.append(('a2', _flags()))

    def b():
        assert a1_in.wait(WAIT_S)
        with precision_scope('highest'):
            log.append(('b', _flags()))
    threads = [threading.Thread(target=fn, name=name, daemon=True)
               for name, fn in (('a1', a1), ('a2', a2), ('b', b))]
    errors = []
    for t in threads:
        t.run = (lambda run: lambda: _collect(run, errors))(t.run)
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), 'a scope never returned'
    if errors:
        raise errors[0]
    names = [name for name, _ in log]
    assert names[:2] == ['a1', 'b'], names
    assert sorted(names[2:]) == ['a1 again', 'a2']
    assert all(flags == TF32['highest' if name == 'b' else 'tensorfloat32']
               for name, flags in log)
    assert _flags() == START
    stats = device.scope_wait_stats(reset=True)
    assert stats['waits'] >= 2 and stats['longest_wait_s'] > 0
    assert device.scope_wait_stats() == {'waits': 0, 'longest_wait_s': 0.0}


def _collect(run, errors):
    try:
        run()
    except BaseException as e:      # reported by the main thread
        errors.append(e)


def _scoped_flags(precision):
    from video_features_torch.utils.device import precision_scope
    with precision_scope(precision):
        return _flags()


# -- the decode farm's live windows and their FLUSH -------------------------


def test_a_live_flush_never_overtakes_its_window():
    """A live feeder appends its last window, then its FLUSH. If it does
    so just after the drain found no live window, the FLUSH must still go
    out after that window (video_features_torch/farm/farm.py::
    DecodeFarm._drain): before the fix it went first, and the window
    waited in a partial pool for a FLUSH that never came, until the
    stream ended (a live session's tail rows stalled)."""
    from collections import deque

    from video_features_torch.farm.farm import DecodeFarm
    from video_features_torch.parallel.packing import FLUSH
    farm = DecodeFarm(recipe=None, workers=1)
    farm._dispatch_done = True
    item = ('task', np.zeros((2, 2), np.uint8), 0)

    class RacingFeeder(deque):
        fired = False

        def __bool__(self):
            empty = not len(self)
            if empty and not self.fired:
                # the feeder runs between the drain's two checks
                RacingFeeder.fired = True
                self.append(item)
                farm._append_flush()
            return not empty
    farm._live_out = RacingFeeder()
    stream = farm._drain()
    got = [next(stream), next(stream)]
    stream.close()
    assert got[0] is item and got[1] is FLUSH


# -- the kernel libraries' build key -----------------------------------------


def test_a_library_is_named_by_its_source_flags_and_nvcc_release(tmp_path,
                                                                 monkeypatch):
    """Another ``NVCC_FLAGS`` or another nvcc release gives another library
    file (no build runs: nvcc is faked); the same ones find the library
    built. A ``compilation_cache_dir`` other than the JAX default or null
    names the build directory, ``<dir>/gpu``."""
    import subprocess
    from pathlib import Path

    from video_features_torch.ops import _kernels
    nvcc = {'path': '/opt/cuda-12.4/bin/nvcc', 'release': '12.4, V12.4.131'}

    def fake_run(cmd, **kw):
        if '--version' in cmd:
            return subprocess.CompletedProcess(
                cmd, 0, 'nvcc: NVIDIA (R) Cuda compiler\nCuda '
                f'compilation tools, release {nvcc["release"]}\n', '')
        Path(cmd[cmd.index('-o') + 1]).write_bytes(b'elf')
        return subprocess.CompletedProcess(cmd, 0, 'ptxas info', '')
    monkeypatch.setattr(_kernels, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_kernels, '_nvcc', lambda: nvcc['path'])
    monkeypatch.setattr(_kernels.subprocess, 'run', fake_run)
    base = _kernels.build('corr_lookup')[0]
    flags = _kernels.NVCC_FLAGS
    monkeypatch.setattr(_kernels, 'NVCC_FLAGS', flags + ('-lineinfo',))
    other_flags = _kernels.build('corr_lookup')[0]
    monkeypatch.setattr(_kernels, 'NVCC_FLAGS', flags)
    assert _kernels.build('corr_lookup') == (base, '')
    nvcc.update(path='/opt/cuda-12.6/bin/nvcc', release='12.6, V12.6.20')
    other_release = _kernels.build('corr_lookup')[0]
    assert len({base, other_flags, other_release}) == 3
    assert {p.parent for p in (base, other_flags, other_release)} == {
        tmp_path / 'build'}
    assert _kernels.library_identity('corr_lookup')['nvcc'] == (
        'Cuda compilation tools, release 12.6, V12.6.20')
    monkeypatch.setattr(_kernels, '_build_dir', None)
    assert _kernels.configure_build_dir(str(tmp_path / 'cc')) == tmp_path / 'cc' / 'gpu'
    assert _kernels.build('corr_lookup')[0].parent == tmp_path / 'cc' / 'gpu'
    for default in ('~/.cache/video_features_tpu/xla', None):
        assert _kernels.configure_build_dir(default) == tmp_path / 'build'
