"""The port's packed corpus loop (video_features_torch/parallel/packing.py,
the packed hooks of every video family, ``extract_packed`` and the CLI
route) on the CPU, the counterpart of tests/test_packing.py: packed
outputs equal the per-video loop's element for element and agree with
the JAX package's packed outputs, ``inflight`` changes no byte, and the
per-video contracts (resume, fault isolation, empty outputs) hold."""
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.config import load_config
from video_features_torch.parallel.packing import VideoTask, packed_batches
from video_features_torch.registry import PACKED_FEATURES, create_extractor
from video_features_torch.utils.output import make_path
from video_features_torch.utils.tracing import Tracer

JAX_REL_L2 = 1e-5     # float32 on both sides, different sum orders
FAMILY = {
    'resnet': dict(model_name='resnet18', batch_size=4),
    'clip': dict(model_name='ViT-B/32', batch_size=4),
    'timm': dict(model_name='vit_tiny_patch16_224', batch_size=4),
    'i3d': dict(streams='rgb', stack_size=10, step_size=10, batch_size=2,
                concat_rgb_flow=False),
    'r21d': dict(stack_size=4, step_size=4, batch_size=2),
    's3d': dict(stack_size=16, step_size=16, batch_size=2),
}
# the families whose packed loop also runs at inflight 1 (3 for all)
BOTH_DEPTHS = ('resnet', 'r21d')
# i3d with both streams: RAFT at 2 iterations, port side only
TWO_STREAM = dict(streams=None, stack_size=10, step_size=10, batch_size=2,
                  raft_iters=2, concat_rgb_flow=True)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several workers per machine,
    and this module's convolutions oversubscribe it otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture(scope='module')
def worklists(tmp_path_factory):
    """Per family, clips none of which fills the device batches alone:
    mixed lengths for the frame-wise families (9 + 4 + 14 frames), a
    clip of another geometry in the middle for r21d (its windows pool
    apart and flush at the end), two clips for i3d and s3d."""
    d = tmp_path_factory.mktemp('packvids')

    def clips(name, specs):
        return [str(write_noise_clip(d / f'{name}{i}.mp4', n, w=w, h=h, seed=s))
                for i, (n, w, h, s) in enumerate(specs)]
    frames = clips('f', [(9, 64, 48, 0), (4, 64, 48, 1), (14, 64, 48, 2)])
    return {'resnet': frames, 'clip': frames, 'timm': frames,
            'i3d': clips('i', [(25, 64, 48, 7), (12, 64, 48, 8)]),
            'i3d_two_stream': clips('t', [(12, 64, 48, 9), (11, 64, 48, 10)]),
            'r21d': clips('r', [(9, 64, 48, 1), (5, 80, 64, 2), (9, 64, 48, 3)]),
            's3d': clips('s', [(25, 64, 48, 21), (18, 64, 48, 22)])}


def _overrides(ft, paths, out, **kw):
    return dict(video_paths=paths, device='cpu', allow_random_weights=True,
                on_extraction='save_numpy', output_path=str(out),
                tmp_path=str(out) + '_tmp', decode_workers=1,
                **FAMILY.get(ft, {}), **kw)


def _outputs(root):
    """{file name: bytes} of every .npy under ``root``."""
    return {f.name: f.read_bytes() for f in sorted(Path(root).rglob('*.npy'))}


def _arrays(root):
    return {f.name: np.load(f) for f in sorted(Path(root).rglob('*.npy'))}


def _run_both(ex, paths, root, depths=(3,), per_video_workers=2):
    """The per-video loop (at ``per_video_workers`` decode threads) and
    the packed loop at each of ``depths``, into trees under ``root``."""
    trees = {name: str(root / name)
             for name in ('per_video', *(f'packed{d}' for d in depths))}
    ex.decode_workers = per_video_workers
    ex.output_path = trees['per_video']
    for p in paths:
        ex._extract(p)
    ex.decode_workers = 1
    for depth in depths:
        root_k = trees[f'packed{depth}']
        ex.extract_packed([VideoTask(p, out_root=root_k) for p in paths],
                          inflight=depth)
    return trees


@pytest.fixture(scope='module')
def runs(worklists, tmp_path_factory):
    """Per family: one extractor, its three output trees."""
    out = {}
    for ft in FAMILY:
        root = tmp_path_factory.mktemp(ft)
        ex = create_extractor(load_config(ft, overrides=_overrides(
            ft, worklists[ft], root / 'cfg')))
        out[ft] = (ex, _run_both(ex, worklists[ft], root,
                                 (1, 3) if ft in BOTH_DEPTHS else (3,)))
    return out


@pytest.mark.parametrize('ft', list(FAMILY))
def test_packed_equals_per_video_and_inflight_changes_no_byte(runs, ft):
    """Every output file of the packed loop (at inflight 3, and for
    resnet and r21d at 1 too) is byte-equal to the per-video loop's (run
    at 2 decode threads)."""
    _, trees = runs[ft]
    ref = _outputs(trees['per_video'])
    assert ref
    for name in sorted(set(trees) - {'per_video'}):
        got = _outputs(trees[name])
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(np.load(Path(trees[name]) / key),
                                          np.load(Path(trees['per_video']) / key),
                                          err_msg=f'{name} {key}')
        assert got == ref


@pytest.mark.parametrize('ft', list(FAMILY))
def test_packed_matches_the_jax_packages_packed(runs, worklists, ft, tmp_path):
    """The port's packed outputs against the JAX package's packed loop on
    the same seeded weights and clips."""
    from video_features_tpu.config import load_config as jax_load_config
    from video_features_tpu.registry import create_extractor as jax_create
    paths = worklists[ft]
    jex = jax_create(jax_load_config(ft, overrides=_overrides(
        ft, paths, tmp_path / 'jax', decode_backend='cv2')))
    jex.extract_packed(paths)
    ref = _arrays(jex.output_path)
    got = _arrays(runs[ft][1]['packed3'])
    assert got.keys() == ref.keys() and ref
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        if key.endswith(('_fps.npy', '_timestamps_ms.npy')) or not ref[key].size:
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            assert rel_l2(got[key], ref[key]) <= JAX_REL_L2, key


def test_two_stream_i3d_packed_equals_per_video(worklists, tmp_path):
    """Both I3D towers and RAFT (2 iterations) on two one-window clips:
    one packed batch against two padded per-video batches, byte-equal."""
    paths = worklists['i3d_two_stream']
    ex = create_extractor(load_config('i3d', overrides=dict(
        _overrides('i3d', paths, tmp_path / 'cfg'), **TWO_STREAM)))
    trees = _run_both(ex, paths, tmp_path)
    ref = _outputs(trees['per_video'])
    assert len(ref) == 2
    assert _outputs(trees['packed3']) == ref
    for p in paths:
        assert np.load(make_path(trees['per_video'], p, 'rgb', '.npy')).shape == (1, 2048)


def _resnet(runs, monkeypatch, root):
    """The module's resnet18 extractor writing under ``root``."""
    ex = runs['resnet'][0]
    monkeypatch.setattr(ex, 'output_path', str(root))
    return ex


def test_fault_isolation_bad_file(runs, worklists, monkeypatch, tmp_path, capsys):
    """A path that does not open fails alone; the other videos' files are
    those of a clean run."""
    paths = worklists['resnet']
    ex = _resnet(runs, monkeypatch, tmp_path)
    bad = str(tmp_path / 'gone.mp4')
    ex.extract_packed(paths[:1] + [bad] + paths[1:])
    assert f'extraction failed; continuing with the next video [video={bad}' \
        in capsys.readouterr().err
    assert not Path(make_path(str(tmp_path), bad, 'resnet', '.npy')).exists()
    assert _outputs(tmp_path) == _outputs(runs['resnet'][1]['packed3'])


def test_fault_isolation_mid_stream(runs, worklists, monkeypatch, tmp_path):
    """A decoder that dies after a window entered a shared batch: that
    video saves nothing, its batch-mates save what a clean run saves."""
    paths = worklists['resnet']
    victim = paths[1]
    ex = _resnet(runs, monkeypatch, tmp_path)
    orig = ex.packed_windows

    def flaky(task):
        it = orig(task)
        if task.path == victim:
            yield next(it)
            raise RuntimeError('decoder died mid-video')
        yield from it

    monkeypatch.setattr(ex, 'packed_windows', flaky)
    ex.extract_packed(paths)
    ref = _outputs(runs['resnet'][1]['packed3'])
    stem = Path(victim).stem
    assert _outputs(tmp_path) == {k: v for k, v in ref.items()
                                  if not k.startswith(stem + '_')}


@pytest.mark.parametrize('site', ['dispatch', 'readback'])
def test_fault_isolation_at_dispatch_and_readback(runs, worklists, monkeypatch,
                                                  tmp_path, site):
    """A batch whose dispatch raises, or whose readback raises (where an
    error the device raised surfaces), fails exactly its videos: the
    odd-geometry clip of the r21d worklist; the others save as in a clean
    run."""
    paths = worklists['r21d']
    ex, trees = runs['r21d']
    monkeypatch.setattr(ex, 'output_path', str(tmp_path))
    poisoned = []
    if site == 'dispatch':
        orig_step = ex.packed_step

        def bad_step(stacks):
            if stacks.shape[2] == 64:        # the 80x64 clip's geometry
                raise RuntimeError('no kernel for this geometry')
            return orig_step(stacks)
        monkeypatch.setattr(ex, 'packed_step', bad_step)
    else:
        orig_dispatch, orig_fetch = ex.dispatch, ex.fetch_outputs

        def marking_dispatch(batch):
            rb = orig_dispatch(batch)
            if batch.shape[2] == 64:
                poisoned.append(rb)
            return rb

        def bad_fetch(rb):
            if any(rb is p for p in poisoned):
                raise RuntimeError('the step failed on the device')
            return orig_fetch(rb)
        monkeypatch.setattr(ex, 'dispatch', marking_dispatch)
        monkeypatch.setattr(ex, 'fetch_outputs', bad_fetch)
    ex.extract_packed(paths, inflight=2)
    assert site == 'dispatch' or poisoned
    stem = Path(paths[1]).stem
    ref = _outputs(trees['packed3'])
    assert _outputs(tmp_path) == {k: v for k, v in ref.items()
                                  if not k.startswith(stem + '_')}


def test_a_video_behind_an_unfilled_pool_is_not_held_up(runs, worklists,
                                                         monkeypatch, tmp_path):
    """The odd-geometry r21d clip's window waits in its pool until the
    stream ends; the clip after it completes first and is written first."""
    paths = worklists['r21d']
    ex = runs['r21d'][0]
    saved = []
    save = ex.action_on_extraction

    def recording(feats, video_path, output_path=None):
        saved.append(Path(video_path).stem)
        return save(feats, video_path, output_path=output_path)
    monkeypatch.setattr(ex, 'action_on_extraction', recording)
    ex.extract_packed([VideoTask(p, out_root=str(tmp_path)) for p in paths])
    assert saved.index('r2') < saved.index('r1')


@pytest.mark.parametrize('loop', ['packed', 'per_video'])
def test_a_cuda_error_ends_the_run(runs, worklists, monkeypatch, tmp_path, loop):
    """A CUDA error is no per-video fault: every later batch would fail
    too, so it propagates instead of "Continuing..."."""
    ex = _resnet(runs, monkeypatch, tmp_path)

    def broken(frames):
        raise RuntimeError('CUDA error: an illegal memory access was encountered')
    monkeypatch.setattr(ex, 'packed_step', broken)
    with pytest.raises(RuntimeError, match='illegal memory access'):
        if loop == 'packed':
            ex.extract_packed(worklists['resnet'])
        else:
            ex._extract(worklists['resnet'][0])
    assert not _outputs(tmp_path)


def test_resume_contract(runs, worklists, monkeypatch, tmp_path, capsys):
    """A second packed run skips every video and rewrites nothing; after
    one video's files are deleted, only that video is extracted again."""
    paths = worklists['resnet']
    ex = _resnet(runs, monkeypatch, tmp_path)
    ex.extract_packed(paths)
    files = sorted(tmp_path.glob('*.npy'))
    assert len(files) == 3 * len(paths)
    mtimes = {f: f.stat().st_mtime_ns for f in files}
    capsys.readouterr()
    ex.extract_packed(paths)
    assert capsys.readouterr().out.count('already exist') == len(paths)
    assert {f: f.stat().st_mtime_ns for f in files} == mtimes
    removed = [f for f in files if f.name.startswith(Path(paths[1]).stem + '_')]
    for f in removed:
        f.unlink()
    time.sleep(0.01)
    ex.extract_packed(paths)
    for f in files:
        assert f.exists()
        if f not in removed:
            assert f.stat().st_mtime_ns == mtimes[f], f


def test_occupancy_and_the_stage_table(runs, worklists, monkeypatch, tmp_path,
                                       capsys):
    """27 frames in batches of 4: 7 batches with 27 of 28 slots real (the
    per-video loop runs 9 batches, 27 of 36), dispatch and readback each
    counted once per batch; with profile the table goes to stderr."""
    ex = _resnet(runs, monkeypatch, tmp_path)
    tracer = Tracer()
    monkeypatch.setattr(ex, 'tracer', tracer)
    monkeypatch.setattr(ex, 'profile', True)
    reports = []
    real_reset = tracer.reset
    monkeypatch.setattr(tracer, 'reset',
                        lambda: reports.append(tracer.report()) or real_reset())
    capsys.readouterr()
    ex.extract_packed(worklists['resnet'])
    captured = capsys.readouterr()
    assert 'packed worklist (3 videos, batch 4)' in captured.err
    assert 'occ%' in captured.err and 'ramp' in captured.err
    assert 'occ%' not in captured.out
    rep = reports[-1]
    assert rep['model']['count'] == rep['d2h']['count'] == rep['pack']['count'] == 7
    assert rep['model']['occupancy'] == pytest.approx(27 / 28)
    assert rep['d2h']['occupancy'] == pytest.approx(27 / 28)
    assert 'ramp' in rep['model'] and rep['save']['count'] == 3


def test_zero_window_video(runs, tmp_path):
    """A clip shorter than one window still gets its (0, 1024) file, as
    in the per-video loop."""
    ex = runs['i3d'][0]
    short = str(write_noise_clip(tmp_path / 'short.mp4', 5, seed=4))
    ex.extract_packed([VideoTask(short, out_root=str(tmp_path / 'pk'))])
    ex.output_path = str(tmp_path / 'pv')
    ex._extract(short)
    for root in ('pk', 'pv'):
        feats = np.load(make_path(str(tmp_path / root), short, 'rgb', '.npy'))
        assert feats.shape == (0, 1024) and feats.dtype == np.float32


def _summary(batches):
    return [(None if s is None else s.shape, [m for _, m in p], v)
            for s, p, v in batches]


def test_packed_batches_pools_per_geometry():
    """Windows of one geometry share a pool; a full pool flushes at
    once, partial pools flush padded at the end, a NUDGE passes as the
    batchless marker, a FLUSH flushes the partial pools first."""
    from video_features_torch.parallel.packing import FLUSH, NUDGE
    a, b = np.zeros((2, 3), np.uint8), np.ones((4, 3), np.uint8)
    stream = [('t0', a, 0), ('t1', b, 1), NUDGE, ('t0', a, 2), ('t0', a, 3),
              ('t2', b, 4)]
    out = list(packed_batches(iter(stream), 3))
    assert _summary(out) == [
        (None, [], 0), ((3, 2, 3), [0, 2, 3], 3), ((3, 4, 3), [1, 4], 2)]
    np.testing.assert_array_equal(out[2][0][2], b)
    stream = [('t0', a, 0), FLUSH, ('t1', a, 1)]
    assert _summary(packed_batches(iter(stream), 3)) == [
        ((3, 2, 3), [0], 1), (None, [], 0), ((3, 2, 3), [1], 1)]


def test_packed_batches_ages_out_a_waiting_pool():
    """With max_pool_age_s, a pool whose oldest window has waited that
    long flushes when the next window of any geometry arrives."""
    a, b = np.zeros((2, 3), np.uint8), np.ones((4, 3), np.uint8)

    def stream():
        yield 't0', a, 0
        time.sleep(0.05)
        yield 't1', b, 1

    assert _summary(packed_batches(stream(), 3, max_pool_age_s=0.01)) == [
        ((3, 2, 3), [0], 1), ((3, 4, 3), [1], 1)]


@pytest.mark.parametrize('ft,extra', [('vggish', {}), ('raft', {'batch_size': 1}),
                                      ('resnet', {'model_name': 'resnet18',
                                                  'show_pred': True})])
def test_sanity_check_gates_packing(worklists, tmp_path, ft, extra):
    """pack_across_videos on a family without a packed loop, or with the
    per-video show_pred surface, warns and runs the per-video loop."""
    with pytest.warns(UserWarning, match='pack_across_videos'):
        args = load_config(ft, overrides=dict(
            video_paths=worklists['resnet'][0], device='cpu',
            pack_across_videos=True, output_path=str(tmp_path / 'o'),
            tmp_path=str(tmp_path / 't'), **extra))
    assert args['pack_across_videos'] is False
    assert set(PACKED_FEATURES) == {'i3d', 'r21d', 's3d', 'resnet', 'clip', 'timm'}


def test_cli_routes_packed(worklists, tmp_path, capsys):
    """pack_across_videos=true on the CLI runs the packed loop and writes
    the per-video loop's files."""
    from video_features_torch.cli import main
    paths = worklists['resnet']
    out = tmp_path / 'cli'
    assert main(['feature_type=resnet', 'model_name=resnet18', 'device=cpu',
                 f'video_paths=[{",".join(paths)}]', 'pack_across_videos=true',
                 'batch_size=4', 'allow_random_weights=true',
                 'on_extraction=save_numpy', f'output_path={out}',
                 f'tmp_path={tmp_path / "tmp"}']) == 0
    assert 'Packing device batches across 3 videos' in capsys.readouterr().out
    for p in paths:
        feats = np.load(make_path(str(out / 'resnet' / 'resnet18'), p, 'resnet', '.npy'))
        assert feats.shape[1] == 512
