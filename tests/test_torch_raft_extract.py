"""The port's RAFT family slice (video_features_torch/extract/raft.py, the
overlap batching of io/video.py, utils/flow_viz.py and the CLI around
them) against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

import jax

from tools.make_sample_video import write_noise_clip
from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.io import video as jax_video
from video_features_tpu.registry import create_extractor as jax_create
from video_features_tpu.utils import flow_viz as jax_flow_viz
from video_features_torch.config import load_config
from video_features_torch.extract import raft as extract
from video_features_torch.io import video
from video_features_torch.utils import flow_viz

REL_L2 = 1e-3   # the BASELINE feature bar
FPS = 25.0


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _args(tmp_path, **overrides):
    args = {'feature_type': 'raft', 'batch_size': 2, 'raft_iters': 2,
            'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(tmp_path)}
    args.update(overrides)
    return args


def _frames(n=7, h=60, w=85, seed=0):
    return list(np.random.RandomState(seed).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8))


@pytest.fixture(scope='module')
def jax_extractor(tmp_path_factory):
    """One JAX ExtractRAFT (batch 2, 2 iterations) whose cv2 decoder is
    swapped for a fake that yields ``frames`` (set per test)."""
    tmp = tmp_path_factory.mktemp('jax_raft')
    fake = tmp / 'frames.mp4'
    fake.write_bytes(b'')
    args = jax_load_config('raft', overrides={
        'video_paths': str(fake), 'device': 'cpu', 'batch_size': 2,
        'raft_iters': 2, 'allow_random_weights': True,
        'decode_backend': 'cv2', 'output_path': str(tmp / 'out'),
        'tmp_path': str(tmp / 'tmp')})
    return jax_create(args), str(fake)


@pytest.fixture(scope='module')
def extractor(tmp_path_factory):
    return extract.ExtractRAFT(_args(tmp_path_factory.mktemp('torch_raft')))


class _FakeDecoder:
    frames = []

    def __init__(self, path):
        pass

    def __iter__(self):
        return iter(enumerate(self.frames))

    def release(self):
        pass


@pytest.mark.parametrize('finetuned_on,bucket', [('sintel', 8), ('kitti', 8),
                                                 ('sintel', 16)])
def test_extract_frames_matches_jax(jax_extractor, extractor, monkeypatch,
                                    finetuned_on, bucket):
    """7 frames of 60×85 (pads to 64×88, or 64×96 at bucket 16), batch 2:
    three full steps with overlap, one padded tail."""
    frames = _frames()
    jex, path = jax_extractor
    monkeypatch.setattr(_FakeDecoder, 'frames', frames)
    monkeypatch.setattr(jax_video, 'Cv2FrameDecoder', _FakeDecoder)
    monkeypatch.setattr(jax_video, 'get_video_props', lambda p: dict(
        fps=FPS, num_frames=len(frames), height=60, width=85))
    for ex in (jex, extractor):
        monkeypatch.setattr(ex, 'finetuned_on', finetuned_on)
        monkeypatch.setattr(ex, 'bucket_multiple', bucket)
    with jax.default_matmul_precision('highest'):
        ref = jex.extract(path)
    got = extractor.extract_frames(
        video.batch_frames(iter(frames), 3, FPS, overlap=1), FPS,
        frame_hw=(60, 85))
    assert got['raft'].shape == ref['raft'].shape == (6, 2, 60, 85)
    assert rel_l2(got['raft'], ref['raft']) <= REL_L2
    np.testing.assert_array_equal(got['timestamps_ms'], ref['timestamps_ms'])
    assert float(got['fps']) == float(ref['fps']) == FPS


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one 6-frame clip write <stem>_raft.npy (5, 2, 64, 85),
    <stem>_fps.npy and <stem>_timestamps_ms.npy."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 6, w=96, h=72, seed=3)
    common = [f'video_paths={clip}', 'device=cpu', 'raft_iters=1',
              'allow_random_weights=true', 'side_size=64',
              'on_extraction=save_numpy']
    assert jax_main(['feature_type=raft', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "tmp"}']) == 0
    assert torch_main(['feature_type=raft', *common,
                       f'output_path={tmp_path / "torch"}']) == 0
    ref = {k: np.load(tmp_path / 'jax' / 'raft' / f'clip_{k}.npy')
           for k in ('raft', 'fps', 'timestamps_ms')}
    got = {k: np.load(tmp_path / 'torch' / 'raft' / f'clip_{k}.npy')
           for k in ('raft', 'fps', 'timestamps_ms')}
    assert got['raft'].shape == ref['raft'].shape == (5, 2, 64, 85)
    assert rel_l2(got['raft'], ref['raft']) <= REL_L2
    np.testing.assert_array_equal(got['fps'], ref['fps'])
    np.testing.assert_array_equal(got['timestamps_ms'], ref['timestamps_ms'])


@pytest.mark.parametrize('n_frames,total', [(9, None), (10, None), (10, 5)])
def test_overlap_batching_matches_jax_loader(tmp_path, n_frames, total):
    """batch 5, overlap 1: 9 frames give two batches (the cached frame
    alone is not a batch), 10 frames a short third; ``total`` retimes,
    through the same backend on both sides (the JAX loader's default
    order)."""
    clip = write_noise_clip(tmp_path / 'v.mp4', n_frames, seed=1)
    with jax_video.VideoLoader(clip, batch_size=5, total=total, overlap=1,
                               backend='cv2', tmp_path=tmp_path / 'jax') as loader:
        ref = list(loader)
    with video.VideoLoader(clip, batch_size=5, total=total, overlap=1,
                           tmp_path=tmp_path / 'torch') as loader:
        got = list(loader)
    assert len(got) == len(ref)
    for (gf, gt, gi), (rf, rt, ri) in zip(got, ref):
        np.testing.assert_array_equal(np.stack(gf), rf)
        assert gt == rt and gi == ri


def test_batch_frames_transforms_each_frame_once():
    seen = []

    def transform(f):
        seen.append(int(f))
        return f * 10
    batches = list(video.batch_frames(iter(range(7)), 3, 1.0, overlap=1,
                                      transform=transform))
    assert [b for b, _, _ in batches] == [[0, 10, 20], [20, 30, 40],
                                          [40, 50, 60]]
    assert [i for _, _, i in batches] == [[0, 1, 2], [2, 3, 4], [4, 5, 6]]
    assert seen == list(range(7))
    with pytest.raises(ValueError, match='overlap'):
        list(video.batch_frames(iter(range(3)), 2, 1.0, overlap=2))


def test_flow_to_image_matches_jax_copy():
    flow = np.random.RandomState(0).randn(16, 24, 2).astype(np.float32) * 3
    for bgr in (False, True):
        np.testing.assert_array_equal(
            flow_viz.flow_to_image(flow, convert_to_bgr=bgr),
            jax_flow_viz.flow_to_image(flow, convert_to_bgr=bgr))
    np.testing.assert_array_equal(flow_viz.make_colorwheel(),
                                  jax_flow_viz.make_colorwheel())


def test_show_pred_writes_png(tmp_path):
    ex = extract.ExtractRAFT(_args(tmp_path, raft_iters=1, show_pred=True))
    frames = _frames(3, 64, 64)
    out = ex.extract_frames(video.batch_frames(iter(frames), 3, FPS, overlap=1),
                            FPS)
    assert out['raft'].shape == (2, 2, 64, 64)
    assert len(list((tmp_path / 'flow_debug').glob('*.png'))) == 1


def test_empty_and_single_frame_videos(extractor, monkeypatch):
    """No pairs: a (0, 2, H, W) flow in the geometry after the host
    resize; a lone frame still has its timestamp."""
    out = extractor.extract_frames([], FPS, frame_hw=(60, 85))
    assert out['raft'].shape == (0, 2, 60, 85)
    monkeypatch.setattr(extractor, 'side_size', 30)
    out = extractor.extract_frames(
        video.batch_frames(iter(_frames(1)), 3, FPS, overlap=1), FPS,
        frame_hw=(60, 85))
    assert out['raft'].shape == (0, 2, 30, 42)
    np.testing.assert_array_equal(out['timestamps_ms'], [0.0])


def test_config_defaults_and_checks(tmp_path):
    clip = write_noise_clip(tmp_path / 'v.mp4', 3)
    base = {'video_paths': clip, 'device': 'cpu', 'output_path': str(tmp_path)}
    args = load_config('raft', overrides=base)
    assert (args['batch_size'], args['finetuned_on'], args['bucket_multiple'],
            args['raft_iters'], args['device']) == (1, 'sintel', 8, None, 'cpu')
    assert args['output_path'] == str(tmp_path / 'raft')
    assert args['on_extraction'] == 'save_numpy'     # writes the three files
    for key, value, err in (('finetuned_on', 'chairs', ValueError),
                            ('bucket_multiple', 12, ValueError),
                            ('batch_size', None, ValueError),
                            ('raft_iters', 0, ValueError),
                            ('extraction_total', 5, None),
                            ('aot_enabled', True, NotImplementedError),
                            ('decode_backend', 'gpu', ValueError),
                            ('decode_workers', 0, ValueError)):
        overrides = dict(base, **{key: value})
        if err is None:          # with extraction_fps: mutually exclusive
            overrides['extraction_fps'] = 10
            err = ValueError
        with pytest.raises(err, match=key):
            load_config('raft', overrides=overrides)


def test_no_gpu_without_device_cpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    clip = write_noise_clip(tmp_path / 'v.mp4', 3)
    with pytest.raises(RuntimeError, match='device=cpu'):
        load_config('raft', overrides={'video_paths': clip})
    with pytest.raises(RuntimeError, match='device=cpu'):
        extract.ExtractRAFT(_args(tmp_path, device='cuda'))
