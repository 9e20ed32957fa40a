"""The port's retiming (video_features_torch/io/video.py, io/native.py,
io/reencode_cli.py): the reference's order of backends (the ffmpeg
binary, else the native re-encoder in a subprocess, else index
resampling), each failure falling back to index resampling, against the
JAX package's VideoLoader, on the CPU."""
import os
import stat

import numpy as np
import pytest

from tools.make_sample_video import write_noise_clip
from video_features_tpu.io.video import VideoLoader as JaxVideoLoader
from video_features_torch.config import load_config
from video_features_torch.io import native, video
from video_features_torch.registry import create_extractor


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    return write_noise_clip(tmp_path_factory.mktemp('video') / 'clip.mp4', 14,
                            seed=11)


def frames_of(loader):
    return [f for batch, _, _ in loader for f in batch]


def needs_native():
    if not native.available():
        pytest.skip('the native re-encoder does not build here (no libav)')


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(video, 'which_ffmpeg', lambda: '')


def test_native_reencode_matches_the_jax_loader(clip, tmp_path, no_ffmpeg):
    """No ffmpeg binary: both packages re-encode with the native
    re-encoder in a fresh process and decode the same frames; the temp
    file goes on close."""
    needs_native()
    with video.VideoLoader(clip, batch_size=4, fps=10, tmp_path=tmp_path) as loader:
        assert loader.path != clip and loader.path.startswith(str(tmp_path))
        got, fps = frames_of(loader), loader.fps
    assert not os.path.exists(loader.path)
    ref_loader = JaxVideoLoader(clip, batch_size=4, fps=10,
                                tmp_path=str(tmp_path / 'jax'), backend='cv2')
    ref = [f for batch, _, _ in ref_loader for f in batch]
    ref_loader.close()
    assert fps == ref_loader.fps == 10.0
    assert len(got) == len(ref) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_keep_tmp_keeps_the_reencode(clip, tmp_path, no_ffmpeg):
    needs_native()
    with video.VideoLoader(clip, fps=10, tmp_path=tmp_path, keep_tmp=True) as loader:
        pass
    assert os.path.isfile(loader.path)


def test_index_resampling_without_a_reencoder(clip, tmp_path, monkeypatch, no_ffmpeg):
    """Neither backend: ffmpeg's fps filter emulated by picking frames,
    the JAX package's index path exactly."""
    monkeypatch.setattr(native, 'available', lambda: False)
    loader = video.VideoLoader(clip, batch_size=4, fps=10, tmp_path=tmp_path)
    assert loader.path == clip and loader.fps == 10
    ref = JaxVideoLoader(clip, batch_size=4, fps=10, use_ffmpeg=False, backend='cv2')
    got, want = frames_of(loader), [f for b, _, _ in ref for f in b]
    assert len(got) == len(want) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not any(tmp_path.iterdir())


def _fake_ffmpeg(path, body):
    path.write_text('#!/bin/sh\n' + body + '\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_ffmpeg_comes_first(clip, tmp_path, monkeypatch):
    """With an ffmpeg binary the native re-encoder is not asked: the
    loader reads what ffmpeg wrote (here a copy of the input)."""
    ffmpeg = _fake_ffmpeg(tmp_path / 'ffmpeg', 'cp "$6" "$9"')
    monkeypatch.setattr(video, 'which_ffmpeg', lambda: ffmpeg)

    def refuse(*args):
        raise AssertionError('the native re-encoder ran before ffmpeg')
    monkeypatch.setattr(native, 'reencode_fps_native', refuse)
    with video.VideoLoader(clip, fps=10, tmp_path=tmp_path / 'tmp') as loader:
        assert loader.path.endswith('_new_fps.mp4') and loader._index_map is None
        assert loader.fps == 25.0           # the copy keeps the source's rate
        assert len(frames_of(loader)) == 14


@pytest.mark.parametrize('backend', ['ffmpeg', 'native'])
def test_failed_reencode_falls_back_to_index_resampling(clip, tmp_path, monkeypatch,
                                                        capsys, backend):
    if backend == 'ffmpeg':
        ffmpeg = _fake_ffmpeg(tmp_path / 'ffmpeg', 'exit 1')
        monkeypatch.setattr(video, 'which_ffmpeg', lambda: ffmpeg)
    else:
        monkeypatch.setattr(video, 'which_ffmpeg', lambda: '')
        monkeypatch.setattr(native, 'available', lambda: True)

        def fail(*args):
            raise RuntimeError('native re-encode failed: unsupported input')
        monkeypatch.setattr(native, 'reencode_fps_native', fail)
    loader = video.VideoLoader(clip, fps=10, tmp_path=tmp_path / 'tmp')
    assert f'WARNING: {backend} fps re-encode' in capsys.readouterr().err
    assert loader.path == clip and loader.fps == 10
    assert loader._index_map.tolist() == video.resample_frame_indices(14, 25.0, 10).tolist()


@pytest.mark.parametrize('ft,overrides', [
    ('i3d', {'stack_size': 10, 'step_size': 10, 'raft_iters': 1}),
    ('raft', {'raft_iters': 1}),
    ('r21d', {}),
    ('s3d', {}),
    ('resnet', {'model_name': 'resnet18'}),
    ('clip', {}),
])
def test_extractors_pass_tmp_path_through(clip, tmp_path, monkeypatch, ft, overrides):
    """Every family's extract() decodes through a loader that re-encodes
    into the run's tmp_path/<family>[/<model>] and honours keep_tmp_files."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(self, path, **kwargs):
        seen.update(kwargs)
        raise Stop
    monkeypatch.setattr(video.VideoLoader, '__init__', spy)
    args = load_config(ft, overrides={
        'video_paths': clip, 'device': 'cpu', 'allow_random_weights': True,
        'output_path': str(tmp_path / 'out'), 'tmp_path': str(tmp_path / 'tmp'),
        'keep_tmp_files': True, 'extraction_fps': 10, **overrides})
    with pytest.raises(Stop):
        create_extractor(args).extract(clip)
    assert seen['tmp_path'] == args['tmp_path']
    assert seen['tmp_path'].startswith(str(tmp_path / 'tmp' / ft))
    assert seen['keep_tmp'] is True and seen['fps'] == 10
