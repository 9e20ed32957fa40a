"""The port's in-process libav decoders (video_features_torch/io/native.py)
and the decode backends of its VideoLoader (io/video.py) against the JAX
package's, on the CPU. Tests that decode natively skip only where the
library cannot build or load (no g++ or libav)."""
import wave

import cv2
import numpy as np
import pytest
import torch

from tests.test_native_decode import _insert_colr_bt709
from tools.make_sample_video import write_noise_clip
from video_features_tpu.io import native as jax_native
from video_features_tpu.io.video import VideoLoader as JaxVideoLoader
from video_features_torch.io import native, video

REL_L2 = 1e-5


@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip('the native decode library does not build here (no libav)')


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def write_gradient_clip(path, frames=6, w=64, h=48):
    """A smooth mp4v gradient, as tests/test_native_decode.py makes for
    its BT.709 case."""
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), 25, (w, h))
    gx = np.linspace(0, 255, w)[None, :]
    gy = np.linspace(0, 255, h)[:, None]
    for t in range(frames):
        wr.write(np.stack([np.broadcast_to(gx, (h, w)), np.broadcast_to(gy, (h, w)),
                           np.full((h, w), 40 * t)], -1).astype(np.uint8))
    wr.release()
    return str(path)


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """{name: path}: a noise clip, an odd-width one (swscale's SIMD tail),
    a smooth gradient and the same gradient tagged BT.709 (which the
    native decoder converts through swscale, not the cv2-fitted tables)."""
    tmp = tmp_path_factory.mktemp('native')
    out = {'noise': write_noise_clip(tmp / 'noise.mp4', 40, seed=4),
           'odd': write_noise_clip(tmp / 'odd.mp4', 9, w=90, h=50, seed=5),
           'gradient': write_gradient_clip(tmp / 'grad.mp4')}
    out['bt709'] = str(tmp / 'grad709.mp4')
    _insert_colr_bt709(out['gradient'], out['bt709'])
    return out


CLIPS = ('noise', 'odd', 'gradient', 'bt709')


@pytest.mark.parametrize('name', CLIPS)
def test_frames_byte_equal_to_the_jax_decoder(clips, needs_native, name):
    path = clips[name]
    dec = native.NativeFrameDecoder(path).open()
    ref_dec = jax_native.NativeFrameDecoder(path).open()
    assert (dec.fps, dec.num_frames, dec.width, dec.height, dec.rotation) == (
        ref_dec.fps, ref_dec.num_frames, ref_dec.width, ref_dec.height,
        ref_dec.rotation)
    got = [(i, f.copy()) for i, f in dec]       # CHUNK = 32: noise spans two reads
    ref = [(i, f.copy()) for i, f in ref_dec]
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(len(ref)))
    assert len(got) == dec.num_frames > 0
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref))
    assert native.get_video_props_native(path) == jax_native.get_video_props_native(path)


def test_open_errors(needs_native, tmp_path):
    with pytest.raises(IOError):
        native.NativeFrameDecoder(str(tmp_path / 'missing.mp4')).open()
    assert native.get_video_props_native(str(tmp_path / 'missing.mp4')) is None


def _write_wav(path, sr, channels, seconds, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 523 * t)[:, None] + 0.05 * rng.randn(len(t), channels)
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((x * 32767).astype('<i2').tobytes())
    return str(path)


@pytest.mark.parametrize('sr,channels,target,suffix', [
    (44100, 2, 16000, '.wav'), (16000, 1, 16000, '.wav'),
    (48000, 1, 0, '.wav'), (22050, 2, 16000, '.mp4')])
def test_audio_byte_equal_to_the_jax_reader(needs_native, tmp_path, sr, channels,
                                            target, suffix):
    """Mono float32 at ``target`` (0 keeps the source's rate); a wav under
    an .mp4 name opens too, since libav probes by content."""
    path = _write_wav(tmp_path / f'a{suffix}', sr, channels, 1.5, sr + channels)
    (got, rate), (ref, ref_rate) = (native.read_audio_native(path, target),
                                    jax_native.read_audio_native(path, target))
    assert rate == ref_rate == (target or sr)
    assert got.dtype == np.float32 and got.ndim == 1
    assert abs(len(got) - 1.5 * rate) < 50
    assert np.array_equal(got, ref)


def test_audio_without_a_track_raises(needs_native, tmp_path):
    bad = tmp_path / 'not_media.mp4'
    bad.write_bytes(b'\x00' * 128)
    with pytest.raises(IOError):
        native.read_audio_native(str(bad), 16000)


def frames_of(loader):
    return [np.asarray(f) for batch, _, _ in loader for f in batch]


def jax_frames(path, **kwargs):
    loader = JaxVideoLoader(path, **kwargs)
    try:
        return frames_of(loader), loader.fps
    finally:
        loader.close()


@pytest.mark.parametrize('name', CLIPS)
@pytest.mark.parametrize('backend', ['auto', 'native', 'cv2'])
def test_loader_frames_byte_equal_per_backend(clips, needs_native, name, backend):
    """Each backend decodes the same bytes in both packages. On the
    BT.709-tagged clip cv2 and the native decoder differ by a few levels,
    so ``auto`` shows which one each package picked."""
    path = clips[name]
    with video.VideoLoader(path, batch_size=4, backend=backend) as loader:
        got, fps = frames_of(loader), loader.fps
    ref, ref_fps = jax_frames(path, batch_size=4, backend=backend)
    assert fps == ref_fps and len(got) == len(ref) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_bt709_decoders_differ(clips, needs_native):
    """The fixture that makes the test above decisive: on the tagged clip
    the native decoder and cv2 give different pixels."""
    nat = frames_of(video.VideoLoader(clips['bt709'], batch_size=4, backend='native'))
    cv = frames_of(video.VideoLoader(clips['bt709'], batch_size=4, backend='cv2'))
    assert max(np.abs(a.astype(int) - b).max() for a, b in zip(nat, cv)) > 0


def test_auto_without_the_library_is_cv2_in_both(clips, monkeypatch):
    """A host where the library does not load: auto decodes with cv2 in
    both packages, and native raises naming decode_backend."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, 'available', lambda: False)
    path = clips['bt709']
    got = frames_of(video.VideoLoader(path, batch_size=4))
    ref, _ = jax_frames(path, batch_size=4, backend='cv2')
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(RuntimeError, match='decode_backend=native'):
        video.VideoLoader(path, backend='native')


def test_auto_falls_back_to_cv2_per_file(clips, needs_native, monkeypatch):
    """auto takes cv2 for a file the native decoder cannot open, as the
    JAX package does; native raises instead."""
    def refuse(self):
        raise IOError('vfdecode: no demuxer')
    monkeypatch.setattr(native.NativeFrameDecoder, 'open', refuse)
    path = clips['bt709']
    got = frames_of(video.VideoLoader(path, batch_size=4, backend='auto'))
    ref, _ = jax_frames(path, batch_size=4, backend='cv2')
    assert len(got) == len(ref) and all(np.array_equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(IOError, match='no demuxer'):
        frames_of(video.VideoLoader(path, batch_size=4, backend='native'))


def test_unknown_backend_is_a_value_error(clips):
    with pytest.raises(ValueError, match='decode_backend must be one of'):
        video.VideoLoader(clips['noise'], backend='ffmpeg')


def test_retimed_native_decode_matches_jax(clips, needs_native, tmp_path, monkeypatch):
    """Index resampling (no re-encoder) over the native decoder, both
    packages: the same frames picked and decoded."""
    monkeypatch.setattr(video, 'which_ffmpeg', lambda: '')
    monkeypatch.setattr(native, 'reencode_fps_native', _no_reencode)
    with video.VideoLoader(clips['noise'], batch_size=4, fps=10,
                           tmp_path=tmp_path, backend='native') as loader:
        got, fps = frames_of(loader), loader.fps
    ref, ref_fps = jax_frames(clips['noise'], batch_size=4, fps=10,
                              use_ffmpeg=False, backend='native')
    assert fps == ref_fps == 10 and len(got) == len(ref) == 16
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def _no_reencode(*args):
    raise RuntimeError('native re-encode failed: refused by the test')


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_r21d_cli_with_native_decode_matches_jax(clips, needs_native, tmp_path,
                                                 one_thread):
    """Both CLIs with decode_backend=native on the BT.709-tagged clip
    stretched to 17 frames: r21d features within 1e-5."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    src = write_gradient_clip(tmp_path / 'g.mp4', frames=17, w=80, h=60)
    clip = str(tmp_path / 'g709.mp4')
    _insert_colr_bt709(src, clip)
    common = [f'video_paths={clip}', 'device=cpu', 'allow_random_weights=true',
              'batch_size=1', 'on_extraction=save_numpy', 'decode_backend=native']
    for side, main in (('jax', jax_main), ('torch', torch_main)):
        assert main(['feature_type=r21d', *common, f'output_path={tmp_path / side}',
                     f'tmp_path={tmp_path / "tmp" / side}']) == 0
    sub = ('r21d', 'r2plus1d_18_16_kinetics', 'g709_r21d.npy')
    ref, got = (np.load(tmp_path.joinpath(side, *sub)) for side in ('jax', 'torch'))
    assert got.shape == ref.shape == (1, 512)
    assert rel_l2(got, ref) <= REL_L2
