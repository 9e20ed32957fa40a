"""The port's VGGish family (video_features_torch/ops/audio.py,
io/audio.py, models/vggish.py, extract/vggish.py and the CLI around
them) against the JAX package's, on the CPU, with inputs made from a
seed with numpy."""
import os
import wave

import numpy as np
import pytest
import torch

import jax

from tools.make_sample_video import write_tone
from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.io.audio import read_wav as jax_read_wav
from video_features_tpu.models import vggish as jax_vggish
from video_features_tpu.ops.audio import waveform_to_examples as jax_examples
from video_features_tpu.registry import create_extractor as jax_create_extractor
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.config import knob_exclude, load_config
from video_features_torch.extract import vggish as extract
from video_features_torch.io import native, video
from video_features_torch.io.audio import read_wav
from video_features_torch.models import vggish
from video_features_torch.ops.audio import waveform_to_examples
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import flatten, params_from_jax

REL_L2 = 1e-5       # float32 through six convs and three linears
HALF_TOL = 1e-5     # a pre-round value this close to a half may round either way


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution sums in another order per
    thread; one thread holds 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_wav(path, samples, sr, width=2):
    """PCM samples (T,) or (T, C) of integer type for ``width`` bytes."""
    samples = np.asarray(samples)
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(1 if samples.ndim == 1 else samples.shape[1])
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(samples.tobytes())
    return str(path)


def seeded_pcm(seed, seconds, sr, channels=1):
    """int16 noise plus two tones, (T,) or (T, C)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t)
    x = tone[:, None] + 0.1 * rng.randn(len(t), channels)
    x = (np.clip(x, -1, 1) * 32767).astype('<i2')
    return x[:, 0] if channels == 1 else x


def write_pca(path, seed):
    """A seeded stand-in for vggish_pca_params.npz, in its layout:
    eigen vectors (128, 128), means (128, 1)."""
    rng = np.random.RandomState(seed)
    np.savez(path, pca_eigen_vectors=rng.randn(128, 128) * 0.3,
             pca_means=rng.rand(128, 1) * 0.5)
    return str(path)


# ---------------------------------------------------------------- DSP --

@pytest.mark.parametrize('channels', [1, 2])
@pytest.mark.parametrize('sr', [16000, 8000, 22050, 44100, 48000])
def test_examples_equal_the_jax_dsp(sr, channels):
    """Mono-mean, resampy's kaiser_best to 16 kHz, log-mel, 96×64 every
    0.96 s: bit-equal to the JAX package's copy."""
    data = seeded_pcm(sr + channels, 2.1, sr, channels).astype(np.float64) / 32768
    got, ref = waveform_to_examples(data, sr), jax_examples(data, sr)
    assert got.shape == ref.shape == (2, 96, 64) and got.dtype == np.float32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('width,dtype', [(1, np.uint8), (2, '<i2'), (4, '<i4')])
@pytest.mark.parametrize('channels', [1, 2])
def test_read_wav_widths(tmp_path, width, dtype, channels):
    rng = np.random.RandomState(width * 10 + channels)
    info = np.iinfo(np.dtype(dtype))
    pcm = rng.randint(info.min, info.max, size=(300, channels)).astype(dtype)
    path = write_wav(tmp_path / 'w.wav', pcm[:, 0] if channels == 1 else pcm,
                     11025, width)
    (got, sr), (ref, ref_sr) = read_wav(path), jax_read_wav(path)
    assert sr == ref_sr == 11025
    assert got.shape == ref.shape == ((300,) if channels == 1 else (300, channels))
    assert got.dtype == np.float64 and np.array_equal(got, ref)
    assert -1 <= got.min() and got.max() < 1


def test_read_wav_refuses_24_bit(tmp_path):
    path = write_wav(tmp_path / 'w.wav', np.zeros(30, np.uint8), 16000, 3)
    with pytest.raises(NotImplementedError, match='sample width: 3'):
        read_wav(path)


# -------------------------------------------------------------- model --

@pytest.fixture(scope='module')
def nets():
    """(JAX params, port VGGish) from one seeded state_dict, which both
    packages' init_state_dict produce alike; the port's weights come
    through the JAX tree by ``params_from_jax``."""
    sd = jax_vggish.init_state_dict(seed=3)
    mine = vggish.init_state_dict(seed=3)
    assert sd.keys() == mine.keys()
    assert all(np.array_equal(sd[k], mine[k]) for k in sd)
    jp = transplant(sd)
    return jp, vggish.build(flatten(params_from_jax(jp)), 'cpu')


def log_mel_batch(seed, n):
    """(n, 96, 64) float32 in the log-mel range (log(0.01) .. ~3)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 96, 64) * 7 - 4.6).astype(np.float32)


def test_forward_matches_jax(nets):
    jp, model = nets
    x = log_mel_batch(0, 3)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax.jit(jax_vggish.forward)(jp, x[..., None]))
    with torch.inference_mode():
        got = model(torch.from_numpy(x[:, None])).numpy()
    assert got.shape == ref.shape == (3, 128)
    assert (got >= 0).all() and (got > 0).any()    # a ReLU after the last linear
    assert rel_l2(got, ref) <= REL_L2
    # the trap: flattening the (B, 512, 6, 4) map channels-first has the
    # same width and passes every shape check, but misses the bar
    with torch.inference_mode():
        wrong = model.embeddings(model.features(torch.from_numpy(x[:, None]))
                                 .flatten(1)).numpy()
    assert wrong.shape == ref.shape and rel_l2(wrong, ref) > 100 * REL_L2


def test_state_dict_names_are_torchvggish(nets):
    _, model = nets
    names = set(model.state_dict())
    assert names == {f'{part}.{i}.{leaf}'
                     for part, idx in (('features', (0, 3, 6, 8, 11, 13)),
                                       ('embeddings', (0, 2, 4)))
                     for i in idx for leaf in ('weight', 'bias')}
    assert model.embeddings[0].weight.shape == (4096, 12288)
    with pytest.raises(RuntimeError, match='Unexpected key'):
        vggish.build(dict(model.state_dict(), extra=torch.zeros(1)), 'cpu')


def test_postprocess_matches_jax(nets, tmp_path):
    """uint8 equal to the JAX package's, or 1 level apart only where the
    value before rounding lies within HALF_TOL of a half (a float32 sum
    order there decides the rounding)."""
    rng = np.random.RandomState(5)
    emb = (rng.rand(64, 128) * 2.4).astype(np.float32)
    with np.load(write_pca(tmp_path / 'pca.npz', 6)) as pca:
        eig = pca['pca_eigen_vectors'].astype(np.float32)
        means = pca['pca_means'].astype(np.float32).reshape(-1)
    ref = np.asarray(jax_vggish.postprocess(eig, means, emb)).astype(np.uint8)
    got = vggish.postprocess(torch.from_numpy(eig), torch.from_numpy(means),
                             torch.from_numpy(emb)).numpy().astype(np.uint8)
    exact = (np.clip((emb.astype(np.float64) - means) @ eig.T.astype(np.float64),
                     -2, 2) + 2) * (255 / 4)
    near_half = np.abs(exact - np.floor(exact) - 0.5) < HALF_TOL
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and not (diff[~near_half] > 0).any()
    assert 0 < (got == 0).mean() < 0.5 and 0 < (got == 255).mean() < 0.5


def test_postprocess_rounds_half_to_even():
    """Exact halves round to even, as jnp.round does: an identity PCA
    over the range 0..255 (scale 1) feeds them in unchanged."""
    values = np.array([[0.5, 1.5], [2.5, 254.5]], np.float32)
    eye = np.eye(2, dtype=np.float32)
    got = vggish.postprocess(torch.from_numpy(eye), torch.zeros(2),
                             torch.from_numpy(values), 0.0, 255.0).numpy()
    ref = np.asarray(jax_vggish.postprocess(eye, np.zeros(2, np.float32),
                                            values, 0.0, 255.0))
    assert got.tolist() == ref.tolist() == [[0, 2], [2, 254]]


# ---------------------------------------------------------- extractor --

def port_args(tmp_path, **extra):
    return {'feature_type': 'vggish', 'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'out'),
            'tmp_path': str(tmp_path / 'tmp'), **extra}


@pytest.fixture(scope='module')
def extractors(tmp_path_factory):
    """The port's and the JAX package's extractors at the config's batch
    32 on the same seeded weights (init_state_dict(0), both sides)."""
    tmp = tmp_path_factory.mktemp('vggish')
    dummy = tone_wav(tmp / 'dummy.wav', 1.0)
    ours = create_extractor(load_config('vggish', port_args(
        tmp, video_paths=dummy, audio_backend='native')))
    theirs = jax_create_extractor(jax_load_config('vggish', overrides={
        'video_paths': dummy, 'device': 'cpu', 'audio_backend': 'native',
        'output_path': str(tmp / 'jax_out'), 'tmp_path': str(tmp / 'jax_tmp')}))
    return ours, theirs


def tone_wav(path, seconds, sr=16000):
    write_tone(path, seconds=seconds, sr=sr)
    return str(path)


@pytest.mark.parametrize('seconds,examples', [(0.5, 0), (1.0, 1), (32.0, 33)])
def test_extract_matches_jax_on_tones(extractors, tmp_path, seconds, examples):
    """0 examples (no device call), 1, and 33 (a last batch of 1 padded
    to 32 by repeating it; only the valid rows come back)."""
    ours, theirs = extractors
    path = tone_wav(tmp_path / 'tone.wav', seconds)
    got, ref = ours.extract(path)['vggish'], theirs.extract(path)['vggish']
    assert got.shape == ref.shape == (examples, 128) and got.dtype == np.float32
    if examples:
        assert rel_l2(got, ref) <= REL_L2


def test_extract_matches_jax_at_44k_stereo(extractors, tmp_path):
    ours, theirs = extractors
    path = write_wav(tmp_path / 's.wav', seeded_pcm(7, 3.0, 44100, 2), 44100)
    got, ref = ours.extract(path)['vggish'], theirs.extract(path)['vggish']
    assert got.shape == ref.shape == (3, 128)
    assert rel_l2(got, ref) <= REL_L2


def test_padded_batch_rows_equal_unpadded(extractors, tmp_path):
    """Each example's row depends on that example only: the 33-example
    clip's rows at batch 32 equal those at batch 11 (three full steps)."""
    ours, _ = extractors
    path = write_wav(tmp_path / 'n.wav', seeded_pcm(8, 32.0, 16000), 16000)
    full = ours.extract(path)['vggish']
    ours.batch_size = 11
    try:
        again = ours.extract(path)['vggish']
    finally:
        ours.batch_size = 32
    assert full.shape == (33, 128) and rel_l2(again, full) <= REL_L2


def test_mp4_branch_with_the_native_backend(extractors, tmp_path):
    """audio_backend=native on both sides, on a wav written under an .mp4
    name: libav probes by content, so it goes down the real .mp4 path
    (read_audio_native to mono 16 kHz, no temp files)."""
    if not native.available():
        pytest.skip('the native decode library does not build here (no libav)')
    ours, theirs = extractors
    path = write_wav(tmp_path / 'clip.mp4', seeded_pcm(9, 2.5, 22050, 2), 22050)
    got, ref = ours.extract(path)['vggish'], theirs.extract(path)['vggish']
    assert got.shape == ref.shape == (2, 128)
    assert rel_l2(got, ref) <= REL_L2
    assert not (tmp_path / 'tmp').exists()


# ------------------------------------------------------------ refusals --

@pytest.fixture(scope='module')
def wav(tmp_path_factory):
    return tone_wav(tmp_path_factory.mktemp('wav') / 'a.wav', 1.0)


def test_show_pred_warns_then_raises(wav, tmp_path):
    with pytest.warns(UserWarning, match='not implemented for VGGish'):
        args = load_config('vggish', port_args(tmp_path, video_paths=wav,
                                               show_pred=True))
    with pytest.raises(NotImplementedError, match='show_pred'):
        create_extractor(args)


@pytest.mark.parametrize('key,value,match', [
    ('audio_backend', 'sox', 'audio_backend must be one of'),
    ('post_process', True, 'pca_params_path'),
    ('aot_enabled', True, 'aot_enabled'),
    ('compute_dtype', 'int8', 'compute_dtype'),
])
def test_bad_keys_raise_before_the_weights_load(wav, tmp_path, monkeypatch,
                                                key, value, match):
    def refuse(*args, **kwargs):
        raise AssertionError('weights loaded before the config was refused')
    monkeypatch.setattr(extract.ExtractVGGish, 'load_params', refuse)
    args = port_args(tmp_path, video_paths=wav, **{key: value})
    with pytest.raises((ValueError, NotImplementedError), match=match):
        load_config('vggish', args)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        extract.ExtractVGGish(args)


def test_unknown_extension_raises(extractors, tmp_path):
    ours, _ = extractors
    path = tmp_path / 'a.flac'
    path.write_bytes(b'fLaC')
    with pytest.raises(NotImplementedError, match='.flac'):
        ours.extract(str(path))


def test_native_without_the_library_raises(extractors, tmp_path, monkeypatch):
    """audio_backend=native never falls back to ffmpeg, and auto with
    neither backend names both."""
    ours, _ = extractors
    path = write_wav(tmp_path / 'clip.mp4', seeded_pcm(1, 1.0, 16000), 16000)
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(video, 'which_ffmpeg', lambda: '/usr/bin/ffmpeg')
    with pytest.raises(RuntimeError, match='audio_backend=native'):
        ours.extract(path)
    monkeypatch.setattr(video, 'which_ffmpeg', lambda: '')
    monkeypatch.setattr(ours, 'audio_backend', 'auto')
    with pytest.raises(RuntimeError, match='audio_backend=ffmpeg.*audio_backend=native'):
        ours.extract(path)


def test_ffmpeg_temp_files_go_on_error(extractors, tmp_path, monkeypatch):
    """The ffmpeg branch's .aac and .wav are removed when reading the wav
    fails, unless keep_tmp_files."""
    ours, _ = extractors
    made = [str(tmp_path / 'x.wav'), str(tmp_path / 'x.aac')]

    def fake_chain(video_path, tmp):
        for p in made:
            open(p, 'wb').write(b'not a wav')
        return tuple(made)
    monkeypatch.setattr('video_features_torch.io.audio.extract_wav_from_mp4',
                        fake_chain)
    monkeypatch.setattr(ours, 'audio_backend', 'ffmpeg')
    with pytest.raises(wave.Error):
        ours.extract(str(tmp_path / 'x.mp4'))
    assert not any(map(os.path.exists, made))
    monkeypatch.setattr(ours, 'keep_tmp_files', True)
    with pytest.raises(wave.Error):
        ours.extract(str(tmp_path / 'x.mp4'))
    assert all(map(os.path.exists, made))


def test_no_gpu_without_device_cpu_is_an_error(wav, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        load_config('vggish', {'video_paths': wav, 'output_path': str(tmp_path)})
    with pytest.raises(RuntimeError, match='device=cpu'):
        extract.ExtractVGGish(port_args(tmp_path, device='cuda'))


# ---------------------------------------------------- resume and CLI --

def test_pca_file_rewritten_in_place_re_extracts(wav, tmp_path):
    assert not {'audio_backend', 'post_process', 'pca_params_path'} & \
        knob_exclude('fingerprint')
    pca = write_pca(tmp_path / 'pca.npz', 1)
    args = port_args(tmp_path, post_process=True, pca_params_path=pca)
    first = extract.ExtractVGGish(args)
    first._extract(wav)
    saved = tmp_path / 'out' / 'a_vggish.npy'
    old = np.load(saved)
    assert old.dtype == np.uint8 and first.is_already_exist(wav)
    write_pca(tmp_path / 'pca.npz', 2)
    second = extract.ExtractVGGish(args)
    with pytest.warns(UserWarning, match='different config/checkpoint'):
        assert not second.is_already_exist(wav)
    second._extract(wav)
    assert not np.array_equal(np.load(saved), old)


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on a seeded 44.1 kHz stereo wav: vggish/<stem>_vggish.npy
    (Ta, 128) float32 within 1e-5, and with post_process and a seeded PCA
    file uint8 within 1 level."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    path = write_wav(tmp_path / 'st.wav', seeded_pcm(11, 4.0, 44100, 2), 44100)
    pca = write_pca(tmp_path / 'pca.npz', 12)
    common = [f'video_paths={path}', 'device=cpu', 'allow_random_weights=true',
              'on_extraction=save_numpy']
    for post in ('false', 'true'):
        extra = [f'post_process={post}', f'pca_params_path={pca}']
        for side, main in (('jax', jax_main), ('torch', torch_main)):
            assert main(['feature_type=vggish', *common, *extra,
                         f'output_path={tmp_path / side / post}',
                         f'tmp_path={tmp_path / side / "tmp"}']) == 0
        ref, got = (np.load(tmp_path / side / post / 'vggish' / 'st_vggish.npy')
                    for side in ('jax', 'torch'))
        assert got.shape == ref.shape == (4, 128)
        if post == 'false':
            assert got.dtype == np.float32 and rel_l2(got, ref) <= REL_L2
        else:
            assert got.dtype == ref.dtype == np.uint8
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
