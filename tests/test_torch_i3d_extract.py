"""The port's fused I3D two-stream slice (video_features_torch/extract/
i3d.py and the CLI around it) against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract import i3d as jax_extract
from video_features_tpu.models import i3d as jax_i3d
from video_features_tpu.models import raft as jax_raft
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.config import load_config
from video_features_torch.extract import i3d as extract
from video_features_torch.extract.weights import MissingCheckpointError
from video_features_torch.transplant import params_from_jax

REL_L2 = 1e-3   # the BASELINE feature bar (flow quantization cliff included)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _args(tmp_path, **overrides):
    args = {'feature_type': 'i3d', 'streams': None, 'stack_size': 10,
            'step_size': 10, 'raft_iters': 1, 'concat_rgb_flow': True,
            'batch_size': 2, 'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'out')}
    args.update(overrides)
    return args


def test_fused_step_matches_jax():
    jp = {'rgb': transplant(jax_i3d.init_state_dict(seed=0, modality='rgb')),
          'flow': transplant(jax_i3d.init_state_dict(seed=1, modality='flow')),
          'raft': transplant(jax_raft.init_state_dict(seed=2))}
    tp = {k: params_from_jax(v) for k, v in jp.items()}
    stacks = np.random.RandomState(3).randint(
        0, 256, (1, 11, 64, 88, 3)).astype(np.uint8)
    pads = (0, 0, 0, 0)
    with jax.default_matmul_precision('highest'):
        ref = jax_extract.fused_two_stream_step(
            jp, jnp.asarray(stacks), pads, ('rgb', 'flow'), crop_size=64,
            platform='cpu', raft_iters=2)
    with torch.inference_mode():
        got = extract.fused_two_stream_step(
            tp, torch.from_numpy(stacks), pads, ('rgb', 'flow'), crop_size=64,
            raft_iters=2)
    for s in ('rgb', 'flow'):
        assert got[s].shape == (1, 1024)
        assert rel_l2(got[s].numpy(), ref[s]) <= REL_L2, s


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one 17-frame clip (one window) write <stem>.npy
    (1, 2048) within the bar."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 17, seed=3)
    common = [f'video_paths={clip}', 'device=cpu', 'raft_iters=1',
              'allow_random_weights=true', 'batch_size=1']
    assert jax_main(['feature_type=i3d', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "tmp"}']) == 0
    assert torch_main(['feature_type=i3d', *common,
                       f'output_path={tmp_path / "torch"}']) == 0
    ref = np.load(tmp_path / 'jax' / 'i3d' / 'clip.npy')
    got = np.load(tmp_path / 'torch' / 'i3d' / 'clip.npy')
    assert got.shape == ref.shape == (1, 2048)
    assert rel_l2(got[:, :1024], ref[:, :1024]) <= REL_L2
    assert rel_l2(got[:, 1024:], ref[:, 1024:]) <= REL_L2


def test_extract_frames_windows_and_padded_tail(tmp_path, monkeypatch):
    """49 frames, stack 16, step 16 → 3 windows; batch 2 pads the tail
    batch and masks it off; features come back in window order."""
    ex = extract.ExtractI3D(_args(tmp_path, streams='rgb', stack_size=16,
                                  step_size=16))
    seen = []

    def step(stacks):
        seen.append(tuple(stacks.shape))
        first = stacks[:, 0, 0, 0, 0].float()
        return {'rgb': first[:, None].repeat(1, 1024)}

    monkeypatch.setattr(ex, 'packed_step', step)
    frames = np.arange(49, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 4, 5, 3), np.uint8)
    batches = [(list(frames[i:i + 16]), None, None) for i in range(0, 49, 16)]
    feats = ex.extract_frames(batches)
    assert seen == [(2, 17, 4, 5, 3)] * 2
    np.testing.assert_array_equal(feats['rgb'][:, 0], [0, 16, 32])


def test_resume_skips_existing_outputs(tmp_path, monkeypatch, capsys):
    ex = extract.ExtractI3D(_args(tmp_path, streams='rgb'))
    calls = []

    def fake_extract(path):
        calls.append(path)
        return {'rgb': np.ones((2, 1024), np.float32)}

    monkeypatch.setattr(ex, 'extract', fake_extract)
    video = str(tmp_path / 'v.mp4')
    ex._extract(video)
    assert np.load(tmp_path / 'out' / 'v.npy').shape == (2, 1024)
    ex._extract(video)
    assert calls == [video]
    assert 'already exist' in capsys.readouterr().out


def test_bad_video_path_continues(tmp_path, capsys):
    ex = extract.ExtractI3D(_args(tmp_path, streams='rgb'))
    ex._extract(str(tmp_path / 'missing.mp4'))     # must not raise
    err = capsys.readouterr().err
    assert 'continuing with the next video' in err and 'missing.mp4' in err


def test_missing_checkpoint_is_an_error(tmp_path, monkeypatch):
    monkeypatch.delenv('VFT_ALLOW_RANDOM_WEIGHTS', raising=False)
    with pytest.raises(MissingCheckpointError, match='i3d_rgb_checkpoint_path'):
        extract.ExtractI3D(_args(tmp_path, allow_random_weights=False))


def test_checkpoint_round_trip(tmp_path):
    """A torch .pt state_dict and the JAX package's .npz layout load to
    the same params."""
    from video_features_tpu.transplant.torch2jax import save_transplanted
    from video_features_torch.transplant import load_checkpoint
    sd = jax_i3d.init_state_dict(seed=0, modality='flow')
    torch.save({'state_dict': {f'module.{k}': torch.from_numpy(v)
                               for k, v in sd.items()}}, tmp_path / 'w.pt')
    save_transplanted(transplant(sd), str(tmp_path / 'w.npz'))
    a = load_checkpoint(str(tmp_path / 'w.pt'))
    b = load_checkpoint(str(tmp_path / 'w.npz'))
    wa = a['mixed_4b']['branch_1']['1']['conv3d']['weight']
    wb = b['mixed_4b']['branch_1']['1']['conv3d']['weight']
    assert wa.shape == (208, 96, 3, 3, 3)
    assert torch.equal(wa, wb)


def test_no_gpu_without_device_cpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    video = write_noise_clip(tmp_path / 'v.mp4', 3)
    with pytest.raises(RuntimeError, match='device=cpu'):
        load_config('i3d', overrides={'video_paths': video})
    with pytest.raises(RuntimeError, match='device=cpu'):
        extract.ExtractI3D(_args(tmp_path, device='cuda'))


def test_config_defaults_and_checks(tmp_path):
    video = write_noise_clip(tmp_path / 'v.mp4', 3)
    args = load_config('i3d', overrides={'video_paths': video, 'device': 'cpu',
                                         'output_path': str(tmp_path)})
    assert (args['stack_size'], args['step_size'], args['raft_iters']) == (16, 16, None)
    assert args['concat_rgb_flow'] is True
    assert args['output_path'] == str(tmp_path / 'i3d')
    with pytest.raises(ValueError, match='shorter than 10'):
        load_config('i3d', overrides={'video_paths': video, 'device': 'cpu',
                                      'stack_size': 8})
    with pytest.raises(NotImplementedError, match='Known: i3d.*vggish'):
        load_config('vggish2', overrides={'video_paths': video, 'device': 'cpu'})


def test_cli_usage_without_feature_type(capsys):
    from video_features_torch.cli import main
    assert main([]) == 2
    assert 'feature_type=i3d' in capsys.readouterr().out
