"""The port's R(2+1)D family (video_features_torch/models/r21d.py,
extract/r21d.py and the CLI around them) against the JAX package's, on
the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract.r21d import ExtractR21D as JaxExtractR21D
from video_features_tpu.models import r21d as jax_r21d
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.extract import r21d as extract
from video_features_torch.models import r21d
from video_features_torch.transplant import params_from_jax, params_from_torch

REL_L2 = 1e-5       # float32 through 18 layers, different sum orders
CLI_REL_L2 = 1e-3   # the BASELINE feature bar


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution can put ~4e-5 of error in
    one thread's chunk of the output; one thread holds 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def r18():
    jp = transplant(jax_r21d.init_state_dict(seed=1))
    return jp, params_from_jax(jp)


@pytest.mark.parametrize('planes', [(64, 64), (64, 128), (128, 256), (512, 512)])
def test_midplanes_match_jax(planes):
    assert r21d.midplanes(*planes) == jax_r21d.midplanes(*planes)


@pytest.mark.parametrize('features', [True, False])
def test_forward_matches_jax(r18, features):
    jp, tp = r18
    x = np.random.RandomState(2).randn(1, 8, 32, 32, 3).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_r21d.forward(jp, jnp.asarray(x), features=features))
    with torch.inference_mode():
        got = r21d.forward(tp, torch.from_numpy(x), features=features).numpy()
    assert got.shape == ref.shape == ((1, 512) if features else (1, 400))
    assert rel_l2(got, ref) <= REL_L2


def test_r2plus1d_34_param_tree_and_shapes():
    """The port's init gives the JAX package's numbers; a torch state_dict
    and the JAX tree load to the same shapes; 8- and 32-frame stacks give
    512-d features."""
    sd = r21d.init_state_dict(seed=3, arch='r2plus1d_34')
    ref = jax_r21d.init_state_dict(seed=3, arch='r2plus1d_34')
    assert sd.keys() == ref.keys()
    assert all(np.array_equal(sd[k], ref[k]) for k in sd)
    assert len(params_from_torch(sd)['layer3']) == 6

    def shapes(tree, prefix=''):
        return {f'{prefix}{k}': (shapes(v, f'{prefix}{k}.') if isinstance(v, dict)
                                 else tuple(v.shape)) for k, v in tree.items()}
    tp = params_from_jax(transplant(ref))
    assert shapes(tp) == shapes(params_from_torch(sd))
    assert tp['layer2']['0']['downsample']['0']['weight'].shape == (128, 64, 1, 1, 1)
    assert tp['fc']['weight'].shape == (400, 512)
    with torch.inference_mode():
        for stack in (8, 32):
            x = torch.from_numpy(np.random.RandomState(stack).randn(
                1, stack, 24, 24, 3).astype(np.float32))
            out = r21d.forward(tp, x, arch='r2plus1d_34')
            assert out.shape == (1, 512) and torch.isfinite(out).all()


@pytest.mark.parametrize('hw', [(48, 64), (240, 320)])
def test_step_matches_jax_forward_batch(r18, hw):
    """uint8 stacks through [0, 1] → resize to 128×171 (an upsample from
    48×64, a downsample from 240×320) → normalize → crop 112 → R(2+1)D."""
    jp, tp = r18
    stacks = np.random.RandomState(4).randint(0, 256, (2, 8, *hw, 3)).astype(np.uint8)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(JaxExtractR21D._forward_batch(
            jp, jnp.asarray(stacks), arch='r2plus1d_18'))
    with torch.inference_mode():
        got = extract.r21d_step(tp, torch.from_numpy(stacks), 'r2plus1d_18').numpy()
    assert got.shape == ref.shape == (2, 512)
    assert rel_l2(got, ref) <= REL_L2


def test_extract_frames_windows_and_empty_video(tmp_path, monkeypatch):
    """34 frames at the model's stack 16: 2 windows, batch 4 padded and
    masked; 10 frames: no full window → (0, 512)."""
    ex = extract.ExtractR21D({
        'feature_type': 'r21d', 'device': 'cpu', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(tmp_path)})
    assert (ex.stack_size, ex.step_size, ex.batch_size) == (16, 16, 4)
    seen = []

    def step(stacks):
        seen.append(tuple(stacks.shape))
        return {'r21d': stacks[:, 0, 0, 0, :1].float().repeat(1, 512)}

    monkeypatch.setattr(ex, 'packed_step', step)
    frames = np.arange(34, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 4, 5, 3), np.uint8)
    feats = ex.extract_frames([(list(frames), None, None)])['r21d']
    assert seen == [(4, 16, 4, 5, 3)]
    np.testing.assert_array_equal(feats[:, 0], [0, 16])
    empty = ex.extract_frames([(list(frames[:10]), None, None)])['r21d']
    assert empty.shape == (0, 512) and empty.dtype == np.float32


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one 17-frame clip write r21d/<model_name>/<stem>_r21d.npy
    (1, 512) within the bar, and the same set of files."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 17, seed=5)
    common = [f'video_paths={clip}', 'device=cpu', 'allow_random_weights=true',
              'batch_size=1', 'on_extraction=save_numpy']
    assert jax_main(['feature_type=r21d', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "tmp"}']) == 0
    assert torch_main(['feature_type=r21d', *common,
                       f'output_path={tmp_path / "torch"}']) == 0
    sub = ('r21d', 'r2plus1d_18_16_kinetics')
    ref_dir, got_dir = tmp_path.joinpath('jax', *sub), tmp_path.joinpath('torch', *sub)
    assert sorted(p.name for p in got_dir.iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir())
    ref, got = np.load(ref_dir / 'clip_r21d.npy'), np.load(got_dir / 'clip_r21d.npy')
    assert got.shape == ref.shape == (1, 512)
    assert rel_l2(got, ref) <= CLI_REL_L2
