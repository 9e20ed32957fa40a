"""The port's S3D family (video_features_torch/models/s3d.py,
extract/s3d.py and the CLI around them) against the JAX package's, on
the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.models import s3d as jax_s3d
from video_features_tpu.ops import transforms as jax_tf
from video_features_tpu.registry import create_extractor as jax_create
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.extract import s3d as extract
from video_features_torch.models import s3d
from video_features_torch.ops import transforms
from video_features_torch.transplant import params_from_jax

REL_L2 = 1e-5       # float32 through the inception stack, different sum orders
RESIZE_REL_L2 = 1e-6
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
def net():
    sd = jax_s3d.init_state_dict(seed=1)
    assert all(np.array_equal(sd[k], v)
               for k, v in s3d.init_state_dict(seed=1).items())
    jp = transplant(sd)
    return jp, params_from_jax(jp)


@pytest.mark.parametrize('features', [True, False])
def test_forward_matches_jax(net, features):
    jp, tp = net
    x = np.random.RandomState(2).rand(1, 16, 64, 64, 3).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_s3d.forward(jp, jnp.asarray(x), features=features))
    with torch.inference_mode():
        got = s3d.forward(tp, torch.from_numpy(x), features=features).numpy()
    assert got.shape == ref.shape == ((1, 1024) if features else (1, 400))
    assert rel_l2(got, ref) <= REL_L2


def test_fewer_than_two_temporal_positions_is_an_error(net):
    x = torch.zeros(1, 8, 32, 32, 3)
    with pytest.raises(ValueError, match='stack_size >= 16'):
        s3d.forward(net[1], x)


@pytest.fixture(scope='module')
def jax_extractor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('jax_s3d')
    args = jax_load_config('s3d', overrides={
        'video_paths': str(tmp / 'v.mp4'), 'device': 'cpu',
        'allow_random_weights': True, 'output_path': str(tmp / 'out'),
        'tmp_path': str(tmp / 'tmp')})
    return jax_create(args)


@pytest.mark.parametrize('h,w,size', [(107, 160, (223, 334)),   # floors to 223
                                      (480, 320, (336, 224)),
                                      (256, 340, (224, 297))])
def test_geometry_and_input_match_jax(jax_extractor, h, w, size):
    """The short-side 224 sizes and the resized, cropped input of the
    step (the given-scale grid) against the JAX extractor's."""
    got_size, scale = extract.resize_geometry(h, w)
    _, ref_size, ref_scale = jax_extractor._geometry_step(h, w)
    assert got_size == tuple(ref_size) == size
    assert scale == ref_scale
    stacks = np.random.RandomState(3).randint(0, 256, (1, 2, h, w, 3)).astype(np.uint8)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_tf.center_crop(jax_tf.resize_bilinear_scale(
            jax_tf.to_float_zero_one(jnp.asarray(stacks)), ref_size, ref_scale),
            (224, 224)))
    got = transforms.center_crop(transforms.resize_bilinear_scale(
        transforms.to_float_zero_one(torch.from_numpy(stacks)), got_size, scale),
        224).numpy()
    assert got.shape == ref.shape == (1, 2, min(size[0], 224), min(size[1], 224), 3)
    assert rel_l2(got, ref) <= RESIZE_REL_L2


def test_extract_frames_without_a_full_window(tmp_path):
    ex = extract.ExtractS3D({
        'feature_type': 's3d', 'stack_size': 16, 'step_size': 16,
        'device': 'cpu', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(tmp_path)})
    frames = np.zeros((15, 40, 50, 3), np.uint8)
    feats = ex.extract_frames([(list(frames), None, None)])['s3d']
    assert feats.shape == (0, 1024) and feats.dtype == np.float32


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one 17-frame clip with stack_size=16 write
    s3d/<stem>_s3d.npy (1, 1024) within the bar, both retiming the clip
    to the default extraction_fps 25 by the same re-encode."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 17, seed=6)
    common = [f'video_paths={clip}', 'device=cpu', 'allow_random_weights=true',
              'stack_size=16', 'step_size=16', 'on_extraction=save_numpy']
    assert jax_main(['feature_type=s3d', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "tmp"}']) == 0
    assert torch_main(['feature_type=s3d', *common,
                       f'output_path={tmp_path / "torch"}',
                       f'tmp_path={tmp_path / "torch_tmp"}']) == 0
    ref = np.load(tmp_path / 'jax' / 's3d' / 'clip_s3d.npy')
    got = np.load(tmp_path / 'torch' / 's3d' / 'clip_s3d.npy')
    assert got.shape == ref.shape == (1, 1024)
    assert rel_l2(got, ref) <= CLI_REL_L2
