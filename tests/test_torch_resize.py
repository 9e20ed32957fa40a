"""The port's device resizes (video_features_torch/ops/transforms.py) and
the i3d ``device_resize`` wiring against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract import i3d as jax_extract
from video_features_tpu.models import i3d as jax_i3d
from video_features_tpu.models import raft as jax_raft
from video_features_tpu.ops import transforms as jax_tf
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.extract import i3d as extract
from video_features_torch.models import raft
from video_features_torch.ops import transforms
from video_features_torch.ops.host_transforms import pil_edge_resize_geometry
from video_features_torch.transplant import params_from_jax

RESIZE_REL_L2 = 1e-6   # the same float32 weights, two taps per output
FEATURE_REL_L2 = 1e-3  # the BASELINE feature bar (flow quantization cliff)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize('h,w,oh,ow', [
    (240, 320, 256, 341),    # upscale
    (360, 480, 256, 341),    # downscale
    (123, 77, 45, 200),      # mixed down/up
    (256, 344, 256, 344),    # identity
    (100, 100, 256, 256),    # pure upscale
])
def test_pil_resize_is_byte_equal_to_jax_and_pil(h, w, oh, ow):
    """Unbatched uint8 and a batched (B, S, H, W, C) float32-holding-
    integers input, byte for byte."""
    from PIL import Image
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    batch = rng.randint(0, 256, (2, 3, h, w, 3)).astype(np.float32)
    for x in (img, batch):
        got = transforms.pil_resize_bilinear_device(torch.from_numpy(x), (oh, ow))
        ref = np.asarray(jax.jit(
            lambda a: jax_tf.pil_resize_bilinear_device(a, (oh, ow)))(x))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    pil = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(
        transforms.pil_resize_bilinear_device(torch.from_numpy(img), (oh, ow)).numpy(),
        pil)


@pytest.mark.parametrize('h,w,size', [(240, 320, (128, 171)),   # down
                                      (48, 64, (128, 171)),     # up
                                      (100, 100, (37, 250))])   # mixed
def test_resize_bilinear_matches_jax(h, w, size):
    x = np.random.RandomState(1).rand(2, 3, h, w, 3).astype(np.float32)
    ref = np.asarray(jax_tf.resize_bilinear(jnp.asarray(x), size))
    got = transforms.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == ref.shape == (2, 3, *size, 3)
    assert rel_l2(got, ref) <= RESIZE_REL_L2


@pytest.mark.parametrize('h,w', [(256, 340), (107, 160), (480, 320)])
def test_resize_bilinear_scale_matches_jax(h, w):
    """The given-scale grid of s3d's short-side 224 resize (at 256×340
    it differs from out/in on the long axis)."""
    scale = 224 / min(h, w)
    size = (int(h * scale), int(w * scale))
    x = np.random.RandomState(2).rand(1, 2, h, w, 3).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_tf.resize_bilinear_scale(jnp.asarray(x), size, scale))
    got = transforms.resize_bilinear_scale(torch.from_numpy(x), size, scale).numpy()
    assert got.shape == ref.shape
    assert rel_l2(got, ref) <= RESIZE_REL_L2


def test_fused_step_with_resize_to_matches_jax():
    """Raw 60×80 frames resized to 64×85 inside the step (pads then those
    of 64×85), both towers and RAFT, against the JAX fused step."""
    jp = {'rgb': transplant(jax_i3d.init_state_dict(seed=0, modality='rgb')),
          'flow': transplant(jax_i3d.init_state_dict(seed=1, modality='flow')),
          'raft': transplant(jax_raft.init_state_dict(seed=2))}
    tp = {k: params_from_jax(v) for k, v in jp.items()}
    stacks = np.random.RandomState(3).randint(
        0, 256, (1, 11, 60, 80, 3)).astype(np.uint8)
    resize_to = pil_edge_resize_geometry(60, 80, 64)
    assert resize_to == (64, 85)
    pads = raft.pad_amounts(*resize_to)
    with jax.default_matmul_precision('highest'):
        ref = jax_extract.fused_two_stream_step(
            jp, jnp.asarray(stacks), pads, ('rgb', 'flow'), crop_size=64,
            platform="cpu", raft_iters=1, resize_to=resize_to)
    with torch.inference_mode():
        got = extract.fused_two_stream_step(
            tp, torch.from_numpy(stacks), pads, ('rgb', 'flow'), crop_size=64,
            raft_iters=1, resize_to=resize_to)
    for s in ('rgb', 'flow'):
        assert got[s].shape == (1, 1024)
        assert rel_l2(got[s].numpy(), ref[s]) <= FEATURE_REL_L2, s


def test_cli_device_resize_matches_jax_cli(tmp_path):
    """Both CLIs with device_resize=true on one 17-frame 64×48 clip (one
    window, resized to 341×256 on the device) write <stem>.npy (1, 2048)
    within the bar."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 17, seed=4)
    common = [f'video_paths={clip}', 'device=cpu', 'raft_iters=1',
              'allow_random_weights=true', 'batch_size=1', 'device_resize=true']
    assert jax_main(['feature_type=i3d', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "tmp"}']) == 0
    assert torch_main(['feature_type=i3d', *common,
                       f'output_path={tmp_path / "torch"}']) == 0
    ref = np.load(tmp_path / 'jax' / 'i3d' / 'clip.npy')
    got = np.load(tmp_path / 'torch' / 'i3d' / 'clip.npy')
    assert got.shape == ref.shape == (1, 2048)
    assert rel_l2(got[:, :1024], ref[:, :1024]) <= FEATURE_REL_L2
    assert rel_l2(got[:, 1024:], ref[:, 1024:]) <= FEATURE_REL_L2


def test_extractor_device_resize_equals_host_resize(tmp_path):
    """ExtractI3D on raw 60×80 frames with device_resize=true gives the
    features of device_resize=false on the same frames resized first
    (identical pixels)."""
    ex = extract.ExtractI3D({
        'feature_type': 'i3d', 'stack_size': 10, 'step_size': 10,
        'raft_iters': 1, 'batch_size': 1, 'device': 'cpu',
        'allow_random_weights': True, 'on_extraction': 'save_numpy',
        'output_path': str(tmp_path), 'device_resize': True})
    raw = np.random.RandomState(5).randint(0, 256, (11, 60, 80, 3)).astype(np.uint8)
    geometry = ex.geometry(60, 80)
    assert geometry[0] == pil_edge_resize_geometry(60, 80, 256) == (256, 341)
    assert geometry[1] == raft.pad_amounts(256, 341)
    got = ex.extract_frames([(list(raw), None, None)])
    resized = transforms.pil_resize_bilinear_device(torch.from_numpy(raw), (256, 341))
    ex.device_resize = False
    ref = ex.extract_frames([(list(resized.numpy()), None, None)])
    for s in ('rgb', 'flow'):
        assert got[s].shape == (1, 1024)
        np.testing.assert_array_equal(got[s], ref[s])
