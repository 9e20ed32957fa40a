"""The port's ResNet family (video_features_torch/models/resnet.py,
extract/framewise.py, extract/resnet.py and the CLI around them)
against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract.resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.models import resnet as jax_resnet
from video_features_tpu.ops import host_transforms as jax_host
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.extract import resnet as extract
from video_features_torch.models import resnet
from video_features_torch.ops import host_transforms
from video_features_torch.transplant import params_from_jax

REL_L2 = 1e-5       # float32 through the residual stack, different sum orders
CLI_REL_L2 = 1e-3   # the BASELINE feature bar
ARCHS = ('resnet18', 'resnet50', 'resnext50_32x4d', 'wide_resnet50_2')


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution (the grouped one above
    all) can put ~4e-5 of error in one thread's chunk; one thread holds
    1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def nets():
    """{arch: (JAX params, port params)} from one seeded state_dict each,
    which both packages' init_state_dict produce alike."""
    out = {}
    for seed, arch in enumerate(ARCHS):
        sd = jax_resnet.init_state_dict(seed=seed, arch=arch)
        mine = resnet.init_state_dict(seed=seed, arch=arch)
        assert sd.keys() == mine.keys()
        assert all(np.array_equal(sd[k], mine[k]) for k in sd)
        jp = transplant(sd)
        out[arch] = (jp, params_from_jax(jp))
    return out


@pytest.mark.parametrize('features', [True, False])
@pytest.mark.parametrize('arch,size', [('resnet18', 64), ('resnet50', 96),
                                       ('resnext50_32x4d', 112),
                                       ('wide_resnet50_2', 80)])
def test_forward_matches_jax(nets, arch, size, features):
    jp, tp = nets[arch]
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_resnet.forward(jp, jnp.asarray(x), arch=arch,
                                            features=features))
    with torch.inference_mode():
        got = resnet.forward(tp, torch.from_numpy(x), arch=arch,
                             features=features).numpy()
    dim = resnet.ARCHS[arch]['feat_dim'] if features else 1000
    assert got.shape == ref.shape == (2, dim)
    assert rel_l2(got, ref) <= REL_L2


def test_step_matches_the_jax_extractor_step(nets):
    """uint8 frames → [0, 1] → normalize → features, against the JAX
    extractor's jitted step function."""
    jp, tp = nets['resnet18']
    frames = np.random.RandomState(5).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(JaxExtractResNet._forward(jp, jnp.asarray(frames),
                                                   arch='resnet18'))
    with torch.inference_mode():
        got = extract.resnet_step(tp, torch.from_numpy(frames), 'resnet18').numpy()
    assert rel_l2(got, ref) <= REL_L2


@pytest.mark.parametrize('arch', ['resnet50', 'resnext101_64x4d'])
@pytest.mark.parametrize('h,w', [(48, 64), (361, 481), (300, 225)])
def test_host_transform_matches_jax(arch, h, w):
    """Short side 256 (232 for resnext101_64x4d) with PIL bilinear, then
    the 224 crop whose offsets round half to even (361 → 232 gives an
    odd margin)."""
    frame = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    ex = object.__new__(extract.ExtractResNet)
    ex.model_name = arch
    size = 232 if arch == 'resnext101_64x4d' else 256
    assert extract.RESIZE_OVERRIDES.get(arch, 256) == size
    ref = jax_host.center_crop_host(jax_host.short_side_resize_pil(frame, size), 224)
    got = ex.host_transform(frame)
    assert got.shape == ref.shape == (224, 224, 3)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('h,w,size', [(5, 9, 2), (6, 9, 3), (7, 8, 4), (9, 9, 8)])
def test_center_crop_offsets_round_half_to_even(h, w, size):
    frame = np.arange(h * w * 3, dtype=np.uint8).reshape(h, w, 3)
    got = host_transforms.center_crop_host(frame, size)
    assert np.array_equal(got, jax_host.center_crop_host(frame, size))
    i, j = round((h - size) / 2), round((w - size) / 2)
    assert np.array_equal(got, frame[i:i + size, j:j + size])


def test_unknown_arch_lists_the_valid_ones():
    with pytest.raises(ValueError, match='wide_resnet101_2') as e:
        resnet.arch_def('resnet200')
    assert all(name in str(e.value) for name in resnet.ARCHS)


def test_extract_frames_rows_and_empty_video(tmp_path):
    """One row per frame whatever the batching, and (0, 512) without a
    frame."""
    ex = extract.ExtractResNet({
        'feature_type': 'resnet', 'model_name': 'resnet18', 'batch_size': 2,
        'device': 'cpu', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(tmp_path)})
    frames = np.random.RandomState(6).randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    out = ex.extract_frames([(list(frames[:2]), [0.0, 40.0], [0, 1]),
                             (list(frames[2:]), [80.0], [2])], 25.0)
    assert out['resnet'].shape == (3, 512) and float(out['fps']) == 25.0
    assert out['timestamps_ms'].tolist() == [0.0, 40.0, 80.0]
    one = ex.extract_frames([(list(frames), [0.0, 40.0, 80.0], [0, 1, 2])], 25.0)
    assert rel_l2(one['resnet'], out['resnet']) <= REL_L2
    empty = ex.extract_frames([], 25.0)
    assert empty['resnet'].shape == (0, 512) and empty['resnet'].dtype == np.float32


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one clip, resnet18 retimed to 10 fps (a re-encode on
    both sides), batch 4 with a short tail: resnet/resnet18/<stem>_resnet.npy
    within the bar, _fps.npy and _timestamps_ms.npy identical."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    clip = write_noise_clip(tmp_path / 'clip.mp4', 14, seed=8)
    common = [f'video_paths={clip}', 'device=cpu', 'allow_random_weights=true',
              'model_name=resnet18', 'batch_size=4', 'extraction_fps=10',
              'on_extraction=save_numpy']
    assert jax_main(['feature_type=resnet', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "jax_tmp"}']) == 0
    assert torch_main(['feature_type=resnet', *common,
                       f'output_path={tmp_path / "torch"}',
                       f'tmp_path={tmp_path / "torch_tmp"}']) == 0
    out = {side: tmp_path / side / 'resnet' / 'resnet18' for side in ('jax', 'torch')}
    ref, got = (np.load(out[s] / 'clip_resnet.npy') for s in ('jax', 'torch'))
    assert got.shape == ref.shape and got.shape[1] == 512 and got.shape[0] >= 5
    assert rel_l2(got, ref) <= CLI_REL_L2
    for key in ('fps', 'timestamps_ms'):
        assert np.array_equal(np.load(out['torch'] / f'clip_{key}.npy'),
                              np.load(out['jax'] / f'clip_{key}.npy'))
    # the re-encode's temp file is gone (keep_tmp_files is false)
    assert not any((tmp_path / 'torch_tmp').rglob('*.mp4'))
