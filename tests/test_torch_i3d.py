"""The port's I3D (video_features_torch/models/i3d.py) and its nn and
transform helpers against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import i3d as jax_i3d
from video_features_tpu.ops import nn as jax_nn
from video_features_tpu.ops import transforms as jax_tf
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.models import i3d
from video_features_torch.ops import nn, transforms
from video_features_torch.transplant import params_from_jax

REL_L2 = 1e-5   # float32 through 60 conv layers, different sum orders


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope='module', params=['rgb', 'flow'])
def tower(request):
    modality = request.param
    jp = transplant(jax_i3d.init_state_dict(seed=1, modality=modality))
    c = 3 if modality == 'rgb' else 2
    x = np.random.RandomState(2).uniform(-1, 1, (1, 10, 64, 64, c)).astype(np.float32)
    return jp, params_from_jax(jp), x


def test_features_match_jax(tower):
    jp, tp, x = tower
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_i3d.forward(jp, jnp.asarray(x), features=True))
    with torch.inference_mode():
        got = i3d.forward(tp, torch.from_numpy(x), features=True).numpy()
    assert got.shape == ref.shape == (1, i3d.FEAT_DIM)
    assert rel_l2(got, ref) <= REL_L2


def test_logits_head_matches_jax(tower):
    jp, tp, x = tower
    with jax.default_matmul_precision('highest'):
        ref_p, ref_l = jax_i3d.forward(jp, jnp.asarray(x), features=False)
    with torch.inference_mode():
        got_p, got_l = i3d.forward(tp, torch.from_numpy(x), features=False)
    assert got_l.shape == ref_l.shape == (1, 400)
    assert rel_l2(got_l.numpy(), ref_l) <= REL_L2
    assert rel_l2(got_p.numpy(), ref_p) <= REL_L2


@pytest.mark.parametrize('kernel,stride,size', [
    ((1, 3, 3), (1, 2, 2), (4, 9, 10)),
    ((3, 3, 3), (2, 2, 2), (5, 7, 7)),
    ((2, 2, 2), (2, 2, 2), (3, 5, 4)),
    ((3, 3, 3), (1, 1, 1), (4, 6, 5)),
])
def test_max_pool_tf_matches_jax(kernel, stride, size):
    x = np.random.RandomState(3).randn(2, *size, 4).astype(np.float32)
    ref = np.asarray(jax_i3d.max_pool_tf(jnp.asarray(x), kernel, stride))
    got = i3d.max_pool_tf(torch.from_numpy(x), kernel, stride).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('kernel,stride', [((7, 7, 7), (2, 2, 2)),
                                           ((3, 3, 3), (1, 1, 1)),
                                           ((1, 1, 1), (1, 1, 1))])
def test_asymmetric_conv_matches_jax(kernel, stride):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 9, 12, 11, 3).astype(np.float32)
    w = rng.randn(5, 3, *kernel).astype(np.float32)     # torch (O, I, *k)
    pads = jax_i3d.tf_same_pads(kernel, stride)
    assert i3d.tf_same_pads(kernel, stride) == pads
    ref = np.asarray(jax_nn.conv(jnp.asarray(x),
                                 jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                                 stride=stride, padding=pads))
    got = nn.conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                  padding=pads).numpy()
    # a 7×7×7×3 window sums ~1000 products of O(1) terms: 1e-5 of the
    # output's scale covers the float32 reassociation
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_instance_norm_matches_jax():
    x = np.random.RandomState(5).randn(2, 6, 7, 4).astype(np.float32) * 3 + 1
    ref = np.asarray(jax_nn.instance_norm(jnp.asarray(x), {}))
    got = nn.instance_norm(torch.from_numpy(x), {}).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('in_size,kernel,stride', [(7, 3, 2), (8, 3, 2),
                                                   (5, 2, 2), (4, 3, 1)])
def test_ceil_mode_padding_matches_jax(in_size, kernel, stride):
    assert nn.ceil_mode_padding(in_size, kernel, stride) == \
        jax_nn.ceil_mode_padding(in_size, kernel, stride)


def test_flow_to_uint8_levels_matches_jax():
    """Offset 128, round half to even, 256.0 kept unclipped."""
    x = np.concatenate([
        np.random.RandomState(6).uniform(-25, 25, 4000),
        np.array([0.0, 20.0, -20.0, 1 / 12.75, -1 / 12.75, 3 / 12.75,
                  5 / 12.75])]).astype(np.float32)
    ref = np.asarray(jax_tf.flow_to_uint8_levels(jnp.asarray(x), 20.0))
    got = transforms.flow_to_uint8_levels(torch.from_numpy(x), 20.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.max() == 256.0


@pytest.mark.parametrize('shape,size', [((2, 3, 256, 344, 3), 224),
                                        ((1, 70, 91, 2), 64)])
def test_crop_and_scale_match_jax(shape, size):
    x = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    ref = np.asarray(jax_tf.scale_to_pm1(jax_tf.center_crop(jnp.asarray(x), size)))
    got = transforms.scale_to_pm1(
        transforms.center_crop(torch.from_numpy(x), size)).numpy()
    np.testing.assert_array_equal(got, ref)
