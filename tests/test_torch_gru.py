"""The SepConvGRU direction (video_features_torch/ops/gru.py) and the
port's ``sep_conv_gru`` against the JAX package's, on the CPU.

On the CPU the wrapper runs the plain version; these tests hold it, the
weight repack and the tap and padding convention the CUDA kernel relies
on to the JAX reference. The kernel itself is held to the plain version
on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import raft as jax_raft
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.models import raft
from video_features_torch.ops import gru
from video_features_torch.transplant import params_from_jax

# fp32 on both sides: reassociation of 1,280-term (conv) and 384-term
# (context) sums with O(1) pre-activations behind a sigmoid or tanh
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution on the CPU takes, in some
    runs, a work split whose chunk carries ~4e-5 of error (2e-6
    otherwise); one intra-op thread keeps these comparisons at the fp32
    level they hold the port to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def params():
    jp = transplant(jax_raft.init_state_dict(seed=3))['update_block']['gru']
    return jp, params_from_jax(jp)


def _state(seed, shape=(2, 6, 7)):
    rng = np.random.RandomState(seed)
    h = np.tanh(rng.randn(*shape, 128)).astype(np.float32)
    motion = rng.randn(*shape, 128).astype(np.float32)
    inp = np.maximum(rng.randn(*shape, 128), 0).astype(np.float32)
    return h, motion, inp


def test_sep_conv_gru_matches_jax(params):
    jp, tp = params
    h, motion, inp = _state(0)
    with jax.default_matmul_precision('highest'):
        fused = jax_raft.fuse_gru_params(jp)
        terms = jax_raft.gru_inp_terms(fused, jnp.asarray(inp))
        ref = np.asarray(jax_raft.sep_conv_gru(fused, terms, jnp.asarray(h),
                                               jnp.asarray(motion)))
    fused_t = raft.fuse_gru_params(tp)
    terms_t = raft.gru_inp_terms(fused_t, torch.from_numpy(inp))
    got = raft.sep_conv_gru(fused_t, terms_t, torch.from_numpy(h),
                            torch.from_numpy(motion)).numpy()
    assert got.shape == ref.shape == (2, 6, 7, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def tap_direction(h, motion, w_zr, w_q, zr_term, q_term, axis):
    """The direction as 5 shifted einsums of the tap-layout weights (the
    form of ``tools/gru_kernel_experiment.py::xla_direction``, for both
    axes), in float64: tap t reads offset t - 2, zeros past the edge."""
    ax = 2 if axis == 'w' else 1
    n = h.shape[ax]

    def taps(x, w):
        pad = [(0, 0)] * 4
        pad[ax] = (2, 2)
        xp = np.pad(x, pad)
        return sum(np.einsum('bhwc,cn->bhwn',
                             np.take(xp, np.arange(s, s + n), axis=ax), w[s])
                   for s in range(5))

    h, motion = h.astype(np.float64), motion.astype(np.float64)
    zr = _sigmoid(taps(np.concatenate([h, motion], -1), w_zr) + zr_term)
    z, r = np.split(zr, 2, -1)
    q = np.tanh(taps(np.concatenate([r * h, motion], -1), w_q) + q_term)
    return (1 - z) * h + z * q


@pytest.mark.parametrize('suffix,axis', [('1', 'w'), ('2', 'h')])
def test_plain_direction_matches_tap_einsum(params, suffix, axis):
    """fuse_gru_params' repacked weights through gru_direction_plain
    (convs) and through the tap einsum agree: the repack and the tap and
    padding convention hold for both axes."""
    _, tp = params
    w_zr, w_q = raft.fuse_gru_params(tp)[f'taps{suffix}']
    assert w_zr.shape == (5, 256, 256) and w_q.shape == (5, 256, 128)
    h, motion, _ = _state(1, (2, 5, 9))
    rng = np.random.RandomState(2)
    zr_term = (rng.randn(2, 5, 9, 256) * 0.1).astype(np.float32)
    q_term = (rng.randn(2, 5, 9, 128) * 0.1).astype(np.float32)
    ref = tap_direction(h, motion, w_zr.double().numpy(), w_q.double().numpy(),
                        zr_term, q_term, axis)
    got = gru.gru_direction_plain(
        torch.from_numpy(h), torch.from_numpy(motion), w_zr, w_q,
        torch.from_numpy(zr_term), torch.from_numpy(q_term), axis).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _inputs(b=1, h=4, w=5):
    rng = np.random.RandomState(4)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return [t(b, h, w, 128), t(b, h, w, 128), t(5, 256, 256), t(5, 256, 128),
            t(b, h, w, 256), t(b, h, w, 128)]


def test_cpu_wrapper_runs_plain_and_counts_no_launches():
    x = _inputs()
    before = gru.gru_direction.launches
    for axis in gru.AXES:
        torch.testing.assert_close(gru.gru_direction(*x, axis),
                                   gru.gru_direction_plain(*x, axis),
                                   rtol=0, atol=0)
    assert gru.gru_direction.launches == before


def _bad(case):
    x = _inputs()
    if case == 'dtype':
        x[0] = x[0].double()
    elif case == 'h channels':
        x[0] = x[0][..., :64]
    elif case == 'motion shape':
        x[1] = x[1][:, :3]
    elif case == 'zr_term channels':
        x[4] = x[4][..., :128].contiguous()
    elif case == 'taps':
        x[2] = x[2][:3]
    elif case == 'w_q out':
        x[3] = torch.zeros(5, 256, 256)
    elif case == 'contiguity':
        x[1] = x[1].transpose(1, 2).contiguous().transpose(1, 2)
    return x


@pytest.mark.parametrize('case', ['dtype', 'h channels', 'motion shape',
                                  'zr_term channels', 'taps', 'w_q out',
                                  'contiguity'])
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises(ValueError):
        gru.gru_direction(*_bad(case), 'w')


def test_wrapper_rejects_bad_axis():
    with pytest.raises(ValueError, match='axis'):
        gru.gru_direction(*_inputs(), 'x')


def test_pack_direction_round_trips_conv_weights():
    rng = np.random.RandomState(5)
    for shape, axis in (((256, 256, 1, 5), 'w'), ((256, 256, 5, 1), 'h')):
        wz = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        wq = torch.from_numpy(rng.randn(128, *shape[1:]).astype(np.float32))
        w_zr, w_q = gru.pack_direction(wz, wq)
        assert w_zr.is_contiguous() and w_q.shape == (5, 256, 128)
        assert torch.equal(gru._conv_weight(w_zr, axis), wz)
        assert torch.equal(gru._conv_weight(w_q, axis), wq)
