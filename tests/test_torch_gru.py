"""The SepConvGRU direction (video_features_torch/ops/gru.py) and the
port's ``sep_conv_gru`` against the JAX package's, on the CPU.

On the CPU the wrapper runs the plain version; these tests hold it, the
weight repack and the tap and padding convention the CUDA kernel relies
on to the JAX reference, and pin the kernel's 3xTF32 arithmetic by
emulating it. The kernel itself is held to the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py).
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
from video_features_torch.ops.nn import conv
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
    assert w_zr.shape == (2, 5, 8, 256, 32) and w_q.shape == (2, 5, 8, 128, 32)
    h, motion, _ = _state(1, (2, 5, 9))
    rng = np.random.RandomState(2)
    zr_term = (rng.randn(2, 5, 9, 256) * 0.1).astype(np.float32)
    q_term = (rng.randn(2, 5, 9, 128) * 0.1).astype(np.float32)

    def taps(w):           # (5, O, I) → the einsum's (5, I, O), float64
        return gru.unpack_direction(w.double()).permute(0, 2, 1).numpy()
    ref = tap_direction(h, motion, taps(w_zr), taps(w_q), zr_term, q_term, axis)
    got = gru.gru_direction_plain(
        torch.from_numpy(h), torch.from_numpy(motion), w_zr, w_q,
        torch.from_numpy(zr_term), torch.from_numpy(q_term), axis).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _inputs(b=1, h=4, w=5, seed=4, w_scale=1.0, term_scale=1.0):
    """h (tanh), motion, packed w_zr and w_q, zr_term, q_term."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    h_, motion = torch.tanh(t(b, h, w, 128)), t(b, h, w, 128)
    w_zr, w_q = gru.pack_direction(t(256, 256, 1, 5, scale=w_scale),
                                   t(128, 256, 1, 5, scale=w_scale))
    return [h_, motion, w_zr, w_q, t(b, h, w, 256, scale=term_scale),
            t(b, h, w, 128, scale=term_scale)]


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
        x[2] = x[2][:, :3]
    elif case == 'w_q out':
        x[3] = torch.zeros(2, 5, 8, 256, 32)
    elif case == 'unpacked weights':
        x[3] = torch.zeros(5, 256, 128)
    elif case == 'contiguity':
        x[1] = x[1].transpose(1, 2).contiguous().transpose(1, 2)
    return x


@pytest.mark.parametrize('case', ['dtype', 'h channels', 'motion shape',
                                  'zr_term channels', 'taps', 'w_q out',
                                  'unpacked weights', 'contiguity'])
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises(ValueError):
        gru.gru_direction(*_bad(case), 'w')


def test_wrapper_rejects_bad_axis():
    with pytest.raises(ValueError, match='axis'):
        gru.gru_direction(*_inputs(), 'x')


def test_pack_direction_round_trips_conv_weights():
    """The packed layout reads back into the conv weights, for both axes:
    hi + lo rebuilds each weight to ≤ 2⁻²¹ relative."""
    rng = np.random.RandomState(5)
    for shape, axis in (((256, 256, 1, 5), 'w'), ((256, 256, 5, 1), 'h')):
        wz = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        wq = torch.from_numpy(rng.randn(128, *shape[1:]).astype(np.float32))
        w_zr, w_q = gru.pack_direction(wz, wq)
        assert w_zr.is_contiguous() and w_zr.shape == (2, 5, 8, 256, 32)
        assert w_q.is_contiguous() and w_q.shape == (2, 5, 8, 128, 32)
        for packed, ref in ((w_zr, wz), (w_q, wq)):
            got = gru._conv_weight(gru.unpack_direction(packed), axis)
            assert got.shape == ref.shape
            assert ((got - ref).abs() <= 2.0 ** -21 * ref.abs()).all()


def test_pack_direction_parts_and_swizzle():
    """Both parts are exact TF32 values (the low 13 mantissa bits zero),
    hi is the round-to-nearest TF32 of the weight, and 16-byte chunk j of
    out channel n's 32-channel row (K positions 4j … 4j + 3, channels
    ``K_ORDER``) sits at chunk j ^ (n % 8)."""
    rng = np.random.RandomState(6)
    w = torch.from_numpy(rng.randn(256, 256, 1, 5).astype(np.float32))
    packed, _ = gru.pack_direction(w, w[:128])
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    hi, lo = gru.unpack_parts(packed)
    taps = w.reshape(256, 256, 5).permute(2, 0, 1)
    assert torch.equal(hi, gru.tf32_round(taps.contiguous()))
    assert (lo.abs() <= 2.0 ** -11 * hi.abs()).all()
    for tap, sl, n, j in ((0, 0, 0, 0), (4, 7, 255, 7), (2, 3, 13, 2),
                          (1, 5, 100, 5)):
        stored = packed[0, tap, sl, n, 4 * (j ^ (n % 8)):4 * (j ^ (n % 8)) + 4]
        channels = [sl * 32 + gru.K_ORDER[4 * j + e] for e in range(4)]
        want = gru.tf32_round(taps[tap, n, channels].contiguous())
        assert torch.equal(stored, want)
    # the kernel's thread t reads its K steps' columns t and t + 4 from
    # channels 8t … 8t + 7
    for t in range(4):
        got = sorted(gru.K_ORDER[8 * k + c] for k in range(4) for c in (t, t + 4))
        assert got == list(range(8 * t, 8 * t + 8))


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -12, 0.0, -0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0 + 2.0 ** -9, 1.0, 0.0, -0.0]
    assert gru.tf32_round(x).tolist() == want


def tf32x3_direction(h, motion, w_zr, w_q, zr_term, q_term, axis):
    """The kernel's arithmetic, emulated in float32 on the CPU: each conv
    input splits into TF32 hi and lo (round to nearest, as
    ``cvt.rna.tf32.f32``), the packed weights give theirs, and the three
    products lo·hi + hi·lo + hi·hi add in float32 (the kernel adds them
    per 8-channel step on the tensor cores; that order is the card's)."""
    pad = gru.PADS[axis]

    def conv3(x, packed):
        x_hi, x_lo = gru.tf32_split(x.contiguous())
        w_hi, w_lo = (gru._conv_weight(p, axis) for p in gru.unpack_parts(packed))
        return (conv(x_lo, w_hi, padding=pad) + conv(x_hi, w_lo, padding=pad)
                + conv(x_hi, w_hi, padding=pad))
    zr = torch.sigmoid(conv3(torch.cat([h, motion], -1), w_zr) + zr_term)
    z, r = torch.chunk(zr, 2, dim=-1)
    q = torch.tanh(conv3(torch.cat([r * h, motion], -1), w_q) + q_term)
    return (1 - z) * h + z * q


@pytest.mark.parametrize('axis', gru.AXES)
def test_tf32x3_emulation_holds_the_kernel_bar(axis):
    """3xTF32 at the RAFT family's batch-8 grid (8, 32, 43) with
    ``chip_smoke.py``'s input scales (motion 1, weights 0.05, terms 0.1)
    against a float64 plain version: within the 1e-5 kernel bar."""
    x = _inputs(8, 32, 43, seed=7, w_scale=0.05, term_scale=0.1)
    ref = gru.gru_direction_plain(*[t.double() for t in x], axis)
    err = (tf32x3_direction(*x, axis).double() - ref).abs().max().item()
    assert err <= ATOL, err
    # the split does the work: one TF32 product alone misses the bar
    one_pass = gru.gru_direction_convs(
        gru.tf32_round(x[0]), gru.tf32_round(x[1]),
        *[gru._conv_weight(gru.unpack_parts(w)[0], axis) for w in x[2:4]],
        *x[4:], axis)
    assert (one_pass.double() - ref).abs().max().item() > ATOL
