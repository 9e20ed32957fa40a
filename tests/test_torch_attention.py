"""The port's attention (video_features_torch/ops/attention.py): dense and
blockwise against the JAX package's functions, ragged key counts, a
block whose keys are all masked, and blockwise against dense, on the
CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_torch.ops import attention
from video_features_tpu.ops import attention as jax_attention

REL_L2 = 1e-5


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def qkv(b, s, h, d, seed=0, sq=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq or s, h, d).astype(np.float32)
    k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize('b,s,h,d,scale', [(2, 197, 3, 16, None),
                                           (1, 50, 2, 32, 0.3)])
def test_dense_matches_jax(b, s, h, d, scale):
    q, k, v = qkv(b, s, h, d)
    ref = np.asarray(jax_attention.dense_attention(*map(jnp.asarray, (q, k, v)),
                                                   scale=scale))
    got = attention.dense_attention(*map(torch.from_numpy, (q, k, v)), scale=scale)
    assert got.shape == (b, s, h, d)
    assert rel_l2(got.numpy(), ref) <= REL_L2


@pytest.mark.parametrize('s,block', [(2305, 512),   # ViT-B/16 at 768 px: ragged
                                     (1024, 512),   # block-aligned: no mask
                                     (700, 256),    # ragged, 3 blocks
                                     (100, 512)])   # one block shorter than asked
def test_blockwise_matches_jax(s, block):
    q, k, v = qkv(1, s, 2, 16, seed=s)
    ref = np.asarray(jax_attention.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), block_size=block))
    got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                        block_size=block)
    assert got.shape == (1, s, 2, 16)
    assert rel_l2(got.numpy(), ref) <= REL_L2


@pytest.mark.parametrize('s,block,sq', [(2305, 512, None), (700, 256, None),
                                        (777, 128, 33)])
def test_blockwise_matches_dense(s, block, sq):
    """Another query count than keys as well: only the keys are blocked."""
    q, k, v = map(torch.from_numpy, qkv(2, s, 3, 8, seed=7, sq=sq))
    dense = attention.dense_attention(q, k, v)
    blocked = attention.blockwise_attention(q, k, v, block_size=block)
    assert rel_l2(blocked.numpy(), dense.numpy()) <= REL_L2


def _to_heads(x):
    """(B, S, H, D) numpy → (B, H, S, D) torch (the port's carry layout)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize('first', [True, False])
def test_a_block_of_masked_keys_leaves_the_carry_unchanged(first):
    """A block whose keys are all padding: first (the running max still
    -inf, where exp(-inf - -inf) would be a NaN without the m_safe guard)
    or after a real block. Against the JAX package's _online_block."""
    q, k, v = qkv(1, 64, 2, 8, seed=3)
    scale = 8 ** -0.5
    none = np.zeros(64, bool)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jcarry = jax_attention._online_init(jq)
    carry = attention._online_init(_to_heads(q))
    if not first:
        jcarry = jax_attention._online_block(jq, *jcarry, jk, jv, scale)
        carry = attention._online_block(_to_heads(q), *carry, _to_heads(k),
                                        _to_heads(v), scale)
    before = [t.clone() for t in carry]
    jcarry = jax_attention._online_block(jq, *jcarry, jk, jv, scale,
                                         valid=jnp.asarray(none))
    carry = attention._online_block(_to_heads(q), *carry, _to_heads(k),
                                    _to_heads(v), scale,
                                    valid=torch.from_numpy(none))
    for got, was, ref in zip(carry, before, jcarry):
        ref = np.asarray(ref).transpose(0, 2, 1, 3)
        assert not torch.isnan(got).any()
        assert torch.equal(got, was)
        if first:       # still the empty carry: -inf, 0, 0 exactly
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            assert rel_l2(got.numpy(), ref) <= REL_L2
    # the real block after the masked one gives dense attention's output
    m, l, o = attention._online_block(_to_heads(q), *carry, _to_heads(k),
                                      _to_heads(v), scale)
    if first:
        out = (o / l).transpose(1, 2)
        dense = attention.dense_attention(*map(torch.from_numpy, (q, k, v)))
        assert rel_l2(out.numpy(), dense.numpy()) <= REL_L2
