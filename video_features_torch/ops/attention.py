"""Attention over (B, S, H, D) tensors: dense and blockwise (port of
``video_features_tpu/ops/attention.py``'s single-device functions).

  * :func:`dense_attention`: softmax(QKᵀ·scale)V, the softmax in fp32;
  * :func:`blockwise_attention`: an online softmax over KV blocks (512
    by default), O(S·block) score memory instead of O(S²); a ragged S
    pads the keys to a block multiple and masks the padded ones out.

  * :func:`ring_attention`: sequence parallel over several devices, each
    holding one shard of the queries, the key/value shards moving one hop
    around the ring per step.

All are plain batched matmuls and ``torch.softmax``/``torch.exp`` left
to cuBLAS and torch's elementwise kernels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(QKᵀ·scale)V over (B, S, H, D) tensors."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, D)
    s = (qh @ kh.transpose(-1, -2)) * _scale(q, scale)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return (p @ vh).transpose(1, 2)


def _online_block(q: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  o: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
                  scale: float, valid: Optional[torch.Tensor] = None) -> Carry:
    """One online-softmax step against the KV block (kb, vb).

    The carry is (m, l, o) in (B, H, Sq, 1), (B, H, Sq, 1), (B, H, Sq,
    D), fp32; ``q`` is (B, H, Sq, D) and ``kb``, ``vb`` are (B, H, block,
    D). ``valid`` (block,) bool masks padded keys out (scores → -inf, so
    p → 0); a block with no valid key leaves the carry as it was.
    """
    s = (q @ kb.transpose(-1, -2)).float() * scale
    if valid is not None:
        s = s.masked_fill(~valid, float('-inf'))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # m_new stays -inf until the first unmasked key; exponentiate against
    # a finite stand-in so exp(-inf - -inf) never makes a NaN: p and alpha
    # are then exactly 0 and the carry passes through unchanged
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe)
    alpha = torch.exp(m - m_safe)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha + p @ vb.float()
    return m_new, l_new, o_new


def _online_init(q: torch.Tensor) -> Carry:
    """The empty carry for (B, H, Sq, D) queries."""
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq, 1), float('-inf'), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    return m, l, o


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient attention over (B, S, H, D) tensors: a loop over
    KV blocks with a running (max, denominator, output).

    A ragged S (a ViT's grid² + 1 tokens) zero-pads the keys and values
    to a block multiple and masks the padded keys out of the softmax.
    """
    sk = k.shape[1]
    block_size = min(block_size, sk)
    pad = (-sk) % block_size
    sc = _scale(q, scale)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, D)
    if pad:
        kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
        vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    valid = torch.arange(sk + pad, device=q.device) < sk
    carry = _online_init(qh)
    for start in range(0, sk + pad, block_size):
        blk = slice(start, start + block_size)
        mask = valid[blk] if start + block_size > sk else None
        carry = _online_block(qh, *carry, kh[:, :, blk], vh[:, :, blk], sc,
                              valid=mask)
    _, l, o = carry
    return (o / l).to(q.dtype).transpose(1, 2)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], scale: Optional[float] = None,
                   kv_valid: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """Sequence-parallel attention over n shards, shard i of q, k, v a
    (B, S/n, H, D) tensor on device i (a device may hold several shards).

    Each device keeps its queries and an online-softmax carry; the key and
    value shards, with their validity masks, move one hop around the ring
    per step (device j's to device j+1, as the JAX package's
    ``lax.ppermute``), so after n steps every query has attended every
    key. ``kv_valid[i]`` (S/n,) bool masks shard i's padded keys out of
    every softmax (it travels with its shard): how a ragged token count
    shards. Rows of padded queries come out as garbage; slice them off.
    Returns the n output shards, each on its query's device.
    """
    n = len(qs)
    sc = _scale(qs[0], scale)
    qh = [q.transpose(1, 2) for q in qs]                    # (B, H, S/n, D)
    kb = [k.transpose(1, 2) for k in ks]
    vb = [v.transpose(1, 2) for v in vs]
    mb = (list(kv_valid) if kv_valid is not None else
          [torch.ones(k.shape[1], dtype=torch.bool, device=k.device) for k in ks])
    carries = [_online_init(q) for q in qh]
    for step in range(n):
        carries = [_online_block(qh[i], *carries[i], kb[i], vb[i], sc,
                                 valid=mb[i]) for i in range(n)]
        if step == n - 1:
            break                      # the last block needs no send
        devices = [q.device for q in qh]
        kb, vb, mb = ([t[(i - 1) % n].to(devices[i], non_blocking=True)
                       for i in range(n)] for t in (kb, vb, mb))
    return [(o / l).to(q.dtype).transpose(1, 2)
            for (_, l, o), q in zip(carries, qs)]
