"""Ring attention over the shards of a sequence axis.

Counterpart of mxnet_tpu/ops/attention.py `ring_attention_data`. The
reference runs it per device inside a shard_map, rotating each device's
K/V block (and its key-padding block) around the ring with
lax.ppermute and combining the hops with an online softmax. Here one
process holds every shard's blocks as a list (parallel/collectives.py)
and runs the same hops on each in turn: the math of a hop is the
reference's, in float32, with causal masking on global positions (the
sequence is sharded contiguously: shard i holds positions
[i*T_local, (i+1)*T_local)) and rows with no valid key so far
contributing zero, so a fully masked row yields zeros.
"""
from __future__ import annotations

import math

import torch

from ..parallel import collectives as _coll

__all__ = ["ring_attention_data", "NEG_INF"]

NEG_INF = -1e30


def ring_attention_data(qs, ks, vs, causal=False, scale=None, masks=None,
                        devices=None):
    """Ring attention over per-shard blocks: qs, ks, vs lists of
    (B, H, T_local, D), masks None or a list of (B, T_local) bool
    (True = attend). Returns the per-shard outputs (q's dtype)."""
    n = len(qs)
    devices = [q.device for q in qs] if devices is None else devices
    B, H, T, D = qs[0].shape
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    perm = [(i, (i + 1) % n) for i in range(n)]
    q32 = [q.float() for q in qs]
    acc = [torch.zeros((B, H, T, D), dtype=torch.float32, device=d)
           for d in devices]
    row_max = [torch.full((B, H, T), NEG_INF, dtype=torch.float32,
                          device=d) for d in devices]
    row_sum = [torch.zeros((B, H, T), dtype=torch.float32, device=d)
               for d in devices]
    k_cur, v_cur, m_cur = list(ks), list(vs), \
        (list(masks) if masks is not None else None)
    for hop in range(n):
        for i in range(n):
            src = (i - hop) % n  # whose block shard i holds now
            logits = torch.einsum("bhqd,bhkd->bhqk", q32[i],
                                  k_cur[i].float()) * s
            if causal:
                qpos = i * T + torch.arange(T, device=devices[i])
                kpos = src * T + torch.arange(T, device=devices[i])
                cm = qpos[:, None] >= kpos[None, :]
                logits = torch.where(cm, logits, NEG_INF)
            if m_cur is not None:
                logits = torch.where(m_cur[i][:, None, None, :], logits,
                                     NEG_INF)
            new_max = torch.maximum(row_max[i], logits.amax(dim=-1))
            corr = torch.exp(row_max[i] - new_max)
            dead = new_max <= NEG_INF / 2
            p = torch.where(dead[..., None], 0.0,
                            torch.exp(logits - new_max[..., None]))
            row_sum[i] = row_sum[i] * corr + p.sum(dim=-1)
            acc[i] = acc[i] * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v_cur[i].float())
            row_max[i] = new_max
        if hop < n - 1:
            k_cur = _coll.ppermute(k_cur, perm, devices)
            v_cur = _coll.ppermute(v_cur, perm, devices)
            if m_cur is not None:
                m_cur = _coll.ppermute(m_cur, perm, devices)
    return [(a / torch.clamp(rs[..., None], min=1e-30)).to(q.dtype)
            for a, rs, q in zip(acc, row_sum, qs)]
