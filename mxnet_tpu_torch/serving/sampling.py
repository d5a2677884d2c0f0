"""Per-slot token sampling for the continuous-batching engine.

Counterpart of mxnet_tpu/serving/sampling.py. Every sampling knob is a
per-slot tensor, so one step serves any mix of greedy and sampled
requests.

`filtered_logits` keeps the reference's definition exactly. The random
draw does not chase JAX's threefry bits: it is Gumbel-max over a
counter-based hash (the murmur3 finalizer of the reference's
`_software_bits`, pallas_attention.py) keyed by (request seed, token
index, vocabulary id), computed on the device. Token i of a request
with seed s depends only on (s, i) — never on the slot, the admission
order or the rest of the batch — so sampled output is reproducible
across schedules, the reference's contract.
"""
from __future__ import annotations

import torch

__all__ = ["filtered_logits", "sample_tokens", "uniforms", "gumbel_draw"]

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    without overflowing int64: split c into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniforms(seeds, counters, vocab_size, tag=None):
    """(B, V) float32 uniforms in (0, 1), a pure function of each row's
    (seed, counter) and the column index. `tag` (a small int) selects a
    further stream of the same (seed, counter): the speculative verify
    draws its accept uniform from tag 1 and its residual sample from
    tag 2, the counterparts of the reference's fold_in(key, 1) and
    fold_in(key, 2). Without a tag the bits are the sampler's own."""
    dev = seeds.device
    s = _mix(seeds.long()[:, None] & _M32)
    if tag is not None:
        s = _mix(s ^ _mul32(torch.full_like(s, int(tag)), 0x9E3779B9))
    c = counters.long()[:, None] & _M32
    v = torch.arange(vocab_size, device=dev, dtype=torch.int64)[None, :]
    bits = _mix(_mix(v ^ s) ^ c)
    # 23 bits: k + 0.5 is exact in float32, so u stays strictly below 1
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled (B, V) logits with the top-k/top-p filter
    applied: cut tokens are -inf, survivors keep their scaled value, so
    softmax over the result IS the sampling distribution.

    temperature: (B,) f32 (> 0). top_k: (B,) int, <= 0 disables.
    top_p: (B,) f32, >= 1 disables (a true no-op). The top-1 token
    always survives.
    """
    logits = logits.float()
    B, V = logits.shape
    scaled = logits / temperature.float().clamp_min(1e-6)[:, None]
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    ranks = torch.arange(V, device=logits.device)[None, :]
    cut_sorted = (ranks >= top_k[:, None]) & (top_k > 0)[:, None]
    # nucleus: cut token i only if the mass STRICTLY before it already
    # exceeds top_p — the top-1 token always survives (even top_p=0)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cut_sorted |= ((cum - probs) > top_p[:, None]) & (top_p < 1.0)[:, None]
    cut = torch.zeros_like(cut_sorted).scatter(1, sort_idx, cut_sorted)
    return torch.where(cut, torch.full_like(scaled, float("-inf")), scaled)


def sample_tokens(logits, seeds, counters, do_sample, temperature, top_k,
                  top_p):
    """One token per slot from (B, V) logits: greedy rows (do_sample
    False) take the argmax of the RAW logits; sampled rows draw from
    softmax(filtered_logits) by Gumbel-max on `uniforms`. Returns (B,)
    int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    filtered = filtered_logits(logits, temperature, top_k, top_p)
    sampled = gumbel_draw(filtered, seeds, counters)
    return torch.where(do_sample, sampled, greedy).to(torch.int32)


def gumbel_draw(filtered, seeds, counters, tag=None):
    """One draw per row from softmax(filtered) (a (B, V) result of
    filtered_logits) by Gumbel-max on the `uniforms` stream (seed,
    counter, tag). Returns (B,) int64."""
    u = uniforms(seeds, counters, filtered.shape[-1], tag)
    return torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
