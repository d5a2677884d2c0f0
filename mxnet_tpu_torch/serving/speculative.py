"""Speculative decoding without a draft model: prompt-lookup drafting
plus distribution-preserving verification in the dispatch.

Counterpart of mxnet_tpu/serving/speculative.py. The two halves:

  * PromptLookupProposer (host numpy, the reference's as it is): match
    the last n-gram of a request's own history against its earlier
    occurrences and draft the continuation of the earliest match. A
    pure function of that history, so drafts never depend on the slot,
    the schedule or the rest of the batch.
  * verify_tokens (torch, on the device): one multi-row forward has
    produced logits for positions [current token, draft_1 ..
    draft_{S-1}]; acceptance walks the drafts left to right.
      - greedy rows accept draft j+1 iff it equals argmax(logits_j), so
        the emitted tokens are exactly the speculation-off greedy
        stream.
      - sampled rows run speculative rejection sampling against the
        filtered distribution p_j (sampling.filtered_logits). The
        proposal is a point mass, so draft d is accepted with
        probability p_j(d), and a rejection draws from p_j with d
        removed: the emitted marginal is exactly p_j.

Random streams: the port's sampler is a counter hash, not threefry, so
sampled streams do not match the reference bit for bit; the reference's
contract holds in the port's own streams. The token at request-stream
index i takes its accept uniform from `uniforms(seed, i, tag=1)` and its
residual draw from tag 2, and a position with no draft draws exactly
what `sample_tokens` draws for index i, so a dispatch with zero drafts
is bit-identical to the speculation-off sampler.
"""
from __future__ import annotations

import numpy as np
import torch

from .sampling import filtered_logits, gumbel_draw, uniforms

__all__ = ["PromptLookupProposer", "verify_tokens"]


class PromptLookupProposer:
    """Draft up to `max_draft` tokens by n-gram lookup over a history.

    Tries n-gram sizes from `max_ngram` down to `min_ngram`: take the
    last n tokens, find their EARLIEST earlier occurrence (the earliest
    match leaves the longest continuation), and draft the tokens that
    followed it. Stateless: propose() is a pure function of the history
    it is handed.
    """

    def __init__(self, max_draft, max_ngram=3, min_ngram=1):
        if max_draft < 1:
            raise ValueError("max_draft must be >= 1")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_draft = int(max_draft)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history):
        """history: 1-D int sequence (prompt + emitted so far). Returns
        an int32 array of 0..max_draft draft tokens (empty = no match)."""
        h = np.asarray(history, np.int32)
        n = h.size
        for k in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pat = h[n - k:]
            windows = np.lib.stride_tricks.sliding_window_view(h[:-1], k)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if hits.size:
                start = int(hits[0]) + k
                return h[start:start + self.max_draft].copy()
        return np.zeros((0,), np.int32)


def verify_tokens(logits, drafts, n_draft, seeds, counters, do_sample,
                  temperature, top_k, top_p, greedy_only=False):
    """Verify one speculative dispatch.

    logits (B, S, V): position j conditions on [current token, draft_1
    .. draft_j]. drafts (B, S-1) int (padding past n_draft ignored);
    n_draft (B,) live drafts per slot, 0..S-1. The per-slot sampling
    state as in sample_tokens; counters = the request-stream index of
    the FIRST token this dispatch emits. greedy_only: no slot samples,
    so skip the filtered distribution and the draws (greedy rows are
    the same either way).

    Returns (emitted (B, S) int32, n_acc (B,) int32): the token the slot
    would emit at each position (valid through position n_acc) and the
    leading drafts accepted. The caller emits emitted[:, :n_acc + 1].
    """
    B, S, V = logits.shape
    dev = logits.device
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)       # (B, S)
    cand = torch.cat([drafts.to(torch.int32),
                      torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                     dim=1)
    pos = torch.arange(S, device=dev)[None, :]
    is_draft = pos < n_draft[:, None]
    if greedy_only:
        chain = torch.cumprod(((cand == greedy) & is_draft).to(torch.int32),
                              dim=1)
        return greedy, chain.sum(dim=1).to(torch.int32)
    rep = lambda x: x.repeat_interleave(S)                      # noqa: E731
    filt = filtered_logits(logits.reshape(B * S, V), rep(temperature),
                           rep(top_k), rep(top_p))
    probs = torch.softmax(filt, dim=-1)
    flat_cand = cand.reshape(-1).long()
    p_cand = probs.gather(1, flat_cand[:, None])[:, 0].reshape(B, S)
    # position j of slot b draws from the stream element of token index
    # counters[b] + j
    s = rep(seeds)
    c = (counters[:, None] + pos).reshape(-1).to(counters.dtype)
    # point-mass proposal: accept with the target mass of the draft
    u = uniforms(s, c, 1, tag=1)[:, 0].reshape(B, S)
    accept = torch.where(do_sample[:, None], u < p_cand, cand == greedy)
    chain = torch.cumprod((accept & is_draft).to(torch.int32), dim=1)
    n_acc = chain.sum(dim=1).to(torch.int32)
    # a rejection at j samples the residual: p_j with the draft removed
    # (a reject implies p_j(draft) < 1, so a finite entry remains)
    resid_logits = filt.scatter(1, flat_cand[:, None], float("-inf"))
    resid = gumbel_draw(resid_logits, s, c, tag=2).reshape(B, S)
    # no draft at j: the plain sample of index counters + j
    full = gumbel_draw(filt, s, c).reshape(B, S)
    sampled = torch.where(pos < n_acc[:, None], cand.long(),
                          torch.where(is_draft, resid, full))
    emitted = torch.where(do_sample[:, None], sampled.to(torch.int32),
                          greedy)
    return emitted, n_acc
