"""Paged KV cache, ragged mode: the serving engine's cache.

Counterpart of mxnet_tpu/models/kv_cache.py `PagedKVCache`. A static
page pool (L, num_pages, page_size, H, D) per k and v, a per-slot page
table (B, pages_per_slot), and a (B,) vector of live lengths, one per
slot (the ragged mode of continuous batching). Writes go through
`write_decode` (each slot appends at its own length) and attention reads
the pools directly through ops.ragged_attention.

Quantized pages (`kv_dtype="int8"`): int8 code pools plus float32
per-(layer, page, head) scale leaves `k_scale`/`v_scale`. Writes quantize
against a MONOTONE scale — position i's scale is the larger of its
page's current scale and the running same-page absmax / 127 through i —
so written codes are never re-rounded and are a pure function of the
token stream, whatever the chunking. Attention dequantizes each page
where it reads it (the int8 span kernel, or the plain version on the
gathered view).

Differences from the JAX class, both deliberate:

  * The pools carry ONE extra page at index num_pages, the trash page.
    torch's index_put_ has no drop mode, so every write the reference
    drops (positions past capacity, rows past `spans`, pages under
    `page_lock`) is routed there instead; no page table ever names it,
    so it is never read. `num_pages` excludes it.
  * `write_decode` updates the pools IN PLACE and returns the cache
    itself (JAX returns a new pytree); the serving engine owns the
    pools for its whole life, so nothing needs the old values.

Not ported yet (they raise): the lockstep (scalar length) write and
write_prompt, the contiguous KVCache, and the host tier's whole-page
gather/scatter (gather_kv_pages / scatter_kv_pages).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, not_ported, resolve_device

__all__ = ["KVCache", "PagedKVCache"]

_ATTN_IMPLS = ("auto", "torch")


def _host(x):
    return x.cpu() if torch.is_tensor(x) else x


class KVCache:
    """The reference's contiguous lockstep cache: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("KVCache (the contiguous lockstep cache)")

    @classmethod
    def create(cls, *args, **kwargs):
        raise not_ported("KVCache (the contiguous lockstep cache)")


class PagedKVCache:
    def __init__(self, k_pages, v_pages, page_table, length,
                 page_lock=None, spans=None, k_scale=None, v_scale=None,
                 attn_impl="auto"):
        if attn_impl not in _ATTN_IMPLS:
            raise MXNetError(f"attn_impl must be one of {_ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.page_table = page_table
        self.length = length
        # optional (num_pages,) bool: True = the page must not be written
        # (shared, cached or free); writes aimed at it are dropped
        self.page_lock = page_lock
        # optional (B,) int32: live query rows per slot in the current
        # dispatch (decode 1, prefill chunk C, idle 0); dead rows neither
        # write KV nor attend
        self.spans = spans
        # optional (L, num_pages + 1, H) f32: per-(page, head) dequant
        # scales of int8 pools (the last row belongs to the trash page);
        # None on float caches
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.attn_impl = attn_impl

    @classmethod
    def create(cls, num_layers, batch, num_heads, max_length, head_dim,
               dtype=torch.float32, page_size=64, num_pages=None,
               page_table=None, lengths=None, attn_impl="auto",
               kv_dtype=None, device=None):
        if kv_dtype not in (None, "int8", torch.int8):
            raise MXNetError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if lengths is None:
            raise not_ported("the lockstep (scalar length) PagedKVCache")
        dev = resolve_device(device)
        if max_length % page_size:
            raise MXNetError(
                f"max_length {max_length} not a multiple of page_size "
                f"{page_size}")
        per_seq = max_length // page_size
        if num_pages is None:
            num_pages = batch * per_seq
        if page_table is None:
            if num_pages < batch * per_seq:
                raise MXNetError(
                    f"{num_pages} pages < {batch}x{per_seq} required")
            tbl = np.arange(batch * per_seq).reshape(batch, per_seq)
        else:
            tbl = np.asarray(_host(page_table))
            if tbl.size and (tbl.min() < 0 or tbl.max() >= num_pages):
                raise MXNetError(
                    f"page_table references pages outside the pool: "
                    f"entries span [{int(tbl.min())}, {int(tbl.max())}] "
                    f"but only pages [0, {num_pages}) exist")
        # + 1: the trash page that dropped writes land in
        shape = (num_layers, num_pages + 1, page_size, num_heads, head_dim)
        store = dtype if kv_dtype is None else torch.int8
        scales = (None, None)
        if kv_dtype is not None:
            sshape = (num_layers, num_pages + 1, num_heads)
            scales = (torch.zeros(sshape, dtype=torch.float32, device=dev),
                      torch.zeros(sshape, dtype=torch.float32, device=dev))
        return cls(torch.zeros(shape, dtype=store, device=dev),
                   torch.zeros(shape, dtype=store, device=dev),
                   torch.as_tensor(tbl, dtype=torch.int32, device=dev),
                   torch.as_tensor(_host(lengths), dtype=torch.int32,
                                   device=dev),
                   k_scale=scales[0], v_scale=scales[1],
                   attn_impl=attn_impl)

    @property
    def quantized(self):
        return self.k_scale is not None

    @property
    def ragged(self):
        return self.length.dim() == 1

    @property
    def num_pages(self):
        return self.k_pages.shape[1] - 1

    @property
    def page_size(self):
        return self.k_pages.shape[2]

    @property
    def max_length(self):
        return self.page_table.shape[1] * self.page_size

    def _quant_encode(self, x_t, pages, page_idx, scale, layer):
        """Quantize an append chunk against the monotone page scales.

        x_t (B, t, H, D) float activations; pages (B, t) physical page
        per position (num_pages = the trash page: a dropped row);
        page_idx (B, t) logical page per position; scale the (L, N + 1,
        H) leaf. Position i's scale is max(old page scale, running
        same-page absmax * (1/127) through i) — a running max, not the
        chunk max, so the codes of given values do not depend on how the
        stream was cut into chunks. Dropped rows count as 0 and cannot
        raise a live page's scale. Returns (codes int8 (B, t, H, D),
        scale used f32 (B, t, H))."""
        N = self.num_pages
        xf = x_t.float()
        live = pages < N                               # (B, t)
        a = xf.abs().amax(dim=-1)                      # (B, t, H)
        a = torch.where(live[..., None], a, torch.zeros_like(a))
        t = x_t.shape[1]
        i = torch.arange(t, device=x_t.device)
        same = (page_idx[:, :, None] == page_idx[:, None, :]) \
            & (i[None, :, None] >= i[None, None, :])   # (B, i, j): j <= i
        run = torch.where(same[..., None], a[:, None, :, :],
                          torch.zeros((), device=a.device)).amax(dim=2)
        s_old = scale[layer][pages]            # dropped rows read the trash
        s_old = torch.where(live[..., None], s_old, torch.zeros_like(s_old))
        s = torch.maximum(s_old, run * (1.0 / 127.0))
        q = torch.where(s[..., None] > 0, xf / s[..., None],
                        torch.zeros_like(xf))
        q = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
        return q, s

    def write_decode(self, layer, k_new, v_new):
        """Each slot appends its rows at its OWN length: k_new/v_new
        (B, H, t, D), row j of slot b lands at position length[b] + j
        through the page table. Writes past capacity, rows past `spans`
        and writes into pages under `page_lock` are dropped (sent to the
        trash page). A quantized cache stores int8 codes and raises each
        written page's scales with a scatter-max (never lowering one).
        Updates the pools in place; returns self."""
        if not self.ragged:
            raise not_ported("the lockstep (scalar length) cache write")
        B, _, t, _ = k_new.shape
        S = self.page_size
        P = self.page_table.shape[1]
        N = self.num_pages
        dev = self.k_pages.device
        pos = self.length[:, None].long() + torch.arange(t, device=dev)
        page_idx = torch.div(pos, S, rounding_mode="floor")
        slot = pos - page_idx * S
        safe = torch.gather(self.page_table.long(), 1,
                            page_idx.clamp(max=P - 1))
        trash = torch.full_like(safe, N)
        pages = torch.where(page_idx < P, safe, trash)
        if self.spans is not None:
            live = torch.arange(t, device=dev)[None, :] \
                < self.spans[:, None]
            pages = torch.where(live, pages, trash)
        if self.page_lock is not None:
            locked = self.page_lock[pages.clamp(max=N - 1)] & (pages < N)
            pages = torch.where(locked, trash, pages)
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        k_t, v_t = k_new.transpose(1, 2), v_new.transpose(1, 2)
        if self.quantized:
            qk, sk = self._quant_encode(k_t, pages, page_idx,
                                        self.k_scale, layer)
            qv, sv = self._quant_encode(v_t, pages, page_idx,
                                        self.v_scale, layer)
            kp[pages, slot] = qk
            vp[pages, slot] = qv
            # scatter-max: duplicate pages of one chunk keep the largest,
            # and an existing scale is never lowered
            flat, H = pages.reshape(-1), sk.shape[-1]
            self.k_scale[layer].index_reduce_(0, flat, sk.reshape(-1, H),
                                              "amax", include_self=True)
            self.v_scale[layer].index_reduce_(0, flat, sv.reshape(-1, H),
                                              "amax", include_self=True)
            return self
        kp[pages, slot] = k_t.to(kp.dtype)
        vp[pages, slot] = v_t.to(vp.dtype)
        return self

    def write(self, *args, **kwargs):
        raise not_ported("PagedKVCache.write (the lockstep decode write)")

    def write_prompt(self, *args, **kwargs):
        raise not_ported("PagedKVCache.write_prompt (the lockstep prefill)")

    def advance(self, n):
        return PagedKVCache(self.k_pages, self.v_pages, self.page_table,
                            self.length + n, page_lock=self.page_lock,
                            spans=self.spans, k_scale=self.k_scale,
                            v_scale=self.v_scale, attn_impl=self.attn_impl)

    def key_mask(self, extra=0):
        """(B, max_length) bool: True for written positions (+ `extra`
        being written this step)."""
        pos = torch.arange(self.max_length, device=self.length.device)
        return pos[None, :] < (self.length + extra)[:, None]
