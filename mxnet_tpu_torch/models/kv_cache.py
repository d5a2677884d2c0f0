"""KV caches: the contiguous lockstep cache and the paged cache.

Counterpart of mxnet_tpu/models/kv_cache.py `KVCache` and
`PagedKVCache`.

`KVCache` is the contiguous lockstep cache of fixed-batch decode
(GPT2ForCausalLM.generate, TransformerNMT's beam search): k/v (L, B, H,
T_max, D) and one scalar length. Its writes land in place and return the
layer's whole (B, H, T_max, D) views.

`PagedKVCache` keeps a static page pool (L, num_pages, page_size, H, D)
per k and v and a per-slot page table (B, pages_per_slot). Its `length`
is a scalar (lockstep mode: every row at the same length, generate's
paged cache, whose `write` / `write_prompt` return the gathered (B, H,
T_max, D) views) or a (B,) vector of live lengths, one per slot (the
ragged mode of continuous batching: writes go through `write_decode`,
each slot appending at its own length, and attention reads the pools
directly through ops.ragged_attention).

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

The host tier's whole-page moves are `gather_kv_pages` /
`scatter_kv_pages`. The reference pads their index to one fixed width
(page 0 for the gather, the out-of-range id num_pages for the scatter,
whose rows XLA's mode="drop" discards) so that each stays one compiled
program. Here the index holds the live page ids only: in the port id
num_pages is the trash page, a real row, and eager torch has no program
to keep.

Lengths stay 0-d / 1-d int32 tensors on the cache's device, as the
reference's, so no write or mask reads a length back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, resolve_device

__all__ = ["KVCache", "PagedKVCache", "gather_kv_pages",
           "scatter_kv_pages"]

_ATTN_IMPLS = ("auto", "torch")


def _host(x):
    return x.cpu() if torch.is_tensor(x) else x


def _sharded(pools):
    return isinstance(pools, (list, tuple))


def gather_kv_pages(k_pages, v_pages, idx, k_scale=None, v_scale=None):
    """Whole pages (rows of the page axis) out of paged pools: the host
    tier's device-to-host read. idx: the page ids to take, a 1-D int
    tensor or sequence. Returns (k, v, ks, vs): k/v (L, n, page_size, H,
    D) copies, ks/vs (L, n, H) float32 scale rows (None on float
    pools). Per-shard pools (lists, one head slice per shard, scales
    None or lists) give the global layout: the shards' heads
    concatenated in shard order, on shard 0's device."""
    if _sharded(k_pages):
        n = len(k_pages)
        parts = [gather_kv_pages(
            k_pages[r], v_pages[r], idx,
            None if k_scale is None else k_scale[r],
            None if v_scale is None else v_scale[r]) for r in range(n)]
        d0 = k_pages[0].device

        def cat(j, axis):
            if parts[0][j] is None:
                return None
            return torch.cat([p[j].to(d0) for p in parts], axis)
        return cat(0, 3), cat(1, 3), cat(2, 2), cat(3, 2)
    idx = torch.as_tensor(idx, dtype=torch.long, device=k_pages.device)
    k = k_pages.index_select(1, idx)
    v = v_pages.index_select(1, idx)
    ks = None if k_scale is None else k_scale.index_select(1, idx)
    vs = None if v_scale is None else v_scale.index_select(1, idx)
    return k, v, ks, vs


def scatter_kv_pages(k_pages, v_pages, idx, k_val, v_val, k_scale=None,
                     v_scale=None, ks_val=None, vs_val=None):
    """Whole pages back into paged pools, in place: the host tier's
    page-in write (the inverse of gather_kv_pages). Values land
    verbatim: int8 codes and their float32 scale rows exactly as
    gathered, never re-quantized, which is what makes a paged-in page
    read the bits a never-evicted one does. idx holds live page ids
    only (no padding rows). Per-shard pools (lists) take values in the
    global head layout, each shard its head slice. Returns (k_pages,
    v_pages, k_scale, v_scale)."""
    if _sharded(k_pages):
        h0 = 0
        for r, kp in enumerate(k_pages):
            h = kp.shape[3]
            dev = kp.device

            def cut(val, axis):
                return None if val is None \
                    else val.narrow(axis, h0, h).to(dev)
            scatter_kv_pages(
                kp, v_pages[r], idx, cut(k_val, 3), cut(v_val, 3),
                None if k_scale is None else k_scale[r],
                None if v_scale is None else v_scale[r],
                cut(ks_val, 2), cut(vs_val, 2))
            h0 += h
        return k_pages, v_pages, k_scale, v_scale
    idx = torch.as_tensor(idx, dtype=torch.long, device=k_pages.device)
    k_pages.index_copy_(1, idx, k_val.to(k_pages.dtype))
    v_pages.index_copy_(1, idx, v_val.to(v_pages.dtype))
    if k_scale is not None and ks_val is not None:
        k_scale.index_copy_(1, idx, ks_val)
        v_scale.index_copy_(1, idx, vs_val)
    return k_pages, v_pages, k_scale, v_scale


class KVCache:
    """Contiguous lockstep cache: k/v of shape (L, B, H, T_max, D) and a
    0-d int32 `length`, the tokens written so far."""

    ragged = False  # contiguous caches are always lockstep

    def __init__(self, k, v, length):
        self.k = k
        self.v = v
        self.length = length

    @classmethod
    def create(cls, num_layers, batch, num_heads, max_length, head_dim,
               dtype=torch.float32, device=None):
        dev = resolve_device(device)
        shape = (num_layers, batch, num_heads, max_length, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))

    @property
    def max_length(self):
        return self.k.shape[3]

    def write(self, layer, k_new, v_new):
        """Write k_new/v_new (B, H, t, D) at offset `length`, in place.
        As lax.dynamic_update_slice, the offset is clamped so that the t
        rows fit. Returns the layer's FULL (B, H, T_max, D) views and the
        cache itself."""
        t = k_new.shape[2]
        start = self.length.long().clamp(max=self.max_length - t)
        idx = start + torch.arange(t, device=self.k.device)
        k_l, v_l = self.k[layer], self.v[layer]
        k_l.index_copy_(2, idx, k_new.to(k_l.dtype))
        v_l.index_copy_(2, idx, v_new.to(v_l.dtype))
        return k_l, v_l, self

    # prefill is the same write (t = prompt length)
    write_prompt = write

    def advance(self, n):
        return KVCache(self.k, self.v, self.length + n)

    def reorder(self, rows):
        """A cache whose batch row i is this cache's row rows[i] (beam
        search's reorder by parent): new buffers, the same length."""
        return KVCache(self.k.index_select(1, rows),
                       self.v.index_select(1, rows), self.length)

    def key_mask(self, extra=0):
        """(T_max,) bool: True for written positions (+ `extra` being
        written this step)."""
        pos = torch.arange(self.max_length, device=self.k.device)
        return pos < (self.length + extra)


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
        """lengths None: a lockstep cache (one scalar length, 0); else
        a ragged one with these (B,) lengths."""
        if kv_dtype not in (None, "int8", torch.int8):
            raise MXNetError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
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
                   torch.zeros((), dtype=torch.int32, device=dev)
                   if lengths is None else
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
        through the page table (a lockstep cache's scalar length stands
        for every slot). Writes past capacity, rows past `spans`
        and writes into pages under `page_lock` are dropped (sent to the
        trash page). A quantized cache stores int8 codes and raises each
        written page's scales with a scatter-max (never lowering one).
        Updates the pools in place; returns self."""
        B, _, t, _ = k_new.shape
        S = self.page_size
        P = self.page_table.shape[1]
        N = self.num_pages
        dev = self.k_pages.device
        pos = self.length.long().reshape(-1, 1).expand(B, 1) \
            + torch.arange(t, device=dev)
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

    def _gather(self, pages, layer, scale=None):
        """The layer's (B, H, T_max, D) view through the page table: a
        fresh gather (num_pages, S, H, D)[table] -> (B, T_max, H, D),
        transposed. int8 pools come back dequantized in float32 with
        each (page, head)'s scale."""
        table = self.page_table.long()
        g = pages[layer][table]
        if scale is not None:
            g = g.float() * scale[layer][table][:, :, None, :, None]
        B, P, S, H, D = g.shape
        return g.reshape(B, P * S, H, D).transpose(1, 2)

    def _views(self, layer):
        return (self._gather(self.k_pages, layer, self.k_scale),
                self._gather(self.v_pages, layer, self.v_scale), self)

    def write(self, layer, k_new, v_new):
        """Lockstep decode write: k_new/v_new (B, H, 1, D) appended at
        `length` (write_decode's scatter; a quantized cache keeps its
        scale bookkeeping there). Returns the gathered (B, H, T_max, D)
        views (dequantized float32 for int8 pools) and the cache. A write
        past capacity is dropped, where the reference's lands on the
        last page; generate never makes one."""
        return self.write_decode(layer, k_new, v_new)._views(layer)

    def write_prompt(self, layer, k, v):
        """Prefill write of a whole (B, H, T, D) chunk at position
        `length` (any offset, through the page table), then the gathered
        views, as write(). Lockstep (scalar-length) caches only; ragged
        slots prefill through the serving engine's write_decode."""
        if self.ragged:
            raise MXNetError("write_prompt needs a lockstep cache "
                             "(scalar length); ragged slots prefill "
                             "individually (serving.ServingEngine)")
        return self.write_decode(layer, k, v)._views(layer)

    def advance(self, n):
        return PagedKVCache(self.k_pages, self.v_pages, self.page_table,
                            self.length + n, page_lock=self.page_lock,
                            spans=self.spans, k_scale=self.k_scale,
                            v_scale=self.v_scale, attn_impl=self.attn_impl)

    def key_mask(self, extra=0):
        """Validity over key positions (+ `extra` being written this
        step): (max_length,) in lockstep mode, (B, max_length) in ragged
        mode."""
        pos = torch.arange(self.max_length, device=self.length.device)
        if self.ragged:
            return pos[None, :] < (self.length + extra)[:, None]
        return pos < (self.length + extra)
