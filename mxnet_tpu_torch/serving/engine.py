"""Continuous-batching serving engine: one fixed-shape step per dispatch.

Counterpart of mxnet_tpu/serving/engine.py `ServingEngine`, core path.
Each dispatch packs every active slot's work into ONE (B, W) token grid
— a prefill chunk (up to chunk_tokens prompt tokens), a decode token,
or nothing (idle) — and runs GPT2ForCausalLM.forward over the ragged
paged KV cache with the per-slot live row counts as `spans`. Dead rows
write no KV and attend nothing (the span attention kernel gives exact
zeros for them), so what a slot does is data, never a shape: the step
shape (B, W) is fixed for the engine's life, which is what lets a later
change capture the step as a CUDA graph.

Per-slot state (lengths, current token, budgets, sampling knobs, page
table) stays on the device between dispatches; the host uploads a slot's
row on admission and release (`_sync_slot`) and fetches the small
results back with ONE device-to-host copy per dispatch.

Not ported yet (constructor options raise, see _NOT_PORTED): prefix
cache, speculative decoding, LoRA adapters, int8 KV pages, w8 weights,
tensor parallelism, the host KV tier, shedding policy, the dispatch
supervisor (an exception in a dispatch propagates), request deadlines,
cancel/migration, streaming and telemetry.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..analysis import loop_only
from ..base import MXNetError, not_ported, resolve_device
from ..models.gpt2 import _DTYPES
from ..models.kv_cache import PagedKVCache
from .page_pool import PagePool
from .sampling import sample_tokens
from .scheduler import QueueFullError, Request, SlotScheduler

__all__ = ["ServingEngine"]

# JAX-engine options this port does not cover yet, with the default that
# means "off"; any other value raises
_NOT_PORTED = {
    "prefix_cache": False, "prefix_cache_pages": None,
    "speculative": False, "spec_tokens": 4, "spec_max_ngram": 3,
    "spec_min_ngram": 1, "policy": None, "max_retries": 3,
    "retry_backoff_s": 0.02, "adapter_pool": None, "kv_dtype": None,
    "hbm_budget_bytes": None, "host_kv_bytes": None, "tp": 1,
    "tp_devices": None, "weight_dtype": None,
    "hbm_budget_includes_weights": False, "clock": None,
    "tenant_quotas": None,
}

# per-slot state mirrored on the device, in the order of the host arrays
_SLOT_STATE = ("lengths", "cur_tok", "done", "remaining", "counters",
               "seeds", "temp", "top_k", "top_p", "do_sample", "eos")


class ServingEngine:
    """Continuous-batching generation over a GPT2ForCausalLM.

    num_slots: concurrent sequences (the step's batch B). max_length:
    per-slot KV capacity (prompt + generated), rounded down to whole
    pages; defaults to the model's max_length. chunk_tokens: prompt
    tokens one slot feeds per dispatch (default page_size); the step
    width is W = max(chunk_tokens, 2). prefill_chunk_budget: prompt
    tokens per dispatch across all slots (default chunk_tokens),
    round-robined over the slots. decode_block / prefill_bucket are
    accepted and ignored, as in the reference. attn_impl: 'auto' (the
    CUDA kernels on the card, the plain versions on the CPU) or 'torch'
    (the plain versions anywhere). dtype: KV page dtype
    (default: the model's). device: default the CUDA card (raises
    without one); it must be the model's device.
    """

    def __init__(self, model, num_slots, max_length=None, page_size=64,
                 decode_block=None, attn_impl="auto", prefill_bucket=None,
                 chunk_tokens=None, prefill_chunk_budget=None, dtype=None,
                 max_queue=None, num_priorities=3, device=None,
                 **options):
        for key, value in options.items():
            if key not in _NOT_PORTED:
                raise TypeError(f"ServingEngine() got an unexpected "
                                f"keyword argument {key!r}")
            if value != _NOT_PORTED[key]:
                raise not_ported(f"ServingEngine({key}=...)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise MXNetError(f"the model lives on {model.device}, the "
                             f"engine on {self.device}")
        # float32 means float32 on the card: no TF32 in matrix products
        # or convolutions (the comparisons with the reference rely on it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        cfg = model.config
        self.num_slots = B = int(num_slots)
        max_length = int(max_length or cfg.max_length)
        max_length -= max_length % page_size
        if max_length < page_size:
            raise MXNetError(f"max_length {max_length} < one page "
                             f"({page_size})")
        if max_length > cfg.max_length:
            raise MXNetError(f"max_length {max_length} exceeds the "
                             f"model's position range {cfg.max_length}")
        self.max_length = max_length
        self.page_size = int(page_size)
        self.decode_block = decode_block
        self.prefill_bucket = prefill_bucket
        self.attn_impl = attn_impl
        self.chunk_tokens = int(chunk_tokens or page_size)
        if self.chunk_tokens < 1:
            raise MXNetError("chunk_tokens must be >= 1")
        self.prefill_chunk_budget = int(
            prefill_chunk_budget or self.chunk_tokens)
        if self.prefill_chunk_budget < 1:
            raise MXNetError("prefill_chunk_budget must be >= 1")
        # ONE dispatch width forever; >= 2 keeps every dispatch on the
        # span kernel
        self._width = max(self.chunk_tokens, 2)
        self.scheduler = SlotScheduler(B, max_queue=max_queue,
                                       num_priorities=num_priorities)

        P = self._pages_per_slot = max_length // page_size
        dt = _DTYPES[dtype] if isinstance(dtype, str) \
            else (dtype or model.dtype)
        self.kv_dtype = str(dt).replace("torch.", "")
        L, H = cfg.num_layers, cfg.num_heads
        Dh = cfg.units // cfg.num_heads
        page_bytes = 2 * L * page_size * H * Dh * dt.itemsize
        # every slot can always claim its full P exclusive pages
        pools = PagedKVCache.create(
            L, B, H, max_length, Dh, dtype=dt, page_size=page_size,
            lengths=np.zeros(B), attn_impl=attn_impl, device=self.device)
        self._kp, self._vp = pools.k_pages, pools.v_pages
        self.page_pool = PagePool(B * P, page_bytes=page_bytes)

        # host copies of the per-slot state. Unmapped slots park at
        # length == max_length: a stray write of theirs falls off the
        # page table and is dropped
        self._table_host = np.zeros((B, P), np.int32)
        self._mapped = np.zeros(B, bool)
        self._lengths = np.full(B, self.max_length, np.int32)
        self._cur_tok = np.zeros(B, np.int32)
        self._done = np.ones(B, bool)
        self._remaining = np.zeros(B, np.int32)
        self._counters = np.zeros(B, np.int32)
        self._seeds = np.zeros(B, np.int32)
        self._temp = np.ones(B, np.float32)
        self._top_k = np.zeros(B, np.int32)
        self._top_p = np.ones(B, np.float32)
        self._do_sample = np.zeros(B, bool)
        self._eos = np.full(B, -1, np.int32)
        # per-slot chunk queues: the not-yet-fed tail of each admitted
        # prompt (None = no prefill work), drained chunk_tokens at a time
        # under prefill_chunk_budget from a rotating slot cursor
        self._pending = [None] * B
        self._chunk_rr = 0
        self._dstate = {name: self._upload(getattr(self, "_" + name))
                        for name in _SLOT_STATE}
        self._dstate["table"] = self._upload(self._table_host)
        self._d_lock = self._upload(self._page_lock_host())
        self.stats = {"prefills": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "decode_dispatches": 0,
                      "tokens_emitted": 0, "requests_finished": 0}

    def _upload(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # -- public API --------------------------------------------------------
    @loop_only
    def submit(self, request):
        """Queue a Request. An over-long prompt raises; a full admission
        queue raises QueueFullError with request.status == "shed"."""
        if request.prompt_len > self.max_length:
            raise MXNetError(
                f"prompt of {request.prompt_len} tokens exceeds slot "
                f"capacity {self.max_length}")
        if request.adapter_id not in (None, 0):
            raise not_ported("LoRA adapters (Request.adapter_id)")
        if request.deadline_ms is not None:
            raise not_ported("request deadlines (Request.deadline_ms)")
        request.t_submit = time.perf_counter()
        request.output_tokens = []
        try:
            out = self.scheduler.submit(request)
        except QueueFullError:
            request.status = "shed"
            raise
        request.status = "queued"
        return out

    @property
    def has_work(self):
        return self.scheduler.has_work

    @loop_only
    def step(self):
        """One scheduling round: admit free slots (queue their prompt
        chunks), run ONE dispatch, free finished slots. Returns the
        requests that finished this round."""
        for slot, req in self.scheduler.admit(time.perf_counter()):
            self._admit(slot, req)
        if not self.scheduler.num_active:
            return []
        return self._dispatch()

    @loop_only
    def serve(self, requests=()):
        """Submit `requests`, run until the queue and every slot drain,
        and return every terminal request in submission order (finished,
        or shed by a full queue)."""
        done = []
        for r in requests:
            try:
                self.submit(r)
            except QueueFullError:
                done.append(r)
        while self.has_work:
            done.extend(self.step())
        done.sort(key=lambda r: r.t_submit)
        return done

    def generate(self, prompts, max_new_tokens, **request_kw):
        """Serve `prompts` with shared settings; their token lists in
        order."""
        reqs = [Request(p, max_new_tokens, **request_kw) for p in prompts]
        self.serve(reqs)
        return [r.output_tokens for r in reqs]

    # -- slots and pages ---------------------------------------------------
    def _sync_slot(self, slot):
        """Upload one slot's host state, its page-table row and the
        pool's page_lock mask (all change together) to the device."""
        d = self._dstate
        for name in _SLOT_STATE:
            d[name][slot] = getattr(self, "_" + name)[slot].item()
        d["table"][slot] = self._upload(self._table_host[slot])
        self._d_lock = self._upload(self._page_lock_host())

    def _page_lock_host(self):
        """(num_pages,) bool: True = no write may land in this page. Only
        pages a slot holds exclusively (refcount 1) are writable."""
        return self.page_pool.refcounts() != 1

    def _map_slot_pages(self, slot):
        """Give the slot its P exclusive pages. (The reference also
        longest-prefix-matches the prompt against the prefix cache,
        which is not ported: prefill always starts at position 0.)"""
        fresh = self.page_pool.alloc(self._pages_per_slot)
        self._table_host[slot] = np.asarray(fresh, np.int32)
        self._mapped[slot] = True

    def _free_slot_pages(self, slot):
        if not self._mapped[slot]:
            return
        row = [int(p) for p in self._table_host[slot]]
        self.page_pool.free(self.page_pool.decref(row))
        self._mapped[slot] = False

    def _admit(self, slot, req):
        """Map pages and park the prompt as this slot's chunk queue; no
        forward runs here. The dispatch streams the queue chunk_tokens at
        a time beside everyone else's decode rows and samples the first
        token when the final chunk lands."""
        self._map_slot_pages(slot)
        req.status = "prefilling"
        Tp = req.prompt_len
        # every decode step writes one KV and the last sampled token is
        # never written, so a sequence of Tp supports up to
        # max_length - Tp + 1 generated tokens
        self._pending[slot] = np.asarray(req.prompt, np.int32)
        self._lengths[slot] = 0
        self._cur_tok[slot] = 0
        self._remaining[slot] = min(req.max_new_tokens,
                                    self.max_length - Tp + 1)
        self._counters[slot] = 0
        self._seeds[slot] = req.seed
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        self._do_sample[slot] = req.do_sample
        self._eos[slot] = -1 if req.eos_token_id is None \
            else req.eos_token_id
        self._done[slot] = False
        self._sync_slot(slot)

    def _release_slot(self, slot):
        """Free a slot: scheduler slot back to the pool, page leases
        released, its writes parked past the table (length = max_length)
        so the recycled pages cannot be touched."""
        req = self.scheduler.release(slot)
        req.t_finish = time.perf_counter()
        self._pending[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        self._lengths[slot] = self.max_length
        self._free_slot_pages(slot)
        self._sync_slot(slot)
        return req

    def _finish(self, slot):
        req = self._release_slot(slot)
        req.status = "finished"
        self.stats["requests_finished"] += 1
        return req

    # -- the dispatch -------------------------------------------------------
    @torch.no_grad()
    def _unified(self, grid, greedy_only):
        """The device side of one dispatch. grid (B, W + 3) int32: the
        token rows, then chunk_len, is_final and decode_mask per slot.
        Runs the forward, picks each slot's token and advances the
        device-resident slot state. Returns the (6, B) int32 host array
        [lengths, cur_tok, done, remaining, counters, emitted token or
        -1]: the dispatch's one device-to-host copy."""
        B, W = self.num_slots, self._width
        d = self._dstate
        toks_in = grid[:, :W]
        chunk_len = grid[:, W]
        is_final = grid[:, W + 1].bool()
        decode_mask = grid[:, W + 2].bool()
        active = decode_mask & ~d["done"] & (d["remaining"] > 0)
        prefilling = chunk_len > 0
        finishing = prefilling & is_final
        qn = torch.where(prefilling, chunk_len, active.to(torch.int32))
        cache = PagedKVCache(self._kp, self._vp, d["table"], d["lengths"],
                             page_lock=self._d_lock, spans=qn,
                             attn_impl=self.attn_impl)
        logits, _ = self.model(toks_in, cache)
        # a decode row samples from position 0, a finishing prefill from
        # its last live position: the distribution after the full prompt
        rows = torch.arange(B, device=grid.device)
        sel = logits[rows, (chunk_len - 1).clamp_min(0).long()]
        if greedy_only:
            nxt = torch.argmax(sel.float(), dim=-1).to(torch.int32)
        else:
            nxt = sample_tokens(sel, d["seeds"], d["counters"],
                                d["do_sample"], d["temp"], d["top_k"],
                                d["top_p"])
        emit = active | finishing
        n_em = emit.to(torch.int32)
        stop = (nxt == d["eos"]) & (d["eos"] >= 0)
        # a prefill chunk advances by the tokens it fed (the first
        # sampled token is written by the next decode), a decode row by 1
        d["lengths"] = d["lengths"] + torch.where(prefilling, chunk_len,
                                                  n_em)
        d["remaining"] = d["remaining"] - n_em
        d["done"] = d["done"] | (emit & (stop | (d["remaining"] <= 0)))
        d["cur_tok"] = torch.where(emit, nxt, d["cur_tok"])
        d["counters"] = d["counters"] + n_em
        toks = torch.where(emit, nxt, torch.full_like(nxt, -1))
        out = torch.stack([d["lengths"], d["cur_tok"],
                           d["done"].to(torch.int32), d["remaining"],
                           d["counters"], toks])
        return out.cpu().numpy().copy()

    def _dispatch(self):
        """ONE dispatch: assemble each slot's work row on the host (prefill
        chunk / decode / idle), run the fixed-shape step, then fan the
        results out — emitted tokens, chunk-cursor advances, the first
        token of each prompt whose final chunk landed, and finishes."""
        B, W = self.num_slots, self._width
        toks_in = np.zeros((B, W), np.int32)
        chunk_len = np.zeros(B, np.int32)
        is_final = np.zeros(B, bool)
        decode_mask = np.zeros(B, bool)
        budget = self.prefill_chunk_budget
        active_slots = list(self.scheduler.active_slots)
        # prefill-budget fairness: visit slots round-robin from a rotating
        # cursor, so concurrent long prompts take turns
        for slot in sorted(active_slots,
                           key=lambda s: (s - self._chunk_rr) % B):
            pend = self._pending[slot]
            if pend is not None and pend.size:
                n = min(int(pend.size), self.chunk_tokens, budget)
                if n <= 0:
                    continue            # budget spent: the chunk waits
                budget -= n
                toks_in[slot, :n] = pend[:n]
                chunk_len[slot] = n
                is_final[slot] = n == pend.size
            elif not self._done[slot] and self._remaining[slot] > 0:
                decode_mask[slot] = True
                toks_in[slot, 0] = self._cur_tok[slot]
        self._chunk_rr = (self._chunk_rr + 1) % B
        grid = np.concatenate([toks_in, chunk_len[:, None],
                               is_final[:, None], decode_mask[:, None]],
                              axis=1).astype(np.int32)
        greedy_only = not bool(self._do_sample[active_slots].any())
        out = self._unified(self._upload(grid), greedy_only)
        (self._lengths, self._cur_tok, done, self._remaining,
         self._counters, toks) = out
        self._done = done.astype(bool)
        now = time.perf_counter()
        st = self.stats
        st["decode_dispatches"] += 1
        finished = []
        for slot in active_slots:
            req = self.scheduler.request_at(slot)
            cl = int(chunk_len[slot])
            if cl:
                self._pending[slot] = self._pending[slot][cl:]
                st["prefill_chunks"] += 1
                st["prefill_tokens"] += cl
                if not is_final[slot]:
                    continue
                # final chunk: the first token landed in this dispatch
                self._pending[slot] = None
                req.status = "running"
                req.t_admit = now
                st["prefills"] += 1
            elif not decode_mask[slot]:
                continue                # chunk queued but out of budget
            if toks[slot] >= 0:
                req.output_tokens.append(int(toks[slot]))
                st["tokens_emitted"] += 1
            if self._done[slot] or self._remaining[slot] <= 0:
                finished.append(self._finish(slot))
        return finished
