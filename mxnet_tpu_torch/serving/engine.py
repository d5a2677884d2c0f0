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

Also ported: int8 KV pages (`kv_dtype="int8"`: int8 code pools with
per-(layer, page, head) float32 scales beside them, fresh pages reset to
scale 0 at admission), the radix-tree prefix cache (`prefix_cache=True`:
longest-prefix page attach, the copy-on-write split of a fully cached
prompt, LRU reclaim, the prompt's full pages adopted when its final
chunk lands), byte-denominated pool sizing (`hbm_budget_bytes`, with
`hbm_budget_includes_weights` charging the served weight bytes to it),
admission backpressure (an admission the page pool or the adapter slab
cannot serve rolls its slot back and requeues the request, blaming
nobody), and three options that ride the same (B, W) dispatch:

  * speculative decoding (`speculative=True`): each decoding slot feeds
    its current token plus up to spec_tokens - 1 prompt-lookup drafts
    from its own history (serving/speculative.py), and the dispatch
    verifies them (verify rows are span-kernel rows with q_counts 1 +
    drafts). Greedy output equals speculation-off output token for
    token. Rejected drafts write KV past the slot's length, where later
    writes overwrite it; on int8 pages they also raise the pages'
    scales, as in the reference, so int8 streams with and without
    speculation may differ.
  * w8 weights (`weight_dtype="int8"`): the megatron column/row dense
    weights are quantized ONCE, in place, to int8 codes with per-out-tile
    float32 scales (serving/weight_quant.py); the model serves from them.
  * LoRA adapters (`adapter_pool=AdapterPool(...)`): each slot's slab
    slot is one more per-slot device scalar, and the forward adds each
    row's low-rank delta (serving/adapters.py).

Robustness (as the reference's): step() is SUPERVISED. An exception
in an admission or a dispatch rolls the implicated slots back (leases
released, state parked), audits the page pool, requeues innocents with
backoff and quarantines a request whose dispatches failed max_retries
times (terminal "failed"). The one exception: a CUDA error
(torch.AcceleratorError) or a kernel that does not build, load or
launch (ops._build.KernelError) propagates, because retrying would hide
the card's failure behind quarantined requests; the engine latches it
first (not ready from then on, /healthz degraded, a flight dump). A
rolled-back request
restarts by re-prefilling prompt + emitted tokens with its sampling
counter resumed (on int8 pages by replaying its recorded write
schedule), so its output is bit-identical to an uninterrupted run. A
finite-logits guard computed in the dispatch (riding its one
device-to-host copy) discards a slot whose logits went non-finite,
scrubs its exclusive pages and re-prefills it. Requests carry deadlines
(an expired queued request is shed, a running one cancelled with its
partial output kept); a SheddingPolicy (serving/policy.py) sheds or
down-prioritizes work at submit, latches degraded mode (speculation
suspended) under sustained overload and, with the host tier, preempts
the least urgent running request. tenant_quotas bound each tenant's
queue and slots. The host KV tier (`host_kv_bytes`, needs the prefix
cache) spills evicted prefix pages to host RAM through pinned memory
and pages them back in on a radix hit, and carries the whole-request
swap of a preempted request; a swap the tier dropped falls back to the
restart path.

Telemetry (as the reference's): engine metrics are per-engine children
of the port's telemetry instruments, under the reference's names;
`stats` reads them. Every request records a lifecycle timeline into
`telemetry.request_log` (submit, reject and shed, admission, prefix
match, page-in, preemption and resume, requeue, quarantine, each
prefill chunk and decode or verify dispatch, finish, cancel) with its
TTFT phase budget (queue_wait, prefix_match, host_pagein,
prefill_chunks, first_decode, which sum to at most its TTFT), and feeds
the SLO engine at first token and at finish. The engine publishes
/statusz, a flight-recorder watch probe, a /readyz probe (warmed and
not degraded and not draining) and an HBM ledger provider, and latches
a flight dump on every caught fault. Each dispatch's FLOPs and bytes
come from the model formula (telemetry.cost.gpt2_dispatch_cost) and its
time from two CUDA events read after the dispatch's one device-to-host
copy, never through an extra synchronize. The frontend's seams:
`cancel`, `drain`/`undrain` with `estimated_drain_wait`, and per-request
token streams (`Request.stream`, fed every dispatch; a stream that
cannot take a dispatch's tokens cancels its request). The router's
(serving/router.py): `export_requests` takes every queued and running
request off the engine with its emitted tokens, and `adopt` queues one
on a survivor, which re-prefills prompt + emitted and continues it
bit-identically (the restart continuation above). The fleet's
(serving/fleet): `export_handoff` takes one decoding request off the
engine WITH its KV pages and decode cursor (`Request.kv_payload`), and
an engine that adopts it scatters the pages into fresh ones and goes on
decoding with no re-prefill; a payload that cannot land falls back to
the restart continuation (a `handoff_fallback` event).

Tensor parallelism (`tp=N`, `tp_devices`): the reference's head-wise
megatron split, in one process over a list of shard devices
(parallel/mesh.py; a device may repeat, so N shards can share one card
or the CPU). query/key/value and fc1 are column-parallel, proj and fc2
row-parallel (a bias-free partial, ONE reduction, the bias once), each
shard's KV pools hold its H / N heads, and the embeddings, the tied LM
head, the LayerNorms, the page table, the lock mask and the slot state
stay whole. The dispatch runs the shards in lockstep
(models/gpt2.py `tp_forward`); the finite guard, sampling, speculative
verify and the slot state run once, on shard 0, whose device must be the
engine's. Every eager page op (scrub, scale reset, CoW copy, tier and
handoff moves, the audit's scale read) runs on every shard's pools, and
payloads keep the global head layout, so a tp=2 engine's handoff lands
in a tp=1 or tp=4 engine. hbm_budget_bytes is per chip: a page costs
page_bytes / N of it. Greedy streams equal tp=1's up to floating-point
reassociation in the reductions.
"""
from __future__ import annotations

import inspect
import itertools
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import telemetry
from ..analysis import loop_only, thread_safe
from ..telemetry import cost as _cost
from ..telemetry import ledger as _ledger
from ..telemetry import server as _tserver
from ..telemetry import span
from ..base import MXNetError, resolve_device
from ..models.gpt2 import _DTYPES, tp_forward
from ..models.kv_cache import (PagedKVCache, gather_kv_pages,
                               scatter_kv_pages)
from ..ops._build import KernelError
from ..parallel.mesh import serving_tp_devices
from ..parallel.rules import split_kind
from ..parallel.tp import TPGroup, shard_gpt2
from .adapters import AdapterPoolExhausted
from .host_tier import HostPagePool
from .page_pool import PagePool, PagePoolExhausted
from .prefix_cache import PrefixCache
from .sampling import sample_tokens
from .scheduler import (QueueFullError, Request, ShedError, SlotScheduler,
                        TenantQuotaError, _seq_counter)
from .speculative import PromptLookupProposer, verify_tokens
from .weight_quant import build_weight_plan

__all__ = ["ServingEngine"]

_KV_DTYPES = (None, "int8", torch.int8)

# per-slot state mirrored on the device, in the order of the host arrays
_SLOT_STATE = ("lengths", "cur_tok", "done", "remaining", "counters",
               "seeds", "temp", "top_k", "top_p", "do_sample", "eos")

_engine_ids = itertools.count()
_E = ("engine",)

# the engine's instruments: stats key -> (kind, reference metric name,
# help). Each engine registers labeled children (engine=<ordinal>) of
# process-global instruments; `stats` reads this engine's children
_METRICS = {
    "prefills": ("c", "serving_prefill_total",
                 "prompts fully prefilled (final chunk landed, first "
                 "token sampled)"),
    "prefill_tokens": ("c", "serving_prefill_tokens_total",
                       "prompt tokens computed by prefill chunks"),
    "prefill_chunks": ("c", "serving_prefill_chunks_total",
                       "prompt chunks fed through the dispatch"),
    "prefill_pending": ("g", "serving_prefill_pending_tokens",
                        "admitted prompt tokens not yet fed to a "
                        "dispatch, summed over slots"),
    "decode_dispatches": ("c", "serving_decode_dispatch_total",
                          "dispatches run (one fixed-shape step each)"),
    "decode_steps": ("c", "serving_decode_steps_total",
                     "decode steps run (== dispatches: one forward each)"),
    "tokens_emitted": ("c", "serving_tokens_emitted_total",
                       "tokens sampled and handed to requests"),
    "requests_finished": ("c", "serving_requests_finished_total",
                          "requests completed (eos or budget)"),
    "requests_rejected": ("c", "serving_requests_rejected_total",
                          "submissions refused (queue full, shed, "
                          "prompt too long)"),
    "requests_cancelled": ("c", "serving_requests_cancelled_total",
                           "requests aborted by cancel() or a stream "
                           "overflow (queued or running)"),
    "prefix_hits": ("c", "serving_prefix_cache_hits_total",
                    "admissions whose prompt matched >= 1 cached page"),
    "prefix_misses": ("c", "serving_prefix_cache_misses_total",
                      "admissions with no cached prefix"),
    "prefix_tokens_saved": ("c", "serving_prefix_tokens_saved_total",
                            "prompt tokens attached from the cache"),
    "prefix_evicted_pages": ("c", "serving_prefix_cache_evicted_pages_total",
                             "cached pages reclaimed by the LRU-by-leaf "
                             "policy"),
    "spec_draft_tokens": ("c", "serving_spec_draft_tokens_total",
                          "draft tokens proposed"),
    "spec_accepted_tokens": ("c", "serving_spec_accepted_tokens_total",
                             "draft tokens accepted and emitted"),
    "spec_rollbacks": ("c", "serving_spec_rollbacks_total",
                       "draft tokens rejected by verification"),
    "model_flops": ("c", "serving_model_flops_total",
                    "model-formula FLOPs of the live rows of every "
                    "dispatch (goodput numerator)"),
    "wasted_flops": ("c", "serving_wasted_flops_total",
                     "FLOPs the card spent on dead grid rows and on "
                     "rejected speculative drafts"),
    "flops_per_token": ("g", "serving_flops_per_token",
                        "model FLOPs per emitted token"),
    "admission_capacity": ("g", "serving_admission_capacity",
                           "estimated max concurrent requests at the "
                           "current page budget"),
    "queue_depth": ("g", "serving_queue_depth",
                    "requests waiting for a slot"),
    "slot_occupancy": ("g", "serving_slot_occupancy",
                       "slots decoding right now"),
    "num_slots": ("g", "serving_slots", "configured decode slots"),
    "prefix_cache_pages": ("g", "serving_prefix_cache_pages",
                           "KV pages held by the prefix-cache radix tree"),
    "prefix_pages_shared": ("g", "serving_prefix_pages_shared",
                            "pool pages mapped by more than one lease"),
    "pool_free_pages": ("g", "serving_page_pool_free",
                        "unallocated pages in the KV page pool"),
    "admission_wait": ("h", "serving_admission_wait_seconds",
                       "submit -> slot admission wait"),
    "ttft": ("h", "serving_ttft_seconds",
             "submit -> first token (queue wait + prefill)"),
    "token_latency": ("h", "serving_token_latency_seconds",
                      "per-token decode latency at dispatch resolution "
                      "(dispatch wall / tokens the slot emitted, "
                      "weighted)"),
    "prefill_seconds": ("h", "serving_prefill_seconds",
                        "wall time of dispatches that carried at least "
                        "one prefill chunk"),
    "decode_seconds": ("h", "serving_decode_dispatch_seconds",
                       "dispatch wall time"),
    "drain_seconds": ("h", "serving_drain_seconds",
                      "serve(): last submit -> queue and slots empty"),
    "dispatch_errors": ("c", "serving_dispatch_errors_total",
                        "admission and dispatch faults the supervisor "
                        "caught"),
    "dispatch_retries": ("c", "serving_dispatch_retries_total",
                         "requests requeued with backoff after a caught "
                         "fault or a pool that ran dry"),
    "requests_failed": ("c", "serving_requests_failed_total",
                        "requests quarantined after max_retries failed "
                        "dispatches"),
    "overload_level": ("g", "serving_overload_level",
                       "shedding-policy level: 0 ok, 1 elevated, 2 "
                       "overloaded"),
    "degraded": ("g", "serving_degraded",
                 "1 while the engine is degraded (speculation off, "
                 "/healthz flagged)"),
    "retry_after": ("g", "serving_retry_after_seconds",
                    "drain-rate estimate attached to rejections"),
    "adapter_page_ins": ("c", "serving_adapter_page_ins_total",
                         "LoRA adapters paged into the device slab"),
    "adapter_evictions": ("c", "serving_adapter_evictions_total",
                          "resident LoRA adapters evicted"),
    "adapter_resident": ("g", "serving_adapter_resident",
                         "LoRA adapters resident in the device slab"),
    "adapter_pinned": ("g", "serving_adapter_pinned",
                       "slab slots pinned by active requests"),
    "adapter_slab_bytes": ("g", "serving_adapter_slab_bytes",
                           "device bytes of the LoRA adapter slab"),
    "kv_quant_enabled": ("g", "serving_kv_quant_enabled",
                         "1 when the KV pools store int8 codes with "
                         "per-page scales"),
    "kv_page_bytes": ("g", "serving_kv_page_bytes",
                      "device bytes one KV page costs (k and v slabs of "
                      "every layer, plus int8 scales)"),
    "kv_bytes_per_token": ("g", "serving_kv_bytes_per_token",
                           "KV bytes per token position (kv_page_bytes "
                           "/ page_size)"),
    "tp_shards": ("g", "serving_tp_shards",
                  "tensor-parallel shards of the dispatch (1: "
                  "unsharded)"),
    "weight_quant_enabled": ("g", "serving_weight_quant_enabled",
                             "1 when the engine serves w8 weights"),
    "kv_spill_pages": ("c", "serving_kv_spill_pages_total",
                       "KV pages moved device -> host (prefix spills and "
                       "preemption swaps)"),
    "kv_spill_bytes": ("c", "serving_kv_spill_bytes_total",
                       "bytes admitted to the host tier"),
    "kv_pagein_pages": ("c", "serving_kv_pagein_pages_total",
                        "KV pages restored host -> device"),
    "kv_pagein_bytes": ("c", "serving_kv_pagein_bytes_total",
                        "bytes read back from the host tier"),
    "kv_host_evictions": ("c", "serving_kv_host_evictions_total",
                          "spilled payloads the host tier dropped"),
    "preempts": ("c", "serving_preempt_total",
                 "running requests preempted for more urgent work"),
    "preempt_resumed": ("c", "serving_preempt_resumed_total",
                        "preempted requests resumed from their swap"),
    "preempt_restarted": ("c", "serving_preempt_restarted_total",
                          "preempted requests that fell back to the "
                          "restart path"),
    "kv_spill_seconds": ("h", "serving_kv_spill_seconds",
                         "wall time of one spill (page gather + host "
                         "copy)"),
    "kv_pagein_seconds": ("h", "serving_kv_pagein_seconds",
                          "wall time of one page-in (host read + page "
                          "scatter)"),
    "kv_host_pages": ("g", "serving_kv_host_pages",
                      "payload entries in the host tier"),
    "kv_host_bytes": ("g", "serving_kv_host_bytes",
                      "host-RAM bytes the tier holds"),
    "prefix_resident_pages": ("g", "serving_prefix_resident_pages",
                              "radix-tree nodes with a device page"),
    "prefix_spilled_pages": ("g", "serving_prefix_spilled_pages",
                             "radix-tree nodes whose payload is on the "
                             "host"),
}

# the `stats` keys read straight off a metric child, in the reference's
# order (the rest of `stats` is computed)
_STATS_KEYS = (
    "prefills", "prefill_tokens", "prefill_chunks", "prefill_pending",
    "decode_dispatches", "decode_steps", "tokens_emitted",
    "requests_finished", "requests_rejected", "requests_cancelled",
    "prefix_hits", "prefix_misses", "prefix_tokens_saved",
    "prefix_evicted_pages", "spec_draft_tokens", "spec_accepted_tokens",
    "spec_rollbacks", "model_flops", "wasted_flops", "admission_capacity",
    "prefix_cache_pages", "prefix_pages_shared", "pool_free_pages",
    "queue_depth", "slot_occupancy", "dispatch_errors", "dispatch_retries",
    "requests_failed", "overload_level", "degraded", "adapter_page_ins",
    "adapter_evictions", "adapter_resident", "adapter_pinned",
    "kv_quant_enabled", "kv_page_bytes", "tp_shards",
    "weight_quant_enabled", "kv_spill_pages", "kv_spill_bytes",
    "kv_pagein_pages", "kv_pagein_bytes", "kv_host_evictions",
    "kv_host_pages", "kv_host_bytes", "prefix_resident_pages",
    "prefix_spilled_pages", "preempts", "preempt_resumed",
    "preempt_restarted")


def _engine_metrics(eid):
    make = {"c": telemetry.counter, "g": telemetry.gauge,
            "h": telemetry.histogram}
    m = {key: make[kind](name, help, _E).labels(eid)
         for key, (kind, name, help) in _METRICS.items()}
    _shed_family()
    _tenant_families()
    _ttft_family()
    _ttft_phase_family()
    _weight_bytes_family()
    return m


def _ttft_family():
    """TTFT split by power-of-two prompt-length bucket and the KV tier
    the admission landed on (resident radix hit, spilled = paged in from
    the host tier, cold)."""
    return telemetry.histogram(
        "serving_ttft_by_prompt_seconds",
        "submit -> first token, split by power-of-two prompt-length "
        "bucket (label prompt_bucket=le<N>) and KV tier "
        "(kv_tier=resident|spilled|cold)",
        ("engine", "prompt_bucket", "kv_tier"))


def _ttft_phase_family():
    """The TTFT phase budget, aggregated: every first token observes one
    sample per recorded phase (telemetry.PHASES), labeled with the
    admission's KV tier."""
    return telemetry.histogram(
        "serving_ttft_phase_seconds",
        "per-request TTFT phase durations (label phase=one of "
        "telemetry.PHASES, kv_tier=resident|spilled|cold)",
        ("engine", "phase", "kv_tier"))


def _weight_bytes_family():
    """Served weight bytes split by storage dtype (int8 w8 code slabs
    vs every other tensor)."""
    return telemetry.gauge(
        "serving_weight_bytes",
        "device bytes of the served weight operands, by storage dtype "
        "(int8 code slabs vs float32 params + dequant scales)",
        ("engine", "dtype"))


def _shed_family():
    return telemetry.counter(
        "serving_shed_total",
        "requests shed by the robustness layer, by reason (queue_full, "
        "overload, deadline, deadline_queued, deadline_running, "
        "tenant_quota, tenant_share, draining) and priority class",
        ("engine", "reason", "priority"))


def _tenant_families():
    return {
        "admitted": telemetry.counter(
            "serving_tenant_admitted_total",
            "requests admitted to a slot, by tenant", ("engine", "tenant")),
        "shed": telemetry.counter(
            "serving_tenant_shed_total",
            "requests shed or rejected, by tenant and reason",
            ("engine", "tenant", "reason")),
        "active": telemetry.gauge(
            "serving_tenant_active_slots",
            "decode slots currently held by each tenant",
            ("engine", "tenant")),
        "queued": telemetry.gauge(
            "serving_tenant_queued",
            "queued (admitted-but-waiting) requests per tenant",
            ("engine", "tenant")),
    }


def _fatal(exc):
    """Errors the supervisor must not retry: the card's (a sticky CUDA
    error poisons the context) and a kernel that does not build, load
    or launch."""
    if isinstance(exc, KernelError):
        return True
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(exc, acc):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


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
    (the plain versions anywhere). dtype: KV page dtype of float pools
    (default: the model's). kv_dtype: None (float pages) or "int8"
    (int8 codes with per-(page, head) float32 scales). prefix_cache:
    share prompt pages through a radix tree; prefix_cache_pages caps the
    tree (default num_slots * pages per slot, added to the pool).
    hbm_budget_bytes: the device bytes the KV pool may take; the pool
    holds min(what the slots and the cache want, budget // page_bytes)
    pages and must afford one full slot. retry_backoff_s: how long a
    request waits before its admission is retried after the pool ran
    dry. device: default the CUDA card (raises without one); it must be
    the model's device.

    Robustness: max_retries failed dispatches quarantine a request;
    retry_backoff_s is the base of a blamed request's exponential
    backoff. clock: the engine's time source (default time.perf_counter;
    tests inject a tick clock so deadlines and backoff are
    deterministic). policy: a SheddingPolicy. tenant_quotas: {tenant:
    TenantQuota} for the scheduler. host_kv_bytes: the host RAM the KV
    spill tier may hold (needs prefix_cache=True).

    speculative: prompt-lookup speculative decoding; spec_tokens (>= 2)
    positions a decoding slot feeds per dispatch (the current token and
    up to spec_tokens - 1 drafts; the width becomes W = max(chunk_tokens,
    spec_tokens, 2)); spec_max_ngram / spec_min_ngram bound the lookup.
    weight_dtype: None (the model's weights as they are) or "int8" (w8:
    the model's megatron dense weights are quantized in place, and any
    later engine over the model serves the codes).
    hbm_budget_includes_weights: charge the served weight bytes (int8
    codes plus every float tensor) to hbm_budget_bytes before sizing
    the pool. adapter_pool: an AdapterPool on this engine's device;
    requests then name their adapter by Request.adapter_id.

    tp: tensor-parallel shards (default 1: unsharded); it must divide
    num_heads and the FFN hidden size. tp_devices: the shard devices
    (torch.device or strings; default the first tp CUDA devices, raising
    when there are fewer); a device may repeat (["cpu"] * tp,
    ["cuda:0"] * tp), and the first must be `device`.
    """

    def __init__(self, model, num_slots, max_length=None, page_size=64,
                 decode_block=None, attn_impl="auto", prefill_bucket=None,
                 chunk_tokens=None, prefill_chunk_budget=None, dtype=None,
                 max_queue=None, num_priorities=3, kv_dtype=None,
                 prefix_cache=False, prefix_cache_pages=None,
                 hbm_budget_bytes=None, retry_backoff_s=0.02, device=None,
                 speculative=False, spec_tokens=4, spec_max_ngram=3,
                 spec_min_ngram=1, weight_dtype=None,
                 hbm_budget_includes_weights=False, adapter_pool=None,
                 policy=None, max_retries=3, clock=None, tenant_quotas=None,
                 host_kv_bytes=None, tp=1, tp_devices=None):
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
        # tensor-parallel serving: a construction-time mode. tp=1 is the
        # unsharded engine, bit for bit; tp=N runs N shard modules over
        # N shard pools in lockstep (module docstring)
        self._tp = int(tp or 1)
        if self._tp < 1:
            raise MXNetError(f"tp must be >= 1, got {tp}")
        if self._tp > 1:
            if cfg.num_heads % self._tp:
                raise MXNetError(
                    f"tp={self._tp} must divide num_heads "
                    f"({cfg.num_heads}) — the KV pool and the qkv/proj "
                    "weights shard head-wise")
            if cfg.hidden_size % self._tp:
                raise MXNetError(
                    f"tp={self._tp} must divide the FFN hidden size "
                    f"({cfg.hidden_size}) — fc1/fc2 shard on it")
        self._tp_devices = serving_tp_devices(self._tp, tp_devices)
        self._tp_group = None
        if self._tp_devices is not None:
            if self._tp_devices[0] != self.device:
                raise MXNetError(
                    f"tp_devices[0] is {self._tp_devices[0]}, the engine "
                    f"(shard 0, where the slot state lives) is on "
                    f"{self.device}")
            self._tp_group = TPGroup(self._tp_devices)
        self.chunk_tokens = int(chunk_tokens or page_size)
        if self.chunk_tokens < 1:
            raise MXNetError("chunk_tokens must be >= 1")
        self.prefill_chunk_budget = int(
            prefill_chunk_budget or self.chunk_tokens)
        if self.prefill_chunk_budget < 1:
            raise MXNetError("prefill_chunk_budget must be >= 1")
        self.speculative = bool(speculative)
        self.spec_tokens = int(spec_tokens)
        if self.speculative:
            if self.spec_tokens < 2:
                raise MXNetError("spec_tokens must be >= 2 (the current "
                                 "token + at least one draft)")
            self._proposer = PromptLookupProposer(
                self.spec_tokens - 1, max_ngram=spec_max_ngram,
                min_ngram=spec_min_ngram)
        # per-slot token history (prompt + emitted) the drafter matches
        # against: None until the slot's final prompt chunk lands
        self._hist = [None] * B
        # ONE dispatch width forever: a prefill chunk, a verify window or
        # a decode row; >= 2 keeps every dispatch on the span kernel
        self._width = max(self.chunk_tokens,
                          self.spec_tokens if self.speculative else 0, 2)
        self.scheduler = SlotScheduler(B, max_queue=max_queue,
                                       num_priorities=num_priorities,
                                       tenant_quotas=tenant_quotas)
        # the robustness layer: retry budget and backoff, the optional
        # shedding policy, an injectable clock (default perf_counter)
        self.policy = policy
        self.max_retries = int(max_retries)
        if self.max_retries < 1:
            raise MXNetError("max_retries must be >= 1")
        self._clock = clock if clock is not None else time.perf_counter
        self._degraded = False
        self._draining = False
        # a CUDA or kernel error seen by step(): sticky, never cleared
        self._fatal_error = None
        # warmup declared over (mark_warm): a kernel build or load after
        # it is a rebuild storm the flight recorder latches
        self._steady = False
        self._finish_times = deque(maxlen=64)   # drain-rate window
        self._hbm_budget = hbm_budget_bytes
        self._hbm_includes_weights = bool(hbm_budget_includes_weights)
        # extra lease rows audit_pages() accounts for (the fault harness
        # registers the pages it holds here)
        self.audit_extra_leases = []
        # called at the top of every step and before every prefill and
        # decode dispatch (serving/faults.py installs into it)
        self.dispatch_hook = None
        self._hook_kw_cache = None

        self._w8_plan = self._quantize_weights(weight_dtype)
        # the shard modules, sliced once from the (possibly just
        # quantized) model's tensors; None unsharded
        self._shards = None if self._tp_group is None \
            else shard_gpt2(model, self._tp_group)
        self.weight_bytes, self._weight_bytes_per_chip = \
            self._served_weight_bytes()
        # what the engine serves: a model an earlier engine quantized
        # serves its codes here too
        self.weight_dtype = "int8" if self.weight_bytes["int8"] \
            else str(model.dtype).replace("torch.", "")
        self.adapter_pool = adapter_pool
        if adapter_pool is not None:
            if adapter_pool.device != self.device:
                raise MXNetError(f"the adapter pool lives on "
                                 f"{adapter_pool.device}, the engine on "
                                 f"{self.device}")
            if adapter_pool.A.shape[1] != cfg.num_layers \
                    or adapter_pool.A.shape[3] != cfg.units:
                raise MXNetError("the adapter pool's layers or units do "
                                 "not match the model's")
        self._slot_state = _SLOT_STATE + (
            ("aslot",) if adapter_pool is not None else ())

        P = self._pages_per_slot = max_length // page_size
        # pool sizing: every slot can always claim its full P exclusive
        # pages (no sharing at all), plus `extra` pages in which the
        # prefix cache keeps prefixes beyond their requests' lives
        extra = 0
        if prefix_cache:
            extra = B * P if prefix_cache_pages is None \
                else int(prefix_cache_pages)
            if extra < 0:
                raise MXNetError("prefix_cache_pages must be >= 0")
        total_pages = B * P + extra
        if kv_dtype not in _KV_DTYPES:
            raise MXNetError(f"kv_dtype {kv_dtype!r} unsupported "
                             "(int8 or None)")
        self._quant = kv_dtype is not None
        dt = _DTYPES[dtype] if isinstance(dtype, str) \
            else (dtype or model.dtype)
        store = torch.int8 if self._quant else dt
        self.kv_dtype = str(store).replace("torch.", "")
        L, H = cfg.num_layers, cfg.num_heads
        Dh = cfg.units // cfg.num_heads
        # the device bytes one page costs: k and v slabs of every layer,
        # plus the float32 scales of int8 pages
        page_bytes = 2 * L * page_size * H * Dh * store.itemsize
        if self._quant:
            page_bytes += 2 * L * H * 4
        if hbm_budget_bytes is not None:
            page_budget = int(hbm_budget_bytes)
            if hbm_budget_includes_weights:
                # the served weights come out of the same device bytes:
                # this turns w8's smaller weights into admitted pages
                page_budget -= self._weight_bytes_per_chip
                if page_budget <= 0:
                    raise MXNetError(
                        f"hbm_budget_bytes {hbm_budget_bytes} is below the "
                        f"{self._weight_bytes_per_chip} B/chip the "
                        f"{self.weight_dtype} weights alone need")
            # the budget is per chip: under tp each chip holds 1/tp of
            # every page (the head axis splits), so it buys tp x the pages
            chip_page = page_bytes // self._tp
            afford = page_budget // chip_page
            if afford < P:
                raise MXNetError(
                    f"hbm_budget_bytes {hbm_budget_bytes} affords {afford} "
                    f"pages at {chip_page} B/page/chip — below the {P} "
                    f"pages one full-length slot needs")
            total_pages = min(total_pages, afford)
        # one pool set per shard over its H / tp heads (the whole pools
        # unsharded); shard 0's are _kp/_vp/_ks/_vs
        self._kv_shape = (L, page_size, H, Dh)
        self._pools = []
        for dev in self._tp_devices or [self.device]:
            pools = PagedKVCache.create(
                L, B, H // self._tp, max_length, Dh, dtype=dt,
                page_size=page_size, num_pages=total_pages,
                page_table=np.zeros((B, P), np.int32),
                lengths=np.zeros(B), attn_impl=attn_impl,
                kv_dtype="int8" if self._quant else None, device=dev)
            # (L, total_pages + 1, H / tp) float32 scales of int8 pools
            self._pools.append((pools.k_pages, pools.v_pages,
                                pools.k_scale, pools.v_scale))
        self._kp, self._vp, self._ks, self._vs = self._pools[0]
        self.page_pool = PagePool(total_pages, page_bytes=page_bytes)
        self.prefix_cache = PrefixCache(self.page_pool, page_size,
                                        budget_pages=extra) \
            if prefix_cache else None
        self.retry_backoff_s = float(retry_backoff_s)
        # the host-RAM KV tier: an evicted prefix page spills its payload
        # (codes and int8 scale rows) instead of vanishing, a radix hit
        # on a spilled node pages it back in, and preemption swaps whole
        # requests out through the same tier
        self._host_kv_bytes = None if host_kv_bytes is None \
            else int(host_kv_bytes)
        self.host_pool = None
        if self._host_kv_bytes is not None:
            if self.prefix_cache is None:
                raise MXNetError("host_kv_bytes needs prefix_cache=True "
                                 "— the spill tier is keyed by radix "
                                 "nodes")
            self.host_pool = HostPagePool(self._host_kv_bytes,
                                          evict_cb=self._host_evict)
            self.prefix_cache.evict_hook = self._spill_node
            self.prefix_cache.pagein_hook = self._pagein_nodes
        # one staging block for tier copies (pinned on the card, grown
        # to the largest batch of pages moved, at most one slot's), and
        # the event of the last host-to-device copy out of it
        self._stage = None
        self._stage_event = None

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
        # each slot's adapter slab slot (0 = the null adapter) and the
        # adapter id it pins
        self._aslot = np.zeros(B, np.int32)
        self._adapter_of = [None] * B
        # per-slot chunk queues: the not-yet-fed tail of each admitted
        # prompt (None = no prefill work), drained chunk_tokens at a time
        # under prefill_chunk_budget from a rotating slot cursor
        self._pending = [None] * B
        # tokens a slot's request had emitted when it was (re)admitted
        self._base = np.zeros(B, np.int32)
        # int8 restart replay: the exact chunk sizes a re-prefilling
        # slot must feed (a deque; None = the natural chunk grid). Page
        # scales make deep-layer codes depend on chunk boundaries, so
        # only the recorded write schedule continues bit-identically
        self._replay = [None] * B
        self._chunk_rr = 0
        self._dstate = {name: self._upload(getattr(self, "_" + name))
                        for name in self._slot_state}
        self._dstate["table"] = self._upload(self._table_host)
        self._d_lock = self._upload(self._page_lock_host())
        self._eid = str(next(_engine_ids))
        self._metrics = _engine_metrics(self._eid)
        self._shed = _shed_family()
        self._shed_children = {}   # (reason, priority) -> labeled child
        self._shed_counts = {}     # the same keys, host side
        self._tenant_fams = _tenant_families()
        self._tenant_children = {}
        self._tenant_shed_counts = {}   # (tenant, reason) -> n
        self._tenants_seen = set()
        self._ttft_fam = _ttft_family()
        self._ttft_children = {}   # (prompt bucket, tier) -> child
        self._phase_fam = _ttft_phase_family()
        self._phase_children = {}  # (phase, tier) -> labeled child
        self._wbytes_fam = _weight_bytes_family()
        # TTFT phase-budget bookkeeping: the page-in seconds of the
        # admission being mapped (the prefix cache's page-in hook runs
        # inside _map_slot_pages), the KV tier each slot's admission
        # landed on, and the prefill chunks fed per slot
        self._pagein_acc = 0.0
        self._kv_tier = ["cold"] * B
        self._chunks_fed = np.zeros(B, np.int32)
        self._evictions_seen = 0
        self._host_evictions_seen = 0
        self._metrics["num_slots"].set(B)
        self._set_static_gauges()
        self._set_pool_gauges()
        # device-cost accounting: each dispatch's model-formula cost
        # under one program key, timed by a reused pair of CUDA events
        self._cost_program = f"engine{self._eid}/dispatch" + (
            f"/tp{self._tp}" if self._tp > 1 else "")
        self._cost_dtype = str(model.dtype).replace("torch.", "")
        self._cost_logits_bytes = model.dtype.itemsize   # logits' dtype
        self._events = None
        _cost.register_program(self._cost_program, dtype=self._cost_dtype,
                               shards=self._tp)
        _cost.add_steady_probe(self._steady_probe)
        # live introspection: /statusz shows this engine's config and
        # occupancy, the flight recorder's watchdog probes its progress,
        # /readyz asks its readiness and /memz its device bytes (all
        # weakly held: a collected engine drops out)
        name = f"engine{self._eid}"
        weakref.finalize(self, _tserver.clear_degraded, name)
        telemetry.register_status_provider(f"engine/{self._eid}",
                                           self._statusz)
        telemetry.flight.watch(name, self._flight_probe)
        _tserver.register_ready_probe(name, self._ready_probe)
        weakref.finalize(self, _tserver.unregister_ready_probe, name)
        _ledger.register(f"engine/{self._eid}", self._hbm_ledger)

    def _quantize_weights(self, weight_dtype):
        """w8: quantize the model's megatron column/row dense weights in
        place (each Dense keeps codes and scales instead of its float
        weight); col tiles pinned to num_heads shards, as the reference.
        Returns the plan (empty without w8)."""
        if weight_dtype is None:
            return []
        if str(weight_dtype).replace("torch.", "") != "int8":
            raise MXNetError(f"weight_dtype {weight_dtype!r} unsupported "
                             "(int8 or None)")
        plan = build_weight_plan(self.model.named_parameters(),
                                 tp=self._tp,
                                 max_shards=self.model.config.num_heads)
        if not plan:
            raise MXNetError("weight_dtype='int8' found no megatron col/row "
                             "dense weights to quantize on this model")
        for q in plan:
            self.model.get_submodule(q.name.rsplit(".", 1)[0]).quantize_(
                q.codes, q.scale)
        return plan

    def _served_weight_bytes(self):
        """The device bytes of the weights this engine serves, as in the
        reference: ({"int8": w8 code slabs, "float32": every other tensor
        (parameters, w8 scales), whatever its float dtype}, the bytes one
        chip holds). On a chip a tensor the tp split cuts (column and row
        weights or w8 codes, column biases, column w8 scales) counts
        1/tp, a replicated one whole."""
        out, chip = {"int8": 0, "float32": 0}, 0
        for name, t in itertools.chain(self.model.named_parameters(),
                                       self.model.named_buffers()):
            nb = t.numel() * t.element_size()
            out["int8" if t.dtype == torch.int8 else "float32"] += nb
            base, _, leaf = name.rpartition(".")
            kind = split_kind(f"{base}.weight" if leaf in ("codes", "scale")
                              else name)
            if leaf == "scale" and kind == "row":
                kind = "replicated"     # row scales stay whole per shard
            chip += nb if kind == "replicated" else nb // self._tp
        return out, chip

    def _upload(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # -- telemetry ----------------------------------------------------------
    @property
    def stats(self):
        """This engine's counters and gauges as a plain dict (a live read
        of its telemetry children, the reference's keys)."""
        self._set_pool_gauges()
        m = self._metrics
        out = {key: int(m[key].value) for key in _STATS_KEYS}
        out["kv_bytes_per_token"] = float(m["kv_bytes_per_token"].value)
        out["draining"] = self._draining
        out["shed"] = sum(self._shed_counts.values())
        out["weight_bytes_int8"] = self.weight_bytes["int8"]
        out["weight_bytes_float32"] = self.weight_bytes["float32"]
        out["weight_bytes_total"] = sum(self.weight_bytes.values())
        out["weight_bytes_per_chip"] = self._weight_bytes_per_chip
        return out

    def _set_static_gauges(self):
        """Configuration gauges: set at construction and again after
        reset_stats (they describe the engine, not traffic)."""
        m = self._metrics
        pb = self.page_pool.page_bytes
        m["num_slots"].set(self.num_slots)
        m["kv_quant_enabled"].set(int(self._quant))
        m["kv_page_bytes"].set(pb)
        m["kv_bytes_per_token"].set(pb / self.page_size)
        m["tp_shards"].set(self._tp)
        m["weight_quant_enabled"].set(int(bool(self.weight_bytes["int8"])))
        for wd, nb in self.weight_bytes.items():
            self._wbytes_fam.labels(self._eid, wd).set(nb)

    def reset_stats(self):
        """Zero this engine's telemetry children (other engines and the
        rest of the registry are untouched)."""
        for inst in self._metrics.values():
            inst.reset()
        for child in (list(self._shed_children.values())
                      + list(self._tenant_children.values())
                      + list(self._ttft_children.values())
                      + list(self._phase_children.values())):
            child.reset()
        self._shed_counts = {}
        self._tenant_shed_counts = {}
        self._set_static_gauges()
        self._set_pool_gauges()

    def tenant_stats(self):
        """Per-tenant occupancy and lifetime accounting: the scheduler's
        queued/active/admitted/quota view plus this engine's shed counts
        split by tenant. Keys are stringified tenant ids."""
        out = self.scheduler.tenants_snapshot()
        for (tenant, reason), n in sorted(self._tenant_shed_counts.items(),
                                          key=repr):
            row = out.setdefault(str(tenant), {})
            row.setdefault("shed", {})[reason] = n
        return out

    def _shed_inc(self, reason, priority, tenant=None):
        key = (reason, int(priority))
        child = self._shed_children.get(key)
        if child is None:
            child = self._shed.labels(self._eid, reason, str(priority))
            self._shed_children[key] = child
        child.inc()
        self._shed_counts[key] = self._shed_counts.get(key, 0) + 1
        if tenant is not None:
            self._tenant_child("shed", tenant, reason).inc()
            tk = (tenant, reason)
            self._tenant_shed_counts[tk] = \
                self._tenant_shed_counts.get(tk, 0) + 1

    def _tenant_child(self, family, tenant, reason=None):
        key = (family, tenant) if reason is None \
            else (family, tenant, reason)
        child = self._tenant_children.get(key)
        if child is None:
            fam = self._tenant_fams[family]
            child = fam.labels(self._eid, str(tenant)) if reason is None \
                else fam.labels(self._eid, str(tenant), reason)
            self._tenant_children[key] = child
        self._tenants_seen.add(tenant)
        return child

    def _observe_ttft(self, prompt_len, dt, kv_tier="cold"):
        """The labeled TTFT-by-prompt-length child (power-of-two buckets
        x KV tier; children made as combinations appear)."""
        b = 1
        while b < prompt_len:
            b <<= 1
        key = (f"le{b}", kv_tier)
        child = self._ttft_children.get(key)
        if child is None:
            child = self._ttft_fam.labels(self._eid, key[0], kv_tier)
            self._ttft_children[key] = child
        child.observe(dt)

    def _phase(self, req, name, dur, **attrs):
        """Record one TTFT phase span: a timeline event plus the
        request's own accumulation (`req.phases`). Off with the request
        log, for honest A/B runs."""
        if not telemetry.request_log.enabled:
            return
        dur = max(float(dur), 0.0)
        ph = getattr(req, "phases", None)
        if not isinstance(ph, dict):
            ph = req.phases = {}
        ph[name] = ph.get(name, 0.0) + dur
        telemetry.request_log.phase(req.id, self._eid, name, dur, **attrs)

    def _observe_phase_budget(self, req, kv_tier):
        """Publish the request's accumulated phase budget into the phase
        histogram at its first token (one sample per phase)."""
        ph = getattr(req, "phases", None)
        if not isinstance(ph, dict):
            return
        for name, dur in ph.items():
            key = (name, kv_tier)
            child = self._phase_children.get(key)
            if child is None:
                child = self._phase_fam.labels(self._eid, name, kv_tier)
                self._phase_children[key] = child
            child.observe(dur)

    def _set_load_gauges(self):
        m = self._metrics
        m["queue_depth"].set(self.scheduler.num_queued)
        m["slot_occupancy"].set(self.scheduler.num_active)
        m["admission_capacity"].set(self.admission_capacity_estimate())
        self._set_tenant_gauges()

    def _set_tenant_gauges(self):
        # one pass over the queues and slots; tenants seen earlier but
        # absent now are zeroed so their gauges do not stick
        sched = self.scheduler
        if not sched.tenant_quotas and not self._tenants_seen:
            return
        queued, active = {}, {}
        for req in sched.queued_requests():
            if req.tenant is not None:
                queued[req.tenant] = queued.get(req.tenant, 0) + 1
        for slot in sched.active_slots:
            t = sched.request_at(slot).tenant
            if t is not None:
                active[t] = active.get(t, 0) + 1
        for t in (set(queued) | set(active) | set(sched.tenant_quotas)
                  | self._tenants_seen):
            if t is None:
                continue
            self._tenant_child("queued", t).set(queued.get(t, 0))
            self._tenant_child("active", t).set(active.get(t, 0))

    def _set_pool_gauges(self):
        m = self._metrics
        m["pool_free_pages"].set(self.page_pool.num_free)
        m["prefix_pages_shared"].set(
            int(self.page_pool.shared_mask().sum()))
        pc = self.prefix_cache
        if pc is not None:
            m["prefix_cache_pages"].set(pc.num_pages)
            m["prefix_resident_pages"].set(pc.num_resident)
            m["prefix_spilled_pages"].set(pc.num_spilled)
            delta = pc.evicted_pages - self._evictions_seen
            if delta:
                m["prefix_evicted_pages"].inc(delta)
                self._evictions_seen = pc.evicted_pages
        hp = self.host_pool
        if hp is not None:
            m["kv_host_pages"].set(hp.num_entries)
            m["kv_host_bytes"].set(hp.bytes_used)
            delta = hp.evictions - self._host_evictions_seen
            if delta:
                m["kv_host_evictions"].inc(delta)
                self._host_evictions_seen = hp.evictions
        pool = self.adapter_pool
        if pool is not None:
            m["adapter_resident"].set(pool.num_resident)
            m["adapter_pinned"].set(pool.num_pinned)
            m["adapter_slab_bytes"].set(pool.slab_bytes())

    def _statusz(self):
        """The /statusz and flight-dump view of this engine: static
        config, the scheduler's slot and queue snapshot, and the headline
        rates derived from this engine's counters."""
        s = self.stats
        lookups = s["prefix_hits"] + s["prefix_misses"]
        drafted = s["spec_draft_tokens"]
        pool = self.adapter_pool
        return {
            "config": {
                "num_slots": self.num_slots,
                "max_length": self.max_length,
                "page_size": self.page_size,
                "chunk_tokens": self.chunk_tokens,
                "prefill_chunk_budget": self.prefill_chunk_budget,
                "dispatch_width": self._width,
                "attn_impl": self.attn_impl,
                "prefix_cache": self.prefix_cache is not None,
                "speculative": self.speculative,
                "spec_tokens": self.spec_tokens
                if self.speculative else None,
                "max_queue": self.scheduler.max_queue,
                "num_priorities": self.scheduler.num_priorities,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "total_pages": self.page_pool.num_pages,
                "kv_dtype": self.kv_dtype,
                "kv_page_bytes": self.page_pool.page_bytes,
                "weight_dtype": self.weight_dtype,
                "weight_bytes": dict(self.weight_bytes),
                "weight_bytes_per_chip": self._weight_bytes_per_chip,
                "quantized_weights": len(self._w8_plan),
                "hbm_budget_bytes": self._hbm_budget,
                "hbm_budget_includes_weights": self._hbm_includes_weights,
                "host_kv_bytes": self._host_kv_bytes,
                "steady_state": self._steady,
                "adapter_pool": pool is not None,
                "adapter_slots": pool.slots if pool is not None else None,
                "adapter_max_rank": pool.max_rank
                if pool is not None else None,
                "tp_shards": self._tp,
            },
            "sharding": None if self._tp_group is None else {
                "tp_shards": self._tp,
                "mesh_devices": [str(d) for d in self._tp_group.devices],
                "heads_per_shard": self.model.config.num_heads // self._tp,
                "kv_page_bytes_per_chip":
                    self.page_pool.page_bytes // self._tp,
                "replicated": ["embeddings", "lm_head", "layernorm",
                               "page_table", "page_lock",
                               "slot_scalars", "logits"],
            },
            "admission_capacity": self.admission_capacity_estimate(),
            "kv_tier": None if self.host_pool is None else {
                "host_budget_bytes": self.host_pool.budget_bytes,
                "host_bytes_used": self.host_pool.bytes_used,
                "host_entries": self.host_pool.num_entries,
                "host_evictions": self.host_pool.evictions,
                "resident_pages": self.prefix_cache.num_resident,
                "spilled_pages": self.prefix_cache.num_spilled,
                "spilled_total": self.prefix_cache.spilled_pages,
                "paged_in_total": self.prefix_cache.paged_in_pages,
            },
            "robustness": {
                "degraded": "fatal" if self._fatal_error else self._degraded,
                "draining": self._draining,
                "warmed": self._steady,
                "overload_level": int(s["overload_level"]),
                "policy": None if self.policy is None
                else self.policy.snapshot(),
                "shed": {f"{r}/p{p}": n
                         for (r, p), n in sorted(self._shed_counts.items())},
                "quarantined": int(s["requests_failed"]),
                "dispatch_errors": int(s["dispatch_errors"]),
                "retry_after_s": self.estimated_queue_wait(),
            },
            "scheduler": self.scheduler.snapshot(),
            "tenants": self.tenant_stats(),
            "adapters": pool.snapshot() if pool is not None else None,
            "prefix_hit_rate": s["prefix_hits"] / lookups
            if lookups else None,
            "spec_acceptance": s["spec_accepted_tokens"] / drafted
            if drafted else None,
            "stats": s,
        }

    def _flight_probe(self):
        """Watchdog probe (telemetry.flight): progress is the count of
        host-visible scheduling events; busy while work is pending. A
        busy engine whose progress freezes is a stalled dispatch loop."""
        m = self._metrics
        progress = int(m["prefills"].value
                       + m["decode_dispatches"].value
                       + m["requests_finished"].value
                       + m["requests_cancelled"].value
                       + m["requests_failed"].value
                       + m["dispatch_retries"].value
                       + sum(self._shed_counts.values()))
        return progress, self.scheduler.has_work

    # -- device-cost accounting --------------------------------------------
    def mark_warm(self):
        """Declare warmup over: every kernel library this engine needs is
        built and loaded. A build or load after this point still
        succeeds, but it is flagged steady, and an armed flight recorder
        latches a `retrace_storm:kernels/<library>` dump naming it."""
        self._steady = True

    def _steady_probe(self):
        return self._steady

    def _account_flops(self, seconds, cost, wasted_rows=0):
        """Per-dispatch device-cost bookkeeping: attribute the dispatch's
        time and model-formula cost to this engine's program (live MFU
        and bandwidth gauges) and advance the goodput counters: the live
        rows' FLOPs are model FLOPs; the dead grid rows', and the
        rejected drafts' (`wasted_rows` live rows whose work was
        discarded), are wasted."""
        rec = _cost.note_dispatch(self._cost_program, seconds,
                                  flops=cost["flops"],
                                  bytes_accessed=cost["bytes"])
        if rec is None or not cost["flops"]:
            return
        m = self._metrics
        m["model_flops"].inc(cost["flops"])
        per_row = (cost["grid_flops"] - cost["flops"]) \
            / max(cost["grid_rows"] - cost["rows"], 1)
        waste = cost["grid_flops"] - cost["flops"] + per_row * wasted_rows
        if waste > 0:
            m["wasted_flops"].inc(waste)
        tokens = m["tokens_emitted"].value
        if tokens:
            m["flops_per_token"].set(m["model_flops"].value / tokens)

    def _hbm_ledger(self):
        """telemetry.ledger provider: where this engine's device memory
        goes, under the reference's component names. Weights are the
        model's parameters and buffers (w8 codes and scales included;
        the ledger dedupes them across engines over one model); the
        prefix-cache figure is a Detail (those pages live inside the
        kv_pages slab), and so is the host tier (host RAM)."""
        kv = []
        for kp, vp, ks, vs in self._pools:
            kv += [kp, vp]
            if self._quant:
                kv += [ks, vs]           # dequant scales live with KV
        weights = list(self.model.parameters()) + list(self.model.buffers())
        for shard in self._shards or ():
            # a shard's slices share the model's storage where they can
            # (the ledger counts a storage once) and own the rest
            weights += list(shard.parameters()) + list(shard.buffers())
        out = {
            "weights": weights,
            "kv_pages": kv,
            "slot_state": list(self._dstate.values()) + [self._d_lock],
        }
        if self.weight_dtype == "int8":
            # the reference keeps the float weights its codes replaced
            # as this Detail; w8 here quantizes in place and drops them
            out["weights_fp32_shadow"] = _ledger.Detail(0)
        pool = self.adapter_pool
        if pool is not None:
            slab = [pool.A, pool.B, pool.scale]
            if pool.quantized:
                slab += [pool.a_scale, pool.b_scale]
            out["adapter_slab"] = slab
        # the reference's gluon parameters carry gradient buffers from
        # initialize on; torch allocates .grad only at a backward, so
        # this row is empty (0 bytes) on a model that never trained
        out["weight_grads"] = [p.grad for p in self.model.parameters()
                               if p.grad is not None]
        pc = self.prefix_cache
        if pc is not None:
            out["prefix_cache_pages"] = _ledger.Detail(
                pc.num_pages * self.page_pool.page_bytes)
        if self.host_pool is not None:
            out["host_kv"] = _ledger.Detail(self.host_pool.bytes_used)
        return out

    # -- admission control --------------------------------------------------
    def _drain_rate(self):
        """Recent finishes per second (None until two finishes land in
        the window): the denominator of every retry-after estimate."""
        ft = self._finish_times
        if len(ft) < 2:
            return None
        dt = ft[-1] - ft[0]
        if dt <= 0:
            return None
        return (len(ft) - 1) / dt

    def estimated_queue_wait(self):
        """Seconds until the current backlog would drain at the recent
        finish rate (None without a drain history): the retry-after
        estimate rejections carry and the policy's deadline signal."""
        rate = self._drain_rate()
        if rate is None:
            return None
        return self.scheduler.num_queued / rate

    def estimated_drain_wait(self):
        """Seconds until everything in flight (queued + active) would
        complete at the recent finish rate (None without a drain
        history): the retry-after a draining engine attaches."""
        rate = self._drain_rate()
        if rate is None:
            return None
        return (self.scheduler.num_queued
                + self.scheduler.num_active) / rate

    def _reject(self, request, reason, cause=None):
        """Common rejection tail: count, record the terminal `rejected`
        timeline with its context, then raise (the scheduler's
        QueueFullError enriched in place, or a fresh ShedError)."""
        depth = self.scheduler.num_queued
        active = self.scheduler.num_active
        wait = self.estimated_drain_wait() if self._draining \
            else self.estimated_queue_wait()
        if wait is not None:
            self._metrics["retry_after"].set(wait)
        request.status = "shed"
        self._metrics["requests_rejected"].inc()
        self._shed_inc(reason, request.priority, request.tenant)
        telemetry.request_log.terminal(
            request.id, self._eid, "rejected", reason=reason,
            priority=request.priority, prompt_len=request.prompt_len,
            queue_depth=depth, active_slots=active,
            retry_after_s=None if wait is None else round(wait, 4))
        suffix = (f" [queue_depth={depth}, active_slots={active}"
                  + (f", retry_after~{wait:.3f}s" if wait is not None
                     else "") + "]")
        if cause is not None:
            telemetry.flight.note_queue_full(f"engine{self._eid}")
            cause.queue_depth = depth
            cause.active_slots = active
            cause.retry_after_s = wait
            cause.args = (str(cause.args[0]) + suffix,)
            raise cause
        telemetry.flight.note_shed(f"engine{self._eid}")
        raise ShedError(
            f"request {request.id} shed ({reason})" + suffix,
            reason=reason, queue_depth=depth, active_slots=active,
            retry_after_s=wait, priority=request.priority)

    def _set_degraded(self, on, reason="overload"):
        """Latch or clear degraded mode: speculation is suspended (the
        dispatch feeds no drafts) while the engine is overloaded,
        serving_degraded flips and /healthz reports the engine
        degraded."""
        on = bool(on)
        if on == self._degraded:
            return
        self._degraded = on
        self._metrics["degraded"].set(int(on))
        name = f"engine{self._eid}"
        if on:
            if self._fatal_error is None:
                _tserver.set_degraded(name, reason)
            telemetry.flight.record("degraded", engine=self._eid,
                                    reason=reason)
        else:
            if self._fatal_error is None:    # "fatal" stays on /healthz
                _tserver.clear_degraded(name)
            telemetry.flight.record("recovered", engine=self._eid)

    def _latch_fatal(self, phase, exc):
        """A CUDA or kernel error is about to propagate out of step():
        the engine stays not ready for good (a sticky CUDA error poisons
        the process's context), /healthz names it, and an armed flight
        recorder dumps once. Nothing here may mask `exc`."""
        if self._fatal_error is not None:
            return
        self._fatal_error = f"{type(exc).__name__}: {exc}"[:200]
        name = f"engine{self._eid}"
        _tserver.set_degraded(name, "fatal")
        telemetry.flight.record("fatal", engine=self._eid, phase=phase,
                                error=self._fatal_error)
        try:
            telemetry.flight.trigger(
                f"fatal:{name}", {"phase": phase, "error": self._fatal_error})
        except Exception:               # noqa: BLE001 — keep `exc`
            pass

    # -- drain and readiness (the frontend's seams) -------------------------
    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        """True once a drain() completed: admission closed and no queued
        or running work left (every slot and page released)."""
        return self._draining and not self.scheduler.has_work

    @property
    def warmed(self):
        """True after mark_warm()."""
        return self._steady

    def is_ready(self):
        """Readiness for new traffic: warmed AND not degraded AND not
        draining (the /readyz conjunction). A not-ready engine still
        serves its in-flight work. An engine that saw a CUDA or kernel
        error is never ready again."""
        return self._steady and not self._degraded and not self._draining \
            and self._fatal_error is None

    def _ready_probe(self):
        return {"warmed": self._steady,
                "degraded": "fatal" if self._fatal_error else self._degraded,
                "draining": self._draining}

    @thread_safe
    def drain(self):
        """Begin a drain: a new submit() rejects with
        ShedError(reason="draining", retry_after_s=<drain estimate>),
        while queued and running requests are served by step() until the
        engine is empty (`drained`). undrain() reopens. Idempotent."""
        if self._draining:
            return
        self._draining = True
        telemetry.flight.record("draining", engine=self._eid)

    @thread_safe
    def undrain(self):
        """Reopen admission after a drain (no-op when not draining)."""
        if not self._draining:
            return
        self._draining = False
        telemetry.flight.record("undrained", engine=self._eid)

    # -- public API --------------------------------------------------------
    @loop_only
    def submit(self, request):
        """Queue a Request. An over-long prompt or an unknown adapter
        raises MXNetError; a full queue raises QueueFullError (a tenant
        over its quota TenantQuotaError), a policy shed or a draining
        engine ShedError, with request.status == "shed", the rejection
        counted and a terminal `rejected` timeline recorded."""
        if request.prompt_len > self.max_length:
            self._metrics["requests_rejected"].inc()
            telemetry.request_log.terminal(
                request.id, self._eid, "rejected",
                reason="prompt_too_long", prompt_len=request.prompt_len)
            raise MXNetError(
                f"prompt of {request.prompt_len} tokens exceeds slot "
                f"capacity {self.max_length}")
        if request.adapter_id not in (None, 0):
            pool = self.adapter_pool
            if pool is None or not pool.has(request.adapter_id):
                self._metrics["requests_rejected"].inc()
                telemetry.request_log.terminal(
                    request.id, self._eid, "rejected",
                    reason="unknown_adapter",
                    adapter_id=str(request.adapter_id))
                raise MXNetError(
                    f"adapter {request.adapter_id!r} is not registered "
                    + ("(engine has no adapter pool)" if pool is None
                       else "with this engine's adapter pool"))
        if self._draining:
            self._reject(request, "draining")
        now = self._clock()
        request.t_submit = now
        request.t_deadline = None if request.deadline_ms is None \
            else now + request.deadline_ms / 1e3
        request.output_tokens = []
        request.token_times = []
        request.dispatch_failures = 0
        request.t_not_before = 0.0
        if self.policy is not None:
            action, reason = self.policy.on_submit(self, request, now)
            if action == "shed":
                self._reject(request, reason)
        try:
            out = self.scheduler.submit(request)
        except QueueFullError as e:
            self._reject(request,
                         "tenant_quota" if isinstance(e, TenantQuotaError)
                         else "queue_full", cause=e)
        request.status = "queued"
        request.phases = {}
        request.t_enqueue = now
        t = getattr(request, "trace", None) or {}
        tr = telemetry.request_log.begin(
            request.id, self._eid, trace_id=t.get("trace_id"),
            prompt_len=request.prompt_len,
            max_new_tokens=request.max_new_tokens,
            priority=request.priority, deadline_ms=request.deadline_ms,
            parent_span=t.get("parent_span"))
        if tr is not None and not t:
            # no upstream trace context: the id minted here rides the
            # Request
            request.trace = {"trace_id": tr.trace_id}
        self._metrics["queue_depth"].set(self.scheduler.num_queued)
        return out

    @loop_only
    def cancel(self, request_id):
        """Abort a request by id, queued or running: a queued one is
        dequeued, a running one releases its slot and page leases at
        once (tokens already emitted stay on the Request). Returns the
        cancelled Request, or False when the id is unknown or already
        terminal (so a cancel racing a natural finish is a no-op).
        Call from the serving thread."""
        req = self.scheduler.cancel_queued(request_id)
        if req is None:
            slot = self.scheduler.slot_of(request_id)
            if slot is None:
                return False
            req = self._release_slot(slot)
        self._drop_swap(req)
        req.t_finish = self._clock()
        req.status = "cancelled"
        self._metrics["requests_cancelled"].inc()
        telemetry.request_log.end(request_id, self._eid, "cancelled",
                                  tokens=len(req.output_tokens))
        self._stream_close(req)
        self._set_load_gauges()
        self._set_pool_gauges()
        return req

    # -- migration seams (serving/router.py failover + drain) --------------
    @loop_only
    def adopt(self, request, migrated_from=None):
        """Queue a request EXPORTED from another replica, preserving
        its emitted tokens: admission re-prefills prompt+emitted and
        resumes the RNG counter at the next token index (the same
        restart continuation a rolled-back request uses; on int8 pages
        it replays the request's recorded write schedule), so a migrated
        output is bit-identical to an unfaulted run on the original
        replica. Unlike submit(), class queue bounds do not apply —
        the fleet already accepted this request — and t_submit /
        t_deadline carry over (router and replicas share one clock
        domain). Raises while draining; rejects oversized sequences."""
        if self._draining:
            self._reject(request, "draining")
        total = request.prompt_len + len(request.output_tokens)
        if total > self.max_length:
            self._metrics["requests_rejected"].inc()
            raise MXNetError(
                f"sequence of {total} tokens (prompt + emitted) exceeds "
                f"slot capacity {self.max_length}")
        now = self._clock()
        if request.t_submit is None:
            request.t_submit = now
        request.priority = min(max(int(request.priority), 0),
                               self.scheduler.num_priorities - 1)
        if request._seq is None:
            request._seq = next(_seq_counter)
        request.dispatch_failures = 0
        request.t_not_before = 0.0
        self.scheduler.requeue(request)
        request.status = "queued"
        request.t_enqueue = now
        if not isinstance(getattr(request, "phases", None), dict):
            request.phases = {}
        # stitch: export_requests packed the origin timeline's trace id
        # and start onto the Request — the continuation opens with the
        # SAME trace id, the ORIGINAL t_begin, and the phase budget
        # accumulated so far, so the migrated request reads as one
        # trace, not two orphans
        t = getattr(request, "trace", None) or {}
        telemetry.request_log.begin(
            request.id, self._eid, trace_id=t.get("trace_id"),
            t_begin=t.get("t_begin"), phases=request.phases,
            prompt_len=request.prompt_len,
            max_new_tokens=request.max_new_tokens,
            priority=request.priority,
            deadline_ms=request.deadline_ms,
            migrated_from=migrated_from,
            resumed_tokens=len(request.output_tokens))
        self._metrics["queue_depth"].set(self.scheduler.num_queued)
        return request

    @loop_only
    def export_requests(self):
        """Remove and return EVERY queued and in-flight request
        (original submit order), releasing slots, page leases and
        adapter pins. The emitted tokens (and, on int8 pages, the write
        schedule) stay on each Request, so a survivor replica can
        adopt() them and continue bit-identically. Device writes are
        best-effort — the caller may be abandoning a wedged replica,
        whose device state no longer matters; host-side lease
        accounting is always rolled back."""
        out = list(self.scheduler.queued_requests())
        for q in self.scheduler._queues:
            q.clear()
        for slot in list(self.scheduler.active_slots):
            req = self.scheduler.request_at(slot)
            try:
                self._release_slot(slot)
            except Exception:       # noqa: BLE001 — wedged replica
                try:
                    self.scheduler.release(slot)
                except Exception:   # noqa: BLE001
                    pass
                self._free_slot_pages(slot)
                try:
                    self._release_adapter(slot)
                except Exception:   # noqa: BLE001
                    pass
            out.append(req)
        out.sort(key=lambda r: r._seq if r._seq is not None else -1)
        for req in out:
            # a swap payload cannot travel to another replica — drop
            # it; the adopter restarts via the replay path instead
            self._drop_swap(req)
            req.status = "exported"
            # pack the stitch context BEFORE ending the timeline: the
            # adopting replica re-opens the trace with the same id and
            # original start (adopt() passes these back to begin())
            tr = telemetry.request_log.live_trace(req.id, self._eid)
            if tr is not None:
                t = dict(getattr(req, "trace", None) or {})
                t.setdefault("trace_id", tr.trace_id)
                t["t_begin"] = tr.t_begin
                req.trace = t
            telemetry.request_log.end(
                req.id, self._eid, "migrated",
                tokens=len(req.output_tokens))
        self._set_load_gauges()
        self._set_pool_gauges()
        return out

    @loop_only
    def export_handoff(self, request_id):
        """Export ONE decoding request WITH its KV: the prefill-to-decode
        handoff seam of the fleet (serving/fleet). The slot's used pages
        (codes and, on int8 pools, their scale rows, read through the
        tier gather; bfloat16 as 2-byte bit patterns) and the decode
        cursor land in `req.kv_payload`; the slot and its leases are
        released and the timeline ends "migrated" with the stitch context
        packed, as export_requests does. An engine that adopts the
        payload (`_adopt_payload`) scatters the pages back verbatim and
        goes on decoding bit-identically with no re-prefill.

        Returns None when the request is not decoding here: terminal,
        never admitted, or still mid-prefill (its unfed chunk queue is
        host state the payload does not carry; the caller retries after
        the final chunk landed)."""
        slot = None
        for s in self.scheduler.active_slots:
            if self.scheduler.request_at(s).id == request_id:
                slot = s
                break
        if slot is None:
            return None
        req = self.scheduler.request_at(slot)
        if self._pending[slot] is not None or not req.output_tokens:
            return None
        length = int(self._lengths[slot])
        n_used = min(self._pages_per_slot, -(-length // self.page_size))
        row = [int(p) for p in self._table_host[slot][:n_used]]
        req.kv_payload = {
            "length": length,
            "cur_tok": int(self._cur_tok[slot]),
            "remaining": int(self._remaining[slot]),
            "counters": int(self._counters[slot]),
            "pages": self._tier_gather(row),
            # the wall-anchored trace clock, the only clock an adopting
            # process shares with this one: its "handoff" phase is
            # measured from here
            "t_export": telemetry.now(),
        }
        self._drop_swap(req)
        self._release_slot(slot)
        req.status = "exported"
        tr = telemetry.request_log.live_trace(req.id, self._eid)
        if tr is not None:
            t = dict(getattr(req, "trace", None) or {})
            t.setdefault("trace_id", tr.trace_id)
            t["t_begin"] = tr.t_begin
            req.trace = t
        telemetry.request_log.end(
            req.id, self._eid, "migrated", reason="handoff",
            tokens=len(req.output_tokens))
        self._set_load_gauges()
        self._set_pool_gauges()
        return req

    @property
    def has_work(self):
        return self.scheduler.has_work

    @loop_only
    def step(self):
        """One SUPERVISED scheduling round: shed queued requests past
        their deadline, cancel running ones past theirs, admit free slots
        (queue their prompt chunks), let the policy assess (and preempt),
        run ONE dispatch, free finished slots. An admission or dispatch
        exception is caught and rolled back (see the module docstring);
        CUDA and kernel errors propagate. Returns the requests that
        reached a terminal state this round."""
        now = self._clock()
        self._fire_hook("step")
        finished = []
        for req in self.scheduler.pop_expired(now):
            finished.append(self._shed_expired(req))
        for slot in list(self.scheduler.active_slots):
            req = self.scheduler.request_at(slot)
            if req.t_deadline is not None and now >= req.t_deadline:
                finished.append(self._deadline_cancel(slot))
        for slot, req in self.scheduler.admit(now):
            try:
                self._admit(slot, req)
            except Exception as e:          # noqa: BLE001 — supervisor
                if _fatal(e):
                    self._latch_fatal("prefill", e)
                    raise
                q = self._on_admit_fault(slot, req, e)
                if q is not None:
                    finished.append(q)
        if self.policy is not None:
            # assess after admission: the level reflects the backlog this
            # dispatch leaves queued
            self.policy.on_step(self, now)
            if self.host_pool is not None \
                    and hasattr(self.policy, "preempt_victim"):
                victim = self.policy.preempt_victim(self)
                if victim is not None:
                    self._preempt_slot(victim)
        self._set_load_gauges()
        if self.scheduler.num_active:
            try:
                finished.extend(self._dispatch())
            except Exception as e:          # noqa: BLE001 — supervisor
                if _fatal(e):
                    self._latch_fatal("decode", e)
                    raise
                finished.extend(self._on_decode_fault(e))
            self._set_load_gauges()
        return finished

    @thread_safe
    def audit_pages(self, raise_on_error=False):
        """Page-pool invariant audit with this engine's lease map: every
        mapped slot's table row, the fault harness's held rows, the
        prefix cache's member pages, (int8 pools) each page's largest
        scale, which must be finite and >= 0, and with the host tier the
        cross-tier check: the tier's node keys equal the tree's spilled
        keypaths, every swap payload belongs to a queued preempted
        request, and the tier's byte accounting balances. With an
        adapter pool also its audit. Returns the violation list ([] =
        clean)."""
        leases = [self._table_host[s] for s in range(self.num_slots)
                  if self._mapped[s]]
        leases.extend(self.audit_extra_leases)
        members = ()
        if self.prefix_cache is not None:
            members = np.nonzero(self.prefix_cache.member_mask())[0]
        scales = None
        if self._quant:
            # per-page summary over layers and heads; the trash page's
            # row is not a pool page
            N = self.page_pool.num_pages
            scales = np.max([torch.maximum(
                ks[:, :N].abs().amax(dim=(0, 2)),
                vs[:, :N].abs().amax(dim=(0, 2))).cpu().numpy()
                for _, _, ks, vs in self._pools], axis=0)
        host_keys = spilled_keys = None
        extra = []
        if self.host_pool is not None:
            spilled_keys = set(self.prefix_cache.spilled_keypaths())
            swaps = {("req", r.id)
                     for r in self.scheduler.queued_requests()
                     if getattr(r, "swap", None) is not None
                     and r.swap.get("key") is not None}
            host_keys = set()
            for key in self.host_pool.keys():
                kind = key[0] if isinstance(key, tuple) and key else None
                if kind == "node":
                    host_keys.add(key[1])
                elif kind == "req":
                    if key not in swaps:
                        extra.append(
                            f"host tier holds swap payload {key!r} "
                            "with no queued preempted request (leaked)")
                else:
                    extra.append(f"host tier holds unknown key {key!r}")
            extra.extend(self.host_pool.audit())
        out = self.page_pool.audit(leases=leases, members=members,
                                   scales=scales, host_keys=host_keys,
                                   spilled_keys=spilled_keys)
        out.extend(extra)
        out += self.audit_adapters()
        if out and raise_on_error:
            raise MXNetError("page pool audit failed: " + "; ".join(out))
        return out

    @thread_safe
    def audit_adapters(self, raise_on_error=False):
        """Adapter-pool audit against the slots' pinned adapters ([]
        without a pool)."""
        if self.adapter_pool is None:
            return []
        return self.adapter_pool.audit(
            assignments=[a for a in self._adapter_of if a is not None],
            raise_on_error=raise_on_error)

    def admission_capacity_estimate(self):
        """Concurrent requests the page pool supports now: the slots in
        use plus how many more worst-case (full-length, no sharing)
        requests the free pages could map, idle prefix-cache pages
        counting as reclaimable; never above num_slots."""
        free = self.page_pool.num_free
        if self.prefix_cache is not None:
            free += int((self.prefix_cache.member_mask()
                         & (self.page_pool.refcounts() == 0)).sum())
        return min(self.scheduler.num_active + free // self._pages_per_slot,
                   self.num_slots)

    @loop_only
    def serve(self, requests=()):
        """Submit `requests`, run until the queue and every slot drain,
        and return every terminal request in submission order: finished,
        shed (at submit or by a deadline), deadline-cancelled or
        quarantined (check `.status`)."""
        done = []
        for r in requests:
            try:
                self.submit(r)
            except (QueueFullError, ShedError):
                done.append(r)
        t_drain0 = self._clock()
        with span("serving.drain", engine=self._eid):
            while self.has_work:
                done.extend(self.step())
        self._metrics["drain_seconds"].observe(self._clock() - t_drain0)
        done.sort(key=lambda r: r.t_submit)
        return done

    def generate(self, prompts, max_new_tokens, **request_kw):
        """Serve `prompts` with shared settings; their token lists in
        order."""
        reqs = [Request(p, max_new_tokens, **request_kw) for p in prompts]
        self.serve(reqs)
        return [r.output_tokens for r in reqs]

    # -- dispatch hook -------------------------------------------------------
    def _hook_takes_phase(self, hook):
        """A hook that takes phase=/requests= keywords (or **kw) fires at
        every prefill and decode boundary too; one taking (engine) only
        at the top of each step. Read once per hook from its
        signature."""
        cached = self._hook_kw_cache
        if cached is not None and cached[0] is hook:
            return cached[1]
        try:
            params = inspect.signature(hook).parameters
            takes = any(p.kind is inspect.Parameter.VAR_KEYWORD
                        or name in ("phase", "requests")
                        for name, p in params.items())
        except (TypeError, ValueError):
            takes = False
        self._hook_kw_cache = (hook, takes)
        return takes

    def _fire_hook(self, phase, requests=()):
        hook = self.dispatch_hook
        if hook is None:
            return
        if self._hook_takes_phase(hook):
            hook(self, phase=phase, requests=tuple(requests))
        elif phase == "step":
            hook(self)

    # -- deadlines ----------------------------------------------------------
    def _shed_expired(self, req):
        """A queued request whose deadline passed before admission:
        terminal "shed" (reason deadline), no tokens produced."""
        self._drop_swap(req)
        req.status = "shed"
        req.t_finish = self._clock()
        self._shed_inc("deadline_queued", req.priority, req.tenant)
        telemetry.request_log.end(req.id, self._eid, "rejected",
                                  reason="deadline", queued=True, tokens=0)
        self._stream_close(req)
        return req

    def _deadline_cancel(self, slot):
        """A running request past its deadline, cancelled at the dispatch
        boundary: slot and leases released, the tokens it emitted kept;
        terminal "deadline"."""
        req = self._release_slot(slot)
        req.status = "deadline"
        self._shed_inc("deadline_running", req.priority, req.tenant)
        telemetry.request_log.end(req.id, self._eid, "finished",
                                  reason="deadline",
                                  tokens=len(req.output_tokens))
        self._stream_close(req)
        self._set_pool_gauges()
        return req

    # -- fault supervision ----------------------------------------------------
    def _audit_and_latch(self, phase, exc):
        """Post-fault integrity check while the implicated slots still
        hold their leases: the page and adapter audits, then a latched
        flight-recorder dump naming the fault. Returns the violations
        (normally none)."""
        violations = self.audit_pages()
        detail = f"{phase}: {type(exc).__name__}: {exc}"
        if violations:
            detail += " | audit: " + "; ".join(violations)
        telemetry.flight.record("dispatch_error", engine=self._eid,
                                phase=phase, error=str(exc)[:200],
                                audit_violations=len(violations))
        telemetry.flight.trigger(f"dispatch_error:engine{self._eid}",
                                 detail)
        return violations

    def _quarantine(self, req, error):
        """Terminal failure after max_retries blamed faults: "failed";
        the engine keeps serving everyone else."""
        self._drop_swap(req)
        req.status = "failed"
        req.t_finish = self._clock()
        self._metrics["requests_failed"].inc()
        telemetry.request_log.end(
            req.id, self._eid, "failed", reason="error",
            failures=req.dispatch_failures, error=str(error)[:200],
            tokens=len(req.output_tokens))
        telemetry.flight.record("quarantined", engine=self._eid,
                                request=req.id,
                                failures=req.dispatch_failures)
        self._stream_close(req)
        return req

    def _requeue(self, req, now, blamed, error=""):
        """Roll one request back to the queue after a caught fault. A
        blamed request carries the failure: exponential backoff,
        probation (the scheduler retries it alone), quarantine at
        max_retries. Innocents requeue after one flat backoff; their
        emitted tokens ride along and the restart keeps their output
        bit-identical. Returns the quarantined Request, else None."""
        if blamed:
            req.dispatch_failures += 1
            if req.dispatch_failures >= self.max_retries:
                return self._quarantine(req, error)
            backoff = self.retry_backoff_s * (
                2 ** (req.dispatch_failures - 1))
        else:
            backoff = self.retry_backoff_s
        req.t_not_before = now + backoff
        req.t_enqueue = now     # queue_wait counts again from here
        self._metrics["dispatch_retries"].inc()
        self.scheduler.requeue(req)
        req.status = "queued"
        telemetry.request_log.event(
            req.id, self._eid, "requeued", blamed=blamed,
            failures=req.dispatch_failures, backoff_s=round(backoff, 4))
        return None

    def _on_admit_fault(self, slot, req, exc):
        """A failed admission: roll the slot back (scheduler slot, page
        leases, adapter pin, parked state) and requeue the request. A
        pool that ran dry is backpressure (pages drain as slots finish):
        nobody is blamed; anything else counts against the request's
        retry budget. Returns the quarantined Request, or None."""
        now = self._clock()
        self._metrics["dispatch_errors"].inc()
        backpressure = isinstance(exc, (PagePoolExhausted,
                                        AdapterPoolExhausted))
        self.scheduler.release(slot)
        self._free_slot_pages(slot)
        self._release_adapter(slot)
        self._pending[slot] = None
        self._replay[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        self._lengths[slot] = self.max_length
        self._sync_slot(slot)
        if not backpressure:
            self._audit_and_latch("prefill", exc)
        self._set_pool_gauges()
        return self._requeue(req, now, blamed=not backpressure,
                             error=str(exc))

    def _on_decode_fault(self, exc):
        """A failed dispatch: audit while the batch's leases are mapped,
        then roll every active slot back. With probationers (requests
        with earlier failures) in the batch only they are blamed, so
        repeat faults converge on the poison request; a first fault
        blames the whole batch. Returns the requests quarantined."""
        now = self._clock()
        self._metrics["dispatch_errors"].inc()
        self._audit_and_latch("decode", exc)
        active = [(slot, self.scheduler.request_at(slot))
                  for slot in self.scheduler.active_slots]
        probationers = {id(r) for _, r in active if r.dispatch_failures > 0}
        blame_all = not probationers
        quarantined = []
        # reversed + the requeue's appendleft restores admission order
        for slot, req in reversed(active):
            self._release_slot(slot)
            q = self._requeue(req, now,
                              blamed=blame_all or id(req) in probationers,
                              error=str(exc))
            if q is not None:
                quarantined.append(q)
        self._set_pool_gauges()
        return quarantined

    def _scrub_slot_pages(self, slot):
        """Zero the KV of the slot's exclusive, non-tree pages (the only
        pages a poisoned write can live in), and on int8 pools their
        scales, before the leases are released: a recycled page must not
        carry NaN into its next owner's reads."""
        if not self._mapped[slot]:
            return
        ref = self.page_pool.refcounts()
        member = self.prefix_cache.member_mask() \
            if self.prefix_cache is not None else None
        pages = [int(p) for p in self._table_host[slot]
                 if ref[int(p)] == 1
                 and (member is None or not member[int(p)])]
        if not pages:
            return
        for kp, vp, ks, vs in self._pools:
            idx = torch.as_tensor(pages, device=kp.device)
            kp[:, idx] = 0
            vp[:, idx] = 0
            if self._quant:
                ks[:, idx] = 0.0
                vs[:, idx] = 0.0

    def _on_bad_slots(self, bad, exc_msg):
        """Slots whose dispatch gave non-finite logits (the finite
        guard): their tokens of this dispatch are already discarded;
        scrub their exclusive pages and roll them back blamed. Finite
        co-batched slots keep their tokens. Returns the requests
        quarantined."""
        now = self._clock()
        self._metrics["dispatch_errors"].inc()
        self._audit_and_latch("decode_nonfinite", MXNetError(exc_msg))
        quarantined = []
        for slot in reversed(bad):
            req = self.scheduler.request_at(slot)
            telemetry.request_log.event(
                req.id, self._eid, "decode_discarded", slot=slot,
                reason="nonfinite_logits")
            self._scrub_slot_pages(slot)
            self._release_slot(slot)
            q = self._requeue(req, now, blamed=True, error=exc_msg)
            if q is not None:
                quarantined.append(q)
        self._set_pool_gauges()
        return quarantined

    # -- slots and pages ---------------------------------------------------
    def _sync_slot(self, slot):
        """Upload one slot's host state, its page-table row and the
        pool's page_lock mask (all change together) to the device."""
        d = self._dstate
        for name in self._slot_state:
            d[name][slot] = getattr(self, "_" + name)[slot].item()
        d["table"][slot] = self._upload(self._table_host[slot])
        self._d_lock = self._upload(self._page_lock_host())

    def _page_lock_host(self):
        """(num_pages,) bool: True = no write may land in this page. Only
        pages a slot holds exclusively (refcount 1) and the prefix cache
        does not own are writable."""
        lock = self.page_pool.refcounts() != 1
        if self.prefix_cache is not None:
            lock |= self.prefix_cache.member_mask()
        return lock

    def _zero_scales(self, pages):
        """int8 pools: recycled pages start from scale 0, or the
        monotone update would inherit an old owner's scale."""
        if self._quant and pages:
            for _, _, ks, vs in self._pools:
                idx = torch.as_tensor(pages, device=ks.device)
                ks[:, idx] = 0.0
                vs[:, idx] = 0.0

    def _map_slot_pages(self, slot, tokens, match=True):
        """Page-table surgery for an admission (`tokens`: the prompt,
        plus the emitted tokens of a restart): longest-prefix match
        against the prefix cache (paging spilled nodes back in), the
        copy-on-write split when the whole sequence is cached, fresh
        exclusive pages for the rest. Returns the prefix offset (tokens
        not recomputed; prefill starts there). An allocation failure
        releases every lease the match took before it propagates.
        match=False skips the lookup (an int8 restart recomputes every
        position to replay its write schedule)."""
        S, P = self.page_size, self._pages_per_slot
        Tp = int(tokens.size)
        pc = self.prefix_cache
        matched = pc.match(tokens) if (pc is not None and match) else []
        leased = list(matched)
        cow_src = None
        if matched and len(matched) * S >= Tp:
            # fully cached (page-aligned) sequence: its last token must
            # run through the model for its logits, which rewrites
            # position Tp - 1 inside the last cached page. Re-home that
            # page to an exclusive copy; the other matched pages stay
            # shared
            cow_src = matched.pop()
        need = P - len(matched)
        try:
            if pc is not None and self.page_pool.num_free < need:
                pc.reclaim(need)       # LRU-evict (or spill) idle prefixes
            fresh = self.page_pool.alloc(need)
        except Exception:
            if pc is not None and leased:
                pc.release(leased)
            raise
        # before any CoW copy, which then stamps the source page's scales
        # over the zeros. Pages the match paged in are in `matched`,
        # never in `fresh`: their restored scales are not reset
        self._zero_scales(fresh)
        if cow_src is not None:
            dst = fresh[0]             # lands at row index len(matched)
            for pools in self._pools:
                for pool in pools[:4 if self._quant else 2]:
                    pool[:, dst] = pool[:, cow_src]
            pc.release([cow_src])      # drop our lease on the source
            offset = Tp - 1
        else:
            offset = len(matched) * S
        self._table_host[slot] = np.asarray(matched + fresh, np.int32)
        self._mapped[slot] = True
        return offset

    def _free_slot_pages(self, slot):
        if not self._mapped[slot]:
            return
        row = [int(p) for p in self._table_host[slot]]
        if self.prefix_cache is not None:
            self.prefix_cache.release(row)
        else:
            self.page_pool.free(self.page_pool.decref(row))
        self._mapped[slot] = False

    # -- the host KV tier -----------------------------------------------------
    def _staging(self, n):
        """The tier's host staging block, viewed as (k, v, ks, vs) of n
        pages each: page slabs (L, n, S, H, D) in the pools' dtype,
        scale rows (L, n, H) float32 (None on float pools). One block
        per engine, pinned on the card (a pinned allocation costs far
        more than the copy it serves), grown to the largest n asked."""
        L, S, H, D = self._kv_shape
        if self._stage is None or self._stage[0] < n:
            pin = self.device.type == "cuda"
            if self._stage_event is not None:
                self._stage_event.synchronize()
            page = L * S * H * D
            kv = torch.empty(2 * n * page, dtype=self._kp.dtype,
                             pin_memory=pin)
            sc = torch.empty(2 * n * L * H, dtype=torch.float32,
                             pin_memory=pin) if self._quant else None
            self._stage = (n, kv, sc)
        _, kv, sc = self._stage
        page = L * S * H * D
        k = kv[:n * page].view(L, n, S, H, D)
        v = kv[n * page:2 * n * page].view(L, n, S, H, D)
        ks = vs = None
        if sc is not None:
            ks = sc[:n * L * H].view(L, n, H)
            vs = sc[n * L * H:2 * n * L * H].view(L, n, H)
        return k, v, ks, vs

    def _pool_args(self):
        """(k_pages, v_pages, k_scale, v_scale) as the tier gather and
        scatter take them: shard 0's tensors unsharded, else one list
        per leaf with a pool per shard (the global head layout)."""
        if self._tp_group is None:
            return self._pools[0]
        leaves = [list(x) for x in zip(*self._pools)]
        if not self._quant:
            leaves[2] = leaves[3] = None
        return tuple(leaves)

    @staticmethod
    def _host_array(t):
        """A staging view as numpy; bfloat16 (no numpy dtype) as its
        2-byte bit patterns."""
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()

    def _tier_gather(self, pages):
        """Device -> host payload read: the pages' slabs (and int8 scale
        rows) gathered on the card and copied into the pinned staging
        block, the stream synchronised, then each page copied out into
        its own numpy arrays (a view would pin the whole block). Returns
        one payload dict per page."""
        P = self._pages_per_slot
        out = []
        for i in range(0, len(pages), P):
            blk = [int(p) for p in pages[i:i + P]]
            n = len(blk)
            kp, vp, ks, vs = self._pool_args()
            k, v, ks, vs = gather_kv_pages(kp, vp, blk, ks, vs)
            hk, hv, hks, hvs = self._staging(n)
            # the stream orders these copies after any page-in still
            # reading the block
            hk.copy_(k, non_blocking=True)
            hv.copy_(v, non_blocking=True)
            if ks is not None:
                hks.copy_(ks, non_blocking=True)
                hvs.copy_(vs, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            hk, hv = self._host_array(hk), self._host_array(hv)
            if ks is not None:
                hks, hvs = hks.numpy(), hvs.numpy()
            for j in range(n):
                pl = {"k": hk[:, j].copy(), "v": hv[:, j].copy()}
                if ks is not None:
                    pl["ks"] = hks[:, j].copy()
                    pl["vs"] = hvs[:, j].copy()
                out.append(pl)
        return out

    def _tier_scatter(self, items):
        """Host -> device page-in of `items` = [(page_id, payload)]: the
        payloads assembled in the pinned staging block, copied to the
        card on the current stream (the one every dispatch runs on) and
        written into the live pages only. Scale rows land with the
        codes, so a paged-in int8 page needs no re-quantization and no
        scale reset to read back exactly. The block is not refilled
        before its copy has completed (an event)."""
        P = self._pages_per_slot
        for i in range(0, len(items), P):
            blk = items[i:i + P]
            n = len(blk)
            hk, hv, hks, hvs = self._staging(n)
            if self._stage_event is not None:
                self._stage_event.synchronize()
            nk, nv = self._host_array(hk), self._host_array(hv)
            for j, (_, pl) in enumerate(blk):
                nk[:, j] = pl["k"]
                nv[:, j] = pl["v"]
                if self._quant:
                    hks[:, j] = torch.from_numpy(pl["ks"])
                    hvs[:, j] = torch.from_numpy(pl["vs"])
            dk = hk.to(self.device, non_blocking=True)
            dv = hv.to(self.device, non_blocking=True)
            dks = dvs = None
            if self._quant:
                dks = hks.to(self.device, non_blocking=True)
                dvs = hvs.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self._stage_event = ev
            kp, vp, ks, vs = self._pool_args()
            scatter_kv_pages(kp, vp, [int(p) for p, _ in blk], dk, dv, ks,
                             vs, dks, dvs)

    def _spill_node(self, keypath, page):
        """PrefixCache evict_hook: offer one evicted node's payload to
        the host tier (the gather runs before the cache frees the page).
        False (payload not taken) makes the cache discard instead."""
        t0 = self._clock()
        key = ("node", keypath)
        payload = self._tier_gather([int(page)])[0]
        if not self.host_pool.put(key, payload):
            return False
        m = self._metrics
        m["kv_spill_pages"].inc()
        m["kv_spill_bytes"].inc(self.host_pool.entry_bytes(key))
        m["kv_spill_seconds"].observe(self._clock() - t0)
        return True

    def _pagein_nodes(self, items):
        """PrefixCache pagein_hook: restore `items` = [(keypath,
        fresh_page)] from the host tier in one batched scatter. Each
        payload is checked out (pinned) meanwhile and dropped only once
        the scatter landed; on a failure the entries survive."""
        t0 = self._clock()
        taken, ok, nbytes = [], False, 0
        try:
            payloads = []
            for kp, _ in items:
                key = ("node", kp)
                payloads.append(self.host_pool.checkout(key))
                taken.append(key)
                nbytes += self.host_pool.entry_bytes(key)
            self._tier_scatter(
                [(pg, pl) for (_, pg), pl in zip(items, payloads)])
            ok = True
        finally:
            for key in taken:
                self.host_pool.release(key, drop=ok)
        dt = self._clock() - t0
        m = self._metrics
        m["kv_pagein_pages"].inc(len(items))
        m["kv_pagein_bytes"].inc(nbytes)
        m["kv_pagein_seconds"].observe(dt)
        # per-request attribution: _admit zeroes this before the page
        # map, so what the match paged in lands in the admitting
        # request's host_pagein phase
        self._pagein_acc += dt

    def _host_evict(self, key):
        """HostPagePool evict_cb: node payloads go through the prefix
        cache's drop_spilled (vetoed while the node anchors a spilled
        subtree); swap payloads are always droppable (the preempted
        request then restarts, bit-identically)."""
        kind, val = key
        if kind == "node":
            return self.prefix_cache.drop_spilled(val)
        return True

    def _drop_swap(self, req):
        """Discard a preempted request's swap record and host payload
        (it went terminal or its record went stale)."""
        swap = getattr(req, "swap", None)
        if swap is None:
            return
        req.swap = None
        key = swap.get("key")
        if key is not None and self.host_pool is not None \
                and key in self.host_pool:
            self.host_pool.discard(key)

    def _preempt_slot(self, slot):
        """Whole-request swap under overload: gather the victim's
        exclusive pages (its shared prefix stays in the radix tree) into
        one host-tier payload, release the slot and its leases, and
        requeue the request unblamed at the front of its class with a
        swap record (prefix nodes, slot scalars). If the tier cannot take
        the payload the request still yields its slot and restarts
        later instead of resuming; either way its output is
        bit-identical."""
        req = self.scheduler.request_at(slot)
        S, P = self.page_size, self._pages_per_slot
        pc = self.prefix_cache
        length = int(self._lengths[slot])
        n_used = min(P, -(-length // S))
        row = [int(p) for p in self._table_host[slot][:n_used]]
        member = pc.member_mask()
        n_shared = 0
        for p in row:
            if not member[p]:
                break
            n_shared += 1
        excl = row[n_shared:]
        m = self._metrics
        m["preempts"].inc()
        key = ("req", req.id) if excl else None
        swapped = True
        if excl:
            t0 = self._clock()
            pls = self._tier_gather(excl)
            payload = {name: np.stack([pl[name] for pl in pls])
                       for name in pls[0]}
            swapped = self.host_pool.put(key, payload)
            if swapped:
                m["kv_spill_pages"].inc(len(excl))
                m["kv_spill_bytes"].inc(self.host_pool.entry_bytes(key))
                m["kv_spill_seconds"].observe(self._clock() - t0)
        nodes = [pc._by_page.get(p) for p in row[:n_shared]]
        if swapped and all(n is not None for n in nodes):
            req.swap = {"key": key, "nodes": nodes, "n_excl": len(excl),
                        "length": length,
                        "cur_tok": int(self._cur_tok[slot]),
                        "remaining": int(self._remaining[slot]),
                        "counters": int(self._counters[slot])}
        else:
            if swapped and key is not None:
                self.host_pool.discard(key)
            m["preempt_restarted"].inc()
        self._release_slot(slot)
        req.t_enqueue = self._clock()
        self.scheduler.requeue(req)
        req.status = "queued"
        telemetry.request_log.event(
            req.id, self._eid, "preempted", slot=slot,
            swapped=req.swap is not None, tokens=len(req.output_tokens))
        self._set_pool_gauges()

    def _restore_slot(self, slot, req, length, cur_tok, remaining,
                      counters):
        """Rebuild a slot's scalars for a request that goes straight back
        to decode (no prefill)."""
        self._pending[slot] = None
        self._replay[slot] = None
        self._base[slot] = len(req.output_tokens)
        self._lengths[slot] = length
        self._cur_tok[slot] = cur_tok
        self._remaining[slot] = remaining
        self._counters[slot] = counters
        self._set_sampling(slot, req)
        if self.speculative:
            self._hist[slot] = [int(t) for t in req.prompt] \
                + [int(t) for t in req.output_tokens]
        req.status = "running"
        self._sync_slot(slot)

    def _try_resume(self, slot, req):
        """Splice a swapped request straight back into decode: re-lease
        its shared prefix nodes (paging spilled ones back in), restore
        its exclusive pages from the swap payload into fresh pages, and
        rebuild the slot scalars from the swap record. False when the
        record went stale (payload dropped, a prefix node discarded):
        the caller restarts instead. A pool that runs dry mid-resume
        rolls every lease taken here back and propagates (backpressure,
        the swap kept)."""
        swap = req.swap
        pc = self.prefix_cache
        key = swap["key"]
        nodes = swap["nodes"]
        if (key is not None and key not in self.host_pool) \
                or any(n.dead for n in nodes):
            return False
        P = self._pages_per_slot
        n_shared = len(nodes)
        n_excl = int(swap["n_excl"])
        t0 = self._clock()
        m = self._metrics
        taken, ok, payload, nbytes = [], False, None, 0
        try:
            if key is not None:
                # pin the payload first: the reclaim below may spill into
                # the tier and push it out otherwise
                payload = self.host_pool.checkout(key)
                nbytes = self.host_pool.entry_bytes(key)
            resident = [n for n in nodes if not n.spilled]
            spilled = [n for n in nodes if n.spilled]
            self.page_pool.adopt([n.page for n in resident])
            taken.extend(n.page for n in resident)
            if spilled:
                pin = pc._pagein([(pc._keypath(n), n) for n in spilled],
                                 next(pc._clock))
                taken.extend(pin)
                if len(pin) < len(spilled):
                    raise PagePoolExhausted(
                        f"page-in of {len(spilled)} spilled prefix pages "
                        f"restored {len(pin)}: resume of request "
                        f"{req.id} waits for pages to drain")
            need = P - n_shared
            if self.page_pool.num_free < need:
                pc.reclaim(need)
            fresh = self.page_pool.alloc(need)
            taken.extend(fresh)
            # every fresh page from scale 0, then the payload rows' own
            # scales land with their codes
            self._zero_scales(fresh)
            if n_excl:
                items = []
                for j in range(n_excl):
                    pl = {"k": payload["k"][j], "v": payload["v"][j]}
                    if self._quant:
                        pl["ks"] = payload["ks"][j]
                        pl["vs"] = payload["vs"][j]
                    items.append((fresh[j], pl))
                self._tier_scatter(items)
            ok = True
        except BaseException:
            if taken:
                pc.release(taken)
            raise
        finally:
            if payload is not None:
                self.host_pool.release(key, drop=ok)
        if n_excl:
            m["kv_pagein_pages"].inc(n_excl)
            m["kv_pagein_bytes"].inc(nbytes)
            m["kv_pagein_seconds"].observe(self._clock() - t0)
        self._table_host[slot] = np.asarray(
            [n.page for n in nodes] + fresh, np.int32)
        self._mapped[slot] = True
        req.swap = None
        self._restore_slot(slot, req, swap["length"], swap["cur_tok"],
                           swap["remaining"], swap["counters"])
        m["preempt_resumed"].inc()
        telemetry.request_log.event(req.id, self._eid, "resumed_swap",
                                    slot=slot, tokens=len(req.output_tokens))
        self._set_pool_gauges()
        return True

    def _payload_pages(self, pages, length):
        """The shipped pages of a handoff payload as the tier scatter
        takes them, or None when they cannot land in this engine's
        pools: a page count that does not cover `length`, another
        geometry or dtype, scale rows on a float pool or none on an int8
        one. bfloat16 pools take 2-byte leaves ('<i2' bit patterns, or
        the reference's '|V2'), viewed as int16 bits."""
        P, S = self._pages_per_slot, self.page_size
        if (not pages or length < 1 or length > self.max_length
                or len(pages) != min(P, -(-length // S))):
            return None
        L, S_, H, D = self._kv_shape
        bf16 = self._kp.dtype == torch.bfloat16
        want = np.dtype(np.int16) if bf16 \
            else torch.empty((), dtype=self._kp.dtype).numpy().dtype
        names = ("k", "v", "ks", "vs") if self._quant else ("k", "v")
        out = []
        for page in pages:
            if set(page) != set(names):
                return None
            pl = {}
            for name in names:
                a = np.asarray(page[name])
                if name in ("ks", "vs"):
                    if a.shape != (L, H) or a.dtype != np.float32:
                        return None
                else:
                    if a.shape != (L, S_, H, D):
                        return None
                    if bf16 and a.dtype.itemsize == 2 \
                            and a.dtype.kind in "iV":
                        a = a.view(np.int16)
                    if a.dtype != want:
                        return None
                pl[name] = a
            out.append(pl)
        return out

    def _adopt_payload(self, slot, req):
        """Splice a handed-off request straight into decode from its
        shipped KV payload (export_handoff on the exporting engine,
        possibly in another process): a full row of fresh exclusive
        pages, the shipped slabs scattered into them (int8 codes with
        their scale rows, so nothing is re-quantized or replayed), and
        the decode cursor restored from the payload. The continuation is
        bit-identical to the exporter having kept decoding. False when
        the payload cannot land here (geometry, dtype, pool pressure):
        the caller falls back to the replay restart, which reaches the
        same tokens by recomputing."""
        kvp = req.kv_payload
        length = int(kvp.get("length", -1))
        pages = self._payload_pages(kvp.get("pages") or [], length)
        if pages is None:
            return False
        P = self._pages_per_slot
        pc = self.prefix_cache
        try:
            if pc is not None and self.page_pool.num_free < P:
                pc.reclaim(P)
            fresh = self.page_pool.alloc(P)
        except PagePoolExhausted:   # pool pressure: the replay restart
            return False
        try:
            # recycled pages start from scale 0 before the shipped scales
            # land on the payload's pages (the rest stay 0 for decode's
            # monotone max update)
            self._zero_scales(fresh)
            self._tier_scatter(list(zip(fresh[:len(pages)], pages)))
        except BaseException:
            # the slot table does not reference `fresh` yet
            self.page_pool.free(self.page_pool.decref(fresh))
            raise
        self._table_host[slot] = np.asarray(fresh, np.int32)
        self._mapped[slot] = True
        self._kv_tier[slot] = "cold"
        req.kv_payload = None
        self._restore_slot(slot, req, length, int(kvp["cur_tok"]),
                           int(kvp["remaining"]), int(kvp["counters"]))
        # the handoff TTFT phase: export stamp -> payload scattered, on
        # the shared wall-anchored clock. The exporter closed the other
        # phases at the first token; this engine owns only the hop and
        # publishes it into the phase histogram itself
        t_exp = kvp.get("t_export")
        if t_exp is not None and telemetry.request_log.enabled:
            dur = max(0.0, telemetry.now() - float(t_exp))
            self._phase(req, "handoff", dur)
            key = ("handoff", "cold")
            child = self._phase_children.get(key)
            if child is None:
                child = self._phase_fam.labels(self._eid, *key)
                self._phase_children[key] = child
            child.observe(dur)
        telemetry.request_log.event(
            req.id, self._eid, "adopted_payload", slot=slot,
            pages=len(pages), tokens=len(req.output_tokens))
        self._set_pool_gauges()
        return True

    # -- admission -----------------------------------------------------------
    def _set_sampling(self, slot, req):
        self._seeds[slot] = req.seed
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        self._do_sample[slot] = req.do_sample
        self._eos[slot] = -1 if req.eos_token_id is None \
            else req.eos_token_id
        self._done[slot] = False

    def _admit(self, slot, req):
        """Map pages and park the sequence's uncached tail as this slot's
        chunk queue; no forward runs here. The dispatch streams the queue
        chunk_tokens at a time beside everyone else's decode rows and
        samples the first token when the final chunk lands. A prefix
        cache hit starts the slot at the cached offset. The adapter is
        pinned before the pages are mapped: either can raise its pool's
        exhaustion (backpressure), and _on_admit_fault rolls back what
        was taken.

        A handed-off request (kv_payload) goes straight to decode from
        its shipped pages when they can land, as a preempted request
        resumes from its swap when it can. A request
        rolled back after a fault (or a preempted one whose swap went
        stale) restarts: it re-feeds its prompt PLUS the `base` tokens it
        emitted, with its sampling counter resumed at `base` (streams are
        keyed (seed, token index)), and on int8 pages replays its
        recorded write schedule, so its output is bit-identical to an
        uninterrupted run."""
        base = len(req.output_tokens)
        tokens = np.asarray(req.prompt, np.int32) if not base \
            else np.concatenate([req.prompt,
                                 np.asarray(req.output_tokens, np.int32)])
        Tp = int(tokens.size)
        telemetry.request_log.event(req.id, self._eid, "admitted",
                                    slot=slot)
        if base:
            telemetry.request_log.event(req.id, self._eid, "resumed",
                                        tokens=base)
        self._fire_hook("prefill", (req,))
        pool = self.adapter_pool
        if pool is not None:
            seen = pool.page_ins, pool.evictions
            self._aslot[slot] = pool.acquire(req.adapter_id)
            self._adapter_of[slot] = req.adapter_id \
                if req.adapter_id not in (None, 0) else None
            self._metrics["adapter_page_ins"].inc(pool.page_ins - seen[0])
            self._metrics["adapter_evictions"].inc(
                pool.evictions - seen[1])
        if req.kv_payload is not None:
            # a cross-process handoff (serving/fleet): scatter the
            # shipped pages and splice straight into decode, no
            # re-prefill. A payload that cannot land here falls through
            # to the restart below, which reaches the same tokens by
            # recomputing (`kv_history` rode the wire)
            if self._adopt_payload(slot, req):
                return
            req.kv_payload = None
            telemetry.request_log.event(req.id, self._eid,
                                        "handoff_fallback")
        if req.swap is not None:
            if self._try_resume(slot, req):
                return
            self._drop_swap(req)
            self._metrics["preempt_restarted"].inc()
            telemetry.request_log.event(req.id, self._eid, "swap_stale")
        t_map0 = self._clock()
        self._pagein_acc = 0.0
        offset = self._map_slot_pages(slot, tokens,
                                      match=not (self._quant and base))
        t_map1 = self._clock()
        pagein_s = self._pagein_acc
        req.status = "prefilling"
        if req.tenant is not None:
            self._tenant_child("admitted", req.tenant).inc()
        m = self._metrics
        pc = self.prefix_cache
        if pc is not None:
            telemetry.request_log.event(req.id, self._eid, "prefix_match",
                                        cached_tokens=offset)
            if offset:
                m["prefix_hits"].inc()
                m["prefix_tokens_saved"].inc(offset)
            else:
                m["prefix_misses"].inc()
        # the KV tier of this admission: a page-in during the match
        # brought the prefix back from the host tier; a hit without one
        # was device-resident; no cached prefix is a cold start
        self._kv_tier[slot] = "spilled" if pagein_s > 0.0 \
            else ("resident" if offset else "cold")
        self._chunks_fed[slot] = 0
        if not base:
            # latency metrics describe the FIRST admission only: a
            # restart's wait is retry bookkeeping, not the user's TTFT
            m["admission_wait"].observe(self._clock() - req.t_submit)
            # TTFT phase budget: queue_wait ends where the page map
            # begins; the map splits into prefix_match and host_pagein;
            # prefill_chunks and first_decode close at the first token
            t_enq = getattr(req, "t_enqueue", None)
            self._phase(req, "queue_wait",
                        t_map0 - (t_enq if t_enq is not None
                                  else req.t_submit))
            self._phase(req, "prefix_match", (t_map1 - t_map0) - pagein_s,
                        cached_tokens=int(offset))
            if pagein_s > 0.0:
                self._phase(req, "host_pagein", pagein_s)
            req.t_mark = t_map1
        # every decode step writes one KV and the last sampled token is
        # never written, so a sequence of Tp supports up to
        # max_length - Tp + 1 further tokens; `base` already spent that
        # much of max_new_tokens
        cap = min(req.max_new_tokens - base, self.max_length - Tp + 1)
        self._pending[slot] = tokens[offset:]
        if self._quant:
            if base:
                # replay the recorded write schedule: the prefix tokens
                # the first admission attached (re-chunked on the
                # natural grid: they were never computed here), the
                # recorded prefill chunks, then every emitted token as a
                # one-token chunk, as decode wrote it
                plan, head = [], int(req.kv_attach)
                while head > 0:
                    plan.append(min(head, self.chunk_tokens))
                    head -= plan[-1]
                plan += [int(c) for c in req.kv_history]
                tot, trimmed = 0, []
                for c in plan:
                    c = min(c, Tp - tot)
                    if c <= 0:
                        break
                    trimmed.append(c)
                    tot += c
                trimmed += [1] * (Tp - tot)
                req.kv_attach = 0
                req.kv_history = list(trimmed)
                self._replay[slot] = deque(trimmed)
            else:
                # a fresh admission records its schedule anew (a rollback
                # before the first token may have recorded chunks it then
                # discarded): the cached tokens it attached, then each
                # prefill chunk as it is fed
                req.kv_history = []
                req.kv_attach = int(offset)
                self._replay[slot] = None
        self._base[slot] = base
        self._lengths[slot] = offset
        self._cur_tok[slot] = 0
        self._remaining[slot] = cap
        self._counters[slot] = base
        self._set_sampling(slot, req)
        self._hist[slot] = None         # drafting starts after prefill
        self._sync_slot(slot)
        m["prefill_pending"].set(self._pending_tokens())
        if pc is not None or self.adapter_pool is not None:
            self._set_pool_gauges()

    def _pending_tokens(self):
        return sum(int(p.size) for p in self._pending if p is not None)

    def _release_slot(self, slot):
        """Free a slot: scheduler slot back to the pool, page leases
        released, its writes parked past the table (length = max_length)
        so the recycled pages cannot be touched."""
        req = self.scheduler.release(slot)
        req.t_finish = self._clock()
        self._pending[slot] = None
        self._replay[slot] = None
        self._done[slot] = True
        self._remaining[slot] = 0
        self._lengths[slot] = self.max_length
        self._free_slot_pages(slot)
        self._release_adapter(slot)
        self._hist[slot] = None
        self._sync_slot(slot)
        return req

    def _release_adapter(self, slot):
        """Drop the slot's adapter pin (none without a pool or for the
        null adapter) and park the slot on slab slot 0."""
        if self.adapter_pool is None:
            return
        aid = self._adapter_of[slot]
        if aid is not None:
            self.adapter_pool.release(aid)
            self._adapter_of[slot] = None
        self._aslot[slot] = 0

    def _finish(self, slot):
        # read the stop cause before the release parks the slot: budget
        # exhaustion leaves remaining <= 0, an eos leaves budget
        reason = "budget" if self._remaining[slot] <= 0 else "eos"
        req = self._release_slot(slot)
        req.status = "finished"
        self._finish_times.append(self._clock())   # drain-rate window
        self._metrics["requests_finished"].inc()
        if req.t_admit is not None and req.t_finish > req.t_admit \
                and len(req.output_tokens) > 1:
            # per-request decode goodput (tokens/s from first token to
            # finish): the goodput SLO's observation stream
            telemetry.slo.observe_goodput(
                (len(req.output_tokens) - 1) / (req.t_finish - req.t_admit),
                priority=req.priority, tenant=req.tenant)
        telemetry.request_log.end(req.id, self._eid, "finished",
                                  reason=reason,
                                  tokens=len(req.output_tokens))
        self._stream_close(req)
        self._set_pool_gauges()
        return req

    # -- per-request token streams (serving/frontend.py subscribes) ---------
    def _stream_emit(self, req, tokens):
        """Feed freshly emitted tokens to the request's subscriber stream,
        if any (anything with emit(list) -> bool). False when its bounded
        buffer could not take them (the slow-client signal); a raising
        subscriber counts the same and never takes the engine down."""
        st = req.stream
        if st is None:
            return True
        try:
            return bool(st.emit(tokens))
        except Exception:           # noqa: BLE001 — subscriber fault
            return False

    def _stream_close(self, req):
        """Close the request's subscriber stream (if any) with its
        terminal status, waking a reader blocked on it."""
        st = req.stream
        if st is None:
            return
        try:
            st.close(req.status)
        except Exception:           # noqa: BLE001 — subscriber fault
            pass

    def _overflow_cancel(self, slot):
        """Slow-client policy: the request's stream could not take this
        dispatch's tokens, so the request is cancelled (slot, pages and
        adapter released; terminal `cancelled(stream_overflow)`) instead
        of buffering without bound. The stream closes with its overflow
        flag set, and the frontend sends the client an overflow error
        event."""
        req = self._release_slot(slot)
        req.status = "cancelled"
        self._metrics["requests_cancelled"].inc()
        telemetry.request_log.end(req.id, self._eid, "cancelled",
                                  reason="stream_overflow",
                                  tokens=len(req.output_tokens))
        telemetry.flight.record("stream_overflow", engine=self._eid,
                                request=req.id)
        self._stream_close(req)
        self._set_pool_gauges()
        return req

    # -- the dispatch -------------------------------------------------------
    @torch.no_grad()
    def _unified(self, grid, greedy_only):
        """The device side of one dispatch. grid (B, W + 4) int32: the
        token rows (a decode row's drafts follow its current token), then
        chunk_len, is_final, decode_mask and n_draft per slot. Runs the
        forward, checks each slot's live logits are finite, verifies the
        drafts, picks each slot's tokens and advances the
        device-resident slot state. Returns the (8 + S, B) int32 host
        array [lengths, cur_tok, done, remaining, counters, n_em, n_acc,
        ok, the S emitted token rows (-1 past n_em)], S = spec_tokens (1
        without speculation), still on the device: the caller makes the
        dispatch's one device-to-host copy."""
        B, W = self.num_slots, self._width
        d = self._dstate
        toks_in = grid[:, :W]
        chunk_len = grid[:, W]
        is_final = grid[:, W + 1].bool()
        decode_mask = grid[:, W + 2].bool()
        active = decode_mask & ~d["done"] & (d["remaining"] > 0)
        prefilling = chunk_len > 0
        finishing = prefilling & is_final
        nd = torch.where(active, grid[:, W + 3], 0)
        qn = torch.where(prefilling, chunk_len,
                         torch.where(active, 1 + nd, 0))
        g = self._tp_group
        if g is None:
            cache = PagedKVCache(self._kp, self._vp, d["table"],
                                 d["lengths"], page_lock=self._d_lock,
                                 spans=qn, k_scale=self._ks,
                                 v_scale=self._vs, attn_impl=self.attn_impl)
            adapters = None if self.adapter_pool is None \
                else self.adapter_pool.batch(d["aslot"])
            logits, _ = self.model(toks_in, cache, adapters=adapters)
        else:
            # one cache per shard over its own pools; the page table,
            # lengths, lock mask and spans are shared (placed on a
            # shard's device only where it differs)
            shared = zip(*(g.broadcast(x) for x in (
                d["table"], d["lengths"], self._d_lock, qn)))
            caches = [PagedKVCache(kp, vp, tbl, lens, page_lock=lock,
                                   spans=spans, k_scale=ks, v_scale=vs,
                                   attn_impl=self.attn_impl)
                      for (kp, vp, ks, vs), (tbl, lens, lock, spans)
                      in zip(self._pools, shared)]
            adapters = None if self.adapter_pool is None \
                else self.adapter_pool.shard_batches(d["aslot"], g)
            logits = tp_forward(self._shards, g, toks_in, caches,
                                adapters=adapters)
        # the finite guard over LIVE positions only: a slot whose logits
        # went non-finite (corrupted KV, numeric blowup) is flagged; the
        # host discards its tokens of this dispatch and re-prefills it
        live = torch.arange(W, device=grid.device)[None, :] < qn[:, None]
        ok = (torch.isfinite(logits).all(dim=-1) | ~live).all(dim=1) \
            | ~(active | prefilling)
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
        eos = d["eos"]
        emit = active | finishing
        if self.speculative:
            S = self.spec_tokens
            emitted, n_acc = verify_tokens(
                logits[:, :S], toks_in[:, 1:S], nd, d["seeds"],
                d["counters"], d["do_sample"], d["temp"], d["top_k"],
                d["top_p"], greedy_only=greedy_only)
            vpos = torch.arange(S, device=grid.device)[None, :]
            # the accepted drafts + one verifier token, capped by the
            # budget, cut after the first eos; only the emitted count
            # advances `lengths` (rejected drafts' KV stays behind it)
            n_em = torch.minimum(n_acc + 1, d["remaining"])
            hit = (emitted == eos[:, None]) & (eos >= 0)[:, None] \
                & (vpos < n_em[:, None])
            any_hit = hit.any(dim=1)
            first_hit = hit.to(torch.int32).argmax(dim=1).to(torch.int32)
            n_em = torch.where(any_hit,
                               torch.minimum(n_em, first_hit + 1), n_em)
            n_em = torch.where(active, n_em, 0)
            # a finishing prefill emits exactly its first token
            n_em = torch.where(finishing, 1, n_em)
            toks = torch.where(vpos < n_em[:, None], emitted, -1)
            toks = torch.where(finishing[:, None],
                               torch.where(vpos == 0, nxt[:, None], -1),
                               toks)
            last = emitted.gather(
                1, (n_em - 1).clamp_min(0).long()[:, None])[:, 0]
            last = torch.where(finishing, nxt, last)
            stop = torch.where(finishing, (nxt == eos) & (eos >= 0),
                               any_hit)
            n_acc = torch.minimum(n_acc, n_em)
        else:
            n_em = emit.to(torch.int32)
            toks = torch.where(emit, nxt, -1)[:, None]
            last = nxt
            stop = (nxt == eos) & (eos >= 0)
            n_acc = torch.zeros_like(n_em)
        # a prefill chunk advances by the tokens it fed (the first
        # sampled token is written by the next decode), a decode or
        # verify row by the tokens it emitted
        d["lengths"] = d["lengths"] + torch.where(prefilling, chunk_len,
                                                  n_em)
        d["remaining"] = d["remaining"] - n_em
        d["done"] = d["done"] | (emit & (stop | (d["remaining"] <= 0)))
        d["cur_tok"] = torch.where(emit, last, d["cur_tok"])
        d["counters"] = d["counters"] + n_em
        out = torch.cat([torch.stack([d["lengths"], d["cur_tok"],
                                      d["done"].to(torch.int32),
                                      d["remaining"], d["counters"], n_em,
                                      n_acc, ok.to(torch.int32)]),
                         toks.T.to(torch.int32)])
        return out

    def _next_chunk(self, slot, pend, budget):
        """How many pending tokens the slot feeds in this dispatch (0:
        it waits). An int8 restart feeds its recorded chunk sizes
        exactly (splitting one would re-quantize deep layers under other
        scale views); a recorded chunk the remaining budget cannot cover
        waits for a fresh budget, and only one that can never fit is
        split. Any other chunk is recorded in the request's write
        schedule on int8 pages."""
        rq = self._replay[slot]
        if rq:
            want = min(int(rq[0]), self.chunk_tokens)
            if want > budget and want <= self.prefill_chunk_budget:
                return 0
            n = min(want, budget)
            if n <= 0:
                return 0
            if n >= int(rq[0]):
                rq.popleft()
            else:
                rq[0] = int(rq[0]) - n
            return n
        n = min(int(pend.size), self.chunk_tokens, budget)
        if n > 0 and self._quant:
            self.scheduler.request_at(slot).kv_history.append(n)
        return max(n, 0)

    def _dispatch(self):
        """ONE dispatch: assemble each slot's work row on the host (prefill
        chunk / decode or verify / idle), run the fixed-shape step, then
        fan the results out: emitted tokens, chunk-cursor advances, the
        first token of each prompt whose final chunk landed, finishes,
        and the rollback of slots whose logits were not finite."""
        B, W = self.num_slots, self._width
        spec_on = self.speculative and not self._degraded
        toks_in = np.zeros((B, W), np.int32)
        chunk_len = np.zeros(B, np.int32)
        is_final = np.zeros(B, bool)
        decode_mask = np.zeros(B, bool)
        n_draft = np.zeros(B, np.int32)
        budget = self.prefill_chunk_budget
        active_slots = list(self.scheduler.active_slots)
        self._fire_hook("decode", [self.scheduler.request_at(s)
                                   for s in active_slots])
        # prefill-budget fairness: visit slots round-robin from a rotating
        # cursor, so concurrent long prompts take turns
        for slot in sorted(active_slots,
                           key=lambda s: (s - self._chunk_rr) % B):
            pend = self._pending[slot]
            if pend is not None and pend.size:
                n = self._next_chunk(slot, pend, budget)
                if n <= 0:
                    continue            # budget spent: the chunk waits
                budget -= n
                toks_in[slot, :n] = pend[:n]
                chunk_len[slot] = n
                is_final[slot] = n == pend.size
            elif not self._done[slot] and self._remaining[slot] > 0:
                decode_mask[slot] = True
                toks_in[slot, 0] = self._cur_tok[slot]
                if spec_on and self._hist[slot] is not None:
                    drafts = self._proposer.propose(self._hist[slot])
                    n_draft[slot] = drafts.size
                    toks_in[slot, 1:1 + drafts.size] = drafts
        self._chunk_rr = (self._chunk_rr + 1) % B
        grid = np.concatenate([toks_in, chunk_len[:, None],
                               is_final[:, None], decode_mask[:, None],
                               n_draft[:, None]], axis=1).astype(np.int32)
        greedy_only = not bool(self._do_sample[active_slots].any())
        cost_on = _cost.enabled()
        if cost_on:
            qn = np.where(chunk_len > 0, chunk_len,
                          np.where(decode_mask, 1 + n_draft, 0))
            cost = _cost.gpt2_dispatch_cost(
                self.model.config, qn, self._lengths, W,
                sum(self.weight_bytes.values()), self._kp.element_size(),
                self._cost_logits_bytes)
        events = self._dispatch_events() if cost_on else None
        t0 = self._clock()
        h0 = time.perf_counter()
        with span("serving.dispatch", engine=self._eid,
                  active=len(active_slots),
                  prefill_tokens=int(chunk_len.sum()),
                  drafted=int(n_draft.sum())):
            if events is not None:
                events[0].record()
            out = self._unified(self._upload(grid), greedy_only)
            if events is not None:
                events[1].record()
            # the dispatch's ONE device-to-host copy; it waits for the
            # stream, so the end event has completed when it returns
            out = out.cpu().numpy().copy()
        h1 = time.perf_counter()
        now = self._clock()
        dt = now - t0
        (self._lengths, self._cur_tok, done, self._remaining,
         self._counters, n_em, n_acc, ok) = out[:8]
        toks = out[8:].T
        self._done = done.astype(bool)
        m = self._metrics
        m["decode_dispatches"].inc()
        m["decode_steps"].inc()
        m["decode_seconds"].observe(dt)
        n_chunks = int((chunk_len > 0).sum())
        if n_chunks:
            m["prefill_chunks"].inc(n_chunks)
            m["prefill_tokens"].inc(int(chunk_len.sum()))
            m["prefill_seconds"].observe(dt)
        rl = telemetry.request_log
        finished, bad, overflowed = [], [], []
        emitted_total = accepted = 0
        for slot in active_slots:
            req = self.scheduler.request_at(slot)
            if not ok[slot]:
                # non-finite logits: every token this dispatch gave the
                # slot is garbage; it is rolled back below
                bad.append(slot)
                continue
            cl = int(chunk_len[slot])
            if cl:
                self._pending[slot] = self._pending[slot][cl:]
                self._chunks_fed[slot] += 1
                if rl.enabled:
                    rl.event(req.id, self._eid, "prefill_chunk", dur=dt,
                             tokens=cl, final=bool(is_final[slot]))
                if not is_final[slot]:
                    req.dispatch_failures = 0
                    req.t_not_before = 0.0
                    continue
                # final chunk: the first token landed in this dispatch
                self._pending[slot] = None
                self._replay[slot] = None
                first = int(toks[slot, 0])
                req.output_tokens.append(first)
                req.token_times.append(now)
                streamed = self._stream_emit(req, [first])
                req.dispatch_failures = 0
                req.t_not_before = 0.0
                req.status = "running"
                rl.event(req.id, self._eid, "prefill", dur=dt,
                         first_token=first)
                m["prefills"].inc()
                emitted_total += 1
                if not self._base[slot]:
                    req.t_admit = now
                    ttft = now - req.t_submit
                    tier = self._kv_tier[slot]
                    m["ttft"].observe(ttft)
                    self._observe_ttft(req.prompt_len, ttft, tier)
                    # close the phase budget: admit mark -> this
                    # dispatch's start is prefill_chunks, the dispatch
                    # that sampled the first token is first_decode
                    t_mark = getattr(req, "t_mark", None)
                    if rl.enabled and t_mark is not None:
                        self._phase(req, "prefill_chunks", t0 - t_mark,
                                    chunks=int(self._chunks_fed[slot]))
                        self._phase(req, "first_decode", dt)
                        rl.event(req.id, self._eid, "first_token",
                                 ttft=ttft, kv_tier=tier)
                    self._observe_phase_budget(req, tier)
                    telemetry.slo.observe_ttft(
                        ttft, priority=req.priority, tenant=req.tenant)
                pc = self.prefix_cache
                if pc is not None:
                    n_full = req.prompt_len // self.page_size
                    if n_full:
                        # adopt the prompt's full pages into the radix
                        # tree; membership locks them, so refresh the
                        # device mask
                        pc.insert(req.prompt,
                                  [int(p) for p in
                                   self._table_host[slot][:n_full]])
                        self._d_lock = self._upload(self._page_lock_host())
                    self._set_pool_gauges()
                if self.speculative:
                    self._hist[slot] = [int(t) for t in req.prompt] \
                        + req.output_tokens
                if not streamed:
                    overflowed.append(slot)
                elif self._done[slot] or self._remaining[slot] <= 0:
                    finished.append(self._finish(slot))
                continue
            if not decode_mask[slot]:
                continue                # chunk queued but out of budget
            n = int(n_em[slot])
            emitted = [int(t) for t in toks[slot, :n]]
            req.output_tokens.extend(emitted)
            req.token_times.extend([now] * n)
            streamed = self._stream_emit(req, emitted) if n else True
            # a clean dispatch clears the request's failure history:
            # probation is for consecutive faults
            req.dispatch_failures = 0
            req.t_not_before = 0.0
            if self.speculative and self._hist[slot] is not None:
                self._hist[slot].extend(emitted)
            if rl.enabled:
                if self.speculative:
                    rl.event(req.id, self._eid, "verify", dur=dt,
                             drafted=int(n_draft[slot]),
                             accepted=int(n_acc[slot]), tokens=n)
                else:
                    rl.event(req.id, self._eid, "decode", dur=dt, tokens=n)
            emitted_total += n
            accepted += int(n_acc[slot])
            if n:
                m["token_latency"].observe(dt / n, n)
            if not streamed:
                overflowed.append(slot)
            elif self._done[slot] or self._remaining[slot] <= 0:
                finished.append(self._finish(slot))
        for slot in overflowed:
            finished.append(self._overflow_cancel(slot))
        m["tokens_emitted"].inc(emitted_total)
        m["prefill_pending"].set(self._pending_tokens())
        rejected = 0
        if self.speculative:
            drafted = int(n_draft.sum())
            rejected = drafted - accepted
            m["spec_draft_tokens"].inc(drafted)
            m["spec_accepted_tokens"].inc(accepted)
            m["spec_rollbacks"].inc(rejected)
        if cost_on:
            if events is not None:
                seconds = events[0].elapsed_time(events[1]) / 1e3
            else:
                seconds = h1 - h0
            self._account_flops(seconds, cost, wasted_rows=rejected)
        if bad:
            finished.extend(self._on_bad_slots(
                bad, "non-finite logits in unified dispatch"))
        return finished

    def _dispatch_events(self):
        """The reused (start, end) CUDA timing events of the dispatch
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._events is None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        return self._events
