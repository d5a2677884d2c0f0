"""Slot scheduler for continuous batching.

A copy of mxnet_tpu/serving/scheduler.py (pure Python and numpy; the
port keeps its own so that it never imports the JAX package).

The engine decodes a FIXED batch of B slots (one compiled program, no
shape churn); the scheduler owns which request occupies which slot.

Admission order (docs/SERVING.md "Robustness"):

  * Requests carry a PRIORITY CLASS (0 = most urgent). Each class has
    its own FIFO queue with an independent bound, so bulk traffic can
    never push interactive traffic out of the admission queue.
  * Within the pick loop the highest class goes first, but every
    `aging_every`-th admission takes the globally OLDEST eligible
    request regardless of class — deterministic aging, so a steady
    stream of high-priority arrivals can never starve a queued
    low-priority request (starvation-freedom is tested, not assumed).
  * Requests re-queued by the engine supervisor after a dispatch fault
    sit out their backoff window (`t_not_before`) and then re-enter at
    the FRONT of their class (they are older than anything queued
    behind them). A request with a failure history is on PROBATION:
    at most one probationer is in flight at a time, so a poison request
    gets re-tried alone and can never take innocents down twice.

Slots free the moment their request finishes (eos or token budget), and
a freed slot is re-admittable between two compiled decode dispatches —
the continuous-batching property: a finished sequence never burns its
slot waiting for the slowest member of its batch.
"""
from __future__ import annotations

import itertools
from collections import deque

import numpy as np

from ..base import MXNetError
from ..analysis import loop_only, thread_safe

__all__ = ["Request", "SlotScheduler", "TenantQuota", "RejectedError",
           "QueueFullError", "TenantQuotaError", "ShedError",
           "TERMINAL_STATUSES"]

# The statuses a Request can END in. "exported" is NOT terminal — a
# migrating request is between replicas and will be adopted (or shed)
# by the router; front-ends and the idempotent-cancel check both key
# off this set.
TERMINAL_STATUSES = frozenset(
    {"finished", "cancelled", "deadline", "failed", "shed"})

_req_counter = itertools.count()
_seq_counter = itertools.count()


class Request:
    """One generation request.

    prompt: 1-D int sequence. max_new_tokens: generation budget
    (including the first token sampled at prefill). Sampling knobs are
    per-request and dynamic — they never recompile the engine. seed
    drives this request's private RNG stream (see serving.sampling).
    eos_token_id=None disables eos stopping for this request.

    priority: admission class, 0 = most urgent (clamped by the
    scheduler to its configured class count; default 1 = normal).
    deadline_ms: end-to-end budget relative to submit(). A queued
    request past its deadline is shed before admission (terminal
    `rejected(deadline)`); a running one is cancelled at the next
    dispatch boundary (terminal `finished(deadline)`, partial output
    kept). None = no deadline.

    adapter_id: LoRA adapter this request decodes through (must be
    registered in the engine's AdapterPool); None/0 = the base model
    (null adapter, bit-identical to an adapter-free engine).
    tenant: accounting/quota label for multi-tenant admission; None =
    the anonymous default tenant. Both ride along through migration
    (export/adopt) and restart continuations.

    trace: distributed trace context (dict with "trace_id" and
    optionally "parent_span"/"t_begin") — the HTTP edge seeds it from
    an incoming `traceparent` header, hedged clones copy it, and
    export/adopt migration packs the accumulated timeline into it, so
    one request is ONE trace wherever it runs (docs/OBSERVABILITY.md
    "Trace propagation"). None = the engine mints an id at submit.
    """

    def __init__(self, prompt, max_new_tokens, request_id=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, eos_token_id=None, priority=1, deadline_ms=None,
                 adapter_id=None, tenant=None, trace=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise MXNetError("Request needs a non-empty prompt")
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if temperature <= 0:
            raise MXNetError("temperature must be > 0 (use "
                             "do_sample=False for greedy)")
        if deadline_ms is not None and deadline_ms <= 0:
            raise MXNetError("deadline_ms must be > 0 (or None)")
        self.max_new_tokens = int(max_new_tokens)
        self.id = request_id if request_id is not None \
            else next(_req_counter)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p if top_p is not None else 1.0)
        self.seed = int(seed)
        self.eos_token_id = eos_token_id
        self.priority = int(priority)
        if self.priority < 0:
            raise MXNetError("priority must be >= 0 (0 = most urgent)")
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        self.adapter_id = adapter_id
        self.tenant = tenant
        self.trace = dict(trace) if trace else None
        # filled in by the engine
        self.status = "new"
        self.output_tokens = []
        # TTFT phase budget (engine `_phase`): phase name -> seconds;
        # rides the Request through export/adopt so a migrated
        # request's decomposition stays continuous
        self.phases = {}
        self.t_submit = None
        self.t_enqueue = None        # last queue entry, engine clock
        self.t_admit = None
        self.t_finish = None
        self.t_deadline = None       # absolute, engine clock domain
        # supervisor bookkeeping (serving/engine.py): consecutive
        # dispatch failures blamed on this request, and the earliest
        # clock time it may be re-admitted after a faulted dispatch
        self.dispatch_failures = 0
        self.t_not_before = 0.0
        self._seq = None             # global submit order, set by submit()
        # quantized-KV write schedule (serving/engine.py): the prefill
        # chunk sizes actually fed, plus any prefix-cache tokens
        # attached instead of computed. Per-page dequant scales make
        # deep-layer KV codes depend on chunk boundaries, so a restart
        # or migration can only continue bit-identically by REPLAYING
        # this schedule; it rides the Request through export/adopt.
        self.kv_history = []
        self.kv_attach = 0
        # subscriber slot (serving/frontend.py): anything with
        # emit(tokens)->bool / close(status). The engine feeds it as
        # tokens land and closes it at every terminal transition; it
        # rides the Request through export/adopt migration, which is
        # how a mid-stream failover re-attaches the live stream.
        self.stream = None
        # cross-process KV handoff payload (serving/engine.py
        # export_handoff / serving/fleet): the request's used KV pages
        # (codes + int8 scale leaves) and decode-cursor scalars, packed
        # when a finished prefill ships to a decode worker. _admit
        # scatters it into fresh pages instead of re-prefilling; a
        # missing/stale payload falls back to the replay restart, which
        # is bit-identical anyway. None = nothing in flight.
        self.kv_payload = None
        # whole-request swap record (serving/engine.py _preempt_slot):
        # while a PREEMPTED request waits in queue, its exclusive KV
        # pages live in the host tier under ("req", id) and this dict
        # carries what _try_resume needs to splice them back (shared
        # prefix nodes, decode cursor, counters). None = not swapped;
        # resume-or-restart both clear it.
        self.swap = None

    @property
    def prompt_len(self):
        return int(self.prompt.size)

    def __repr__(self):
        return (f"Request(id={self.id}, prompt_len={self.prompt_len}, "
                f"max_new={self.max_new_tokens}, "
                f"priority={self.priority}, "
                f"generated={len(self.output_tokens)})")


class RejectedError(MXNetError):
    """A submission the serving stack refused. Carries structured
    context so a front-end can do better than parse the message:
    `reason`, `queue_depth`, `active_slots`, `priority`, and
    `retry_after_s` (drain-rate estimate of when retrying could
    succeed; None when the engine has no recent finishes to rate)."""

    def __init__(self, msg, reason=None, queue_depth=None,
                 active_slots=None, retry_after_s=None, priority=None):
        super().__init__(msg)
        self.reason = reason
        self.queue_depth = queue_depth
        self.active_slots = active_slots
        self.retry_after_s = retry_after_s
        self.priority = priority


class QueueFullError(RejectedError):
    """Raised by SlotScheduler.submit when the request's priority-class
    queue is at capacity — the engine counts these as rejected
    submissions (serving_requests_rejected_total and
    serving_shed_total{reason="queue_full"}) before re-raising with a
    retry-after estimate attached."""


class TenantQuotaError(QueueFullError):
    """Raised by SlotScheduler.submit when the request's TENANT is at
    its max_queue quota (its priority-class queue may have room) — a
    subclass of QueueFullError so front-ends that only know the class
    bound still see backpressure, but the engine counts it under its
    own shed reason (serving_shed_total{reason="tenant_quota"})."""

    def __init__(self, msg, tenant=None, **kw):
        super().__init__(msg, **kw)
        self.tenant = tenant


class ShedError(RejectedError):
    """Raised by the engine when the shedding policy refuses a request
    before it queues (overload, infeasible deadline) — counted in
    serving_shed_total{reason,priority}."""


class TenantQuota:
    """Per-tenant admission limits + fair-share weight.

    max_active: concurrent decode slots the tenant may hold (None =
    no cap — the tenant competes for everything). A tenant at its cap
    keeps its requests QUEUED (not shed): the cap bounds slot
    occupancy, the queue bound sheds.
    max_queue: queued requests across all priority classes (None =
    only the per-class bounds apply). Submissions past it raise
    TenantQuotaError — countable backpressure, the multi-tenant
    analogue of queue_full.
    weight: deficit-weighted fair-share weight inside the pick loop;
    a weight-2 tenant is owed twice the admissions of a weight-1
    tenant when both have eligible queued work.
    """

    def __init__(self, max_active=None, max_queue=None, weight=1.0):
        if max_active is not None and max_active < 1:
            raise MXNetError("max_active must be >= 1 (or None)")
        if max_queue is not None and max_queue < 1:
            raise MXNetError("max_queue must be >= 1 (or None)")
        if weight <= 0:
            raise MXNetError("weight must be > 0")
        self.max_active = None if max_active is None else int(max_active)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.weight = float(weight)

    def __repr__(self):
        return (f"TenantQuota(max_active={self.max_active}, "
                f"max_queue={self.max_queue}, weight={self.weight})")


class SlotScheduler:
    """Fixed-pool slot allocator + priority-class admission queues.

    max_queue bounds each class's queue (None = unbounded; a sequence
    gives per-class bounds): a serving front-end needs backpressure it
    can see — an unbounded queue turns overload into silent tail-latency
    collapse instead of a countable rejection. num_priorities is the
    class count (requests clamp into it); aging_every sets the
    starvation-freedom cadence (every Nth admission is oldest-first)."""

    def __init__(self, num_slots, max_queue=None, num_priorities=3,
                 aging_every=4, tenant_quotas=None):
        if num_slots < 1:
            raise MXNetError("need at least one decode slot")
        self.num_slots = int(num_slots)
        self.num_priorities = int(num_priorities)
        if self.num_priorities < 1:
            raise MXNetError("num_priorities must be >= 1")
        self.aging_every = int(aging_every)
        if self.aging_every < 2:
            raise MXNetError("aging_every must be >= 2")
        if max_queue is None or np.isscalar(max_queue):
            bound = None if max_queue is None else int(max_queue)
            if bound is not None and bound < 1:
                raise MXNetError("max_queue must be >= 1 (or None)")
            self._bounds = [bound] * self.num_priorities
        else:
            self._bounds = [None if b is None else int(b)
                            for b in max_queue]
            if len(self._bounds) != self.num_priorities:
                raise MXNetError(
                    f"per-class max_queue needs {self.num_priorities} "
                    f"entries, got {len(self._bounds)}")
            if any(b is not None and b < 1 for b in self._bounds):
                raise MXNetError("per-class max_queue bounds must be "
                                 ">= 1 (or None)")
        self._free = deque(range(self.num_slots))
        self._queues = [deque() for _ in range(self.num_priorities)]
        self._active = {}          # slot -> Request
        self._admitted = 0         # total admissions, drives aging
        # multi-tenant admission: {tenant: TenantQuota}. Tenants
        # without an entry (and tenant=None traffic) are unquoted with
        # weight 1 — single-tenant behaviour is unchanged.
        quotas = tenant_quotas or {}
        for t, q in quotas.items():
            if not isinstance(q, TenantQuota):
                raise MXNetError(f"tenant_quotas[{t!r}] must be a "
                                 "TenantQuota")
        self.tenant_quotas = dict(quotas)
        self._tenant_service = {}  # tenant -> weighted admissions
        self._tenant_admitted = {}  # tenant -> raw admissions (stats)

    @property
    def max_queue(self):
        """The scalar bound when all classes share one (the common,
        back-compatible configuration), else the per-class list."""
        first = self._bounds[0]
        if all(b == first for b in self._bounds):
            return first
        return list(self._bounds)

    # -- tenants -----------------------------------------------------------
    def quota_of(self, tenant):
        return self.tenant_quotas.get(tenant)

    def tenant_queued(self, tenant):
        return sum(r.tenant == tenant for q in self._queues for r in q)

    def tenant_active(self, tenant):
        return sum(r.tenant == tenant for r in self._active.values())

    def _weight(self, tenant):
        q = self.tenant_quotas.get(tenant)
        return q.weight if q is not None else 1.0

    # -- queue -------------------------------------------------------------
    @loop_only
    def submit(self, request):
        pr = min(max(int(getattr(request, "priority", 1)), 0),
                 self.num_priorities - 1)
        request.priority = pr
        bound = self._bounds[pr]
        if bound is not None and len(self._queues[pr]) >= bound:
            raise QueueFullError(
                f"admission queue full for priority class {pr} "
                f"({bound} waiting); rejecting request — retry after "
                "the queue drains",
                reason="queue_full", queue_depth=self.num_queued,
                active_slots=self.num_active, priority=pr)
        tenant = getattr(request, "tenant", None)
        quota = self.tenant_quotas.get(tenant)
        if quota is not None and quota.max_queue is not None \
                and self.tenant_queued(tenant) >= quota.max_queue:
            raise TenantQuotaError(
                f"tenant {tenant!r} is at its queue quota "
                f"({quota.max_queue} waiting); rejecting request — "
                "this tenant must drain before submitting more",
                reason="tenant_quota", tenant=tenant,
                queue_depth=self.num_queued,
                active_slots=self.num_active, priority=pr)
        request._seq = next(_seq_counter)
        self._queues[pr].append(request)
        return request

    @loop_only
    def requeue(self, request):
        """Put a request the engine rolled back (faulted dispatch,
        transient allocation failure) back at the FRONT of its class —
        it is older than everything queued behind it. Class bounds do
        not apply: the request was already admitted once."""
        self._queues[request.priority].appendleft(request)
        return request

    @loop_only
    def pop_expired(self, now):
        """Remove and return every queued request whose deadline has
        passed — the engine sheds these before admission."""
        out = []
        for q in self._queues:
            survivors = [r for r in q
                         if r.t_deadline is None or now < r.t_deadline]
            if len(survivors) != len(q):
                out.extend(r for r in q
                           if r.t_deadline is not None
                           and now >= r.t_deadline)
                q.clear()
                q.extend(survivors)
        return out

    def _eligible(self, req, now, probe_ok):
        if req.dispatch_failures > 0 and not probe_ok:
            return False             # one probationer in flight at a time
        if now is not None and req.t_not_before > now:
            return False             # still backing off
        quota = self.tenant_quotas.get(req.tenant)
        if quota is not None and quota.max_active is not None \
                and self.tenant_active(req.tenant) >= quota.max_active:
            return False             # tenant at its slot cap: stays
            # queued (the cap bounds occupancy; the queue bound sheds)
        return True

    def _pick(self, now):
        probe_ok = not any(r.dispatch_failures > 0
                           for r in self._active.values())
        if (self._admitted + 1) % self.aging_every == 0:
            # aging turn: globally oldest eligible request wins,
            # whatever its class or tenant — starvation-freedom
            # outranks fair share
            best = None
            for ci, q in enumerate(self._queues):
                for pos, req in enumerate(q):
                    if self._eligible(req, now, probe_ok) and (
                            best is None or req._seq < best[0]):
                        best = (req._seq, ci, pos)
            if best is not None:
                _, ci, pos = best
                req = self._queues[ci][pos]
                del self._queues[ci][pos]
                return req
            return None
        for q in self._queues:
            # deficit-weighted fair pick inside the class: each
            # contending tenant's oldest eligible request is a
            # candidate; the tenant with the least weighted service
            # wins (ties → FIFO by _seq). With one tenant (or none
            # configured) every candidate is the queue head — plain
            # FIFO, the pre-tenant behaviour.
            heads = {}               # tenant -> (pos, req), oldest
            for pos, req in enumerate(q):
                if req.tenant not in heads \
                        and self._eligible(req, now, probe_ok):
                    heads[req.tenant] = (pos, req)
            if not heads:
                continue
            pos, req = min(
                heads.values(),
                key=lambda pr: (
                    self._tenant_service.get(pr[1].tenant, 0.0)
                    / self._weight(pr[1].tenant),
                    pr[1]._seq))
            del q[pos]
            return req
        return None

    @loop_only
    def admit(self, now=None):
        """Pair queued requests with free slots: highest priority class
        first, FIFO within a class, with the aging and probation rules
        described in the module docstring. `now` (the engine's clock)
        activates backoff windows; None admits regardless of backoff.
        Returns the [(slot, request), ...] admitted this round."""
        admitted = []
        while self._free:
            req = self._pick(now)
            if req is None:
                break
            slot = self._free.popleft()
            self._active[slot] = req
            self._admitted += 1
            self._tenant_service[req.tenant] = \
                self._tenant_service.get(req.tenant, 0.0) + 1.0
            self._tenant_admitted[req.tenant] = \
                self._tenant_admitted.get(req.tenant, 0) + 1
            admitted.append((slot, req))
        return admitted

    @loop_only
    def release(self, slot):
        """Free a slot whose request finished (or was evicted)."""
        if slot not in self._active:
            raise MXNetError(f"slot {slot} is not active")
        req = self._active.pop(slot)
        self._free.append(slot)
        return req

    @loop_only
    def cancel_queued(self, request_id):
        """Remove a not-yet-admitted request from its queue by id.
        Returns the Request, or None when no queued request matches
        (it may already be running — see slot_of)."""
        for q in self._queues:
            for i, req in enumerate(q):
                if req.id == request_id:
                    del q[i]
                    return req
        return None

    def slot_of(self, request_id):
        """Slot currently decoding `request_id`, or None."""
        for slot, req in self._active.items():
            if req.id == request_id:
                return slot
        return None

    # -- introspection -----------------------------------------------------
    def request_at(self, slot):
        return self._active.get(slot)

    def queued_requests(self):
        """Queued requests, admission-priority order (class, then FIFO)."""
        return [r for q in self._queues for r in q]

    @property
    def queued_ids(self):
        """Request ids waiting for a slot, admission-priority order."""
        return [r.id for r in self.queued_requests()]

    def snapshot(self):
        """JSON-able view of the scheduler's state — what /statusz and
        the flight recorder's state.json embed: the slot map (slot →
        request id + progress), the waiting queues, and capacity."""
        return {
            "num_slots": self.num_slots,
            "max_queue": self.max_queue,
            "num_priorities": self.num_priorities,
            "aging_every": self.aging_every,
            "free_slots": sorted(self._free),
            "queued_ids": self.queued_ids,
            "queued_by_class": [len(q) for q in self._queues],
            "active": {
                str(slot): {
                    "request_id": req.id,
                    "prompt_len": req.prompt_len,
                    "priority": req.priority,
                    "tenant": req.tenant,
                    "adapter_id": req.adapter_id,
                    "generated": len(req.output_tokens),
                    "max_new_tokens": req.max_new_tokens,
                    "dispatch_failures": req.dispatch_failures,
                } for slot, req in sorted(self._active.items())},
            "tenants": self.tenants_snapshot(),
        }

    def tenants_snapshot(self):
        """Per-tenant quota occupancy — the /statusz tenants block.
        Covers every tenant with a configured quota plus any tenant
        that currently has queued/active work or has ever been
        admitted."""
        tenants = set(self.tenant_quotas)
        tenants.update(r.tenant for q in self._queues for r in q)
        tenants.update(r.tenant for r in self._active.values())
        tenants.update(self._tenant_admitted)
        out = {}
        for t in sorted(tenants, key=lambda x: (x is None, str(x))):
            quota = self.tenant_quotas.get(t)
            out[str(t)] = {
                "queued": self.tenant_queued(t),
                "active": self.tenant_active(t),
                "admitted": self._tenant_admitted.get(t, 0),
                "max_active": quota.max_active if quota else None,
                "max_queue": quota.max_queue if quota else None,
                "weight": self._weight(t),
            }
        return out

    @property
    def active_slots(self):
        return sorted(self._active)

    @property
    def num_active(self):
        return len(self._active)

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_queued(self):
        return sum(len(q) for q in self._queues)

    @property
    def has_work(self):
        return bool(self._active or any(self._queues))
