"""SLO-aware admission and load-shedding policy.

A copy of mxnet_tpu/serving/policy.py (pure Python; the port keeps its
own so that it never imports the JAX package).

The engine publishes the control SIGNALS — queue depth, the TTFT
histogram, the admission-capacity estimate. This module closes the
loop: a `SheddingPolicy` attached to a `ServingEngine`
(``ServingEngine(..., policy=SheddingPolicy(...))``) reads those live
signals and decides, BEFORE a request queues, whether to admit it,
down-prioritize it, or shed it — and, under sustained overload, flips
the engine into graceful degradation.

Overload levels (assessed from live telemetry on every submit and
every step):

  * 0 OK        — queue below the low watermark, TTFT inside the SLO.
  * 1 ELEVATED  — queue at/above the low watermark, or the recent TTFT
                  p99 is past `ttft_slo_ms`, or requests are queued
                  with zero admission-capacity headroom. New
                  default-priority work is DOWN-PRIORITIZED one class
                  (interactive class-0 traffic is untouched).
  * 2 OVERLOADED — queue at/above the high watermark (or TTFT blown
                  with a backlog). Everything below the protected
                  priority floor is SHED at submit with
                  `ShedError(reason="overload")`; deadline-infeasible
                  requests (the drain-rate estimate says they cannot
                  start in time) are shed with reason="deadline".

Degradation: `degrade_after` consecutive overloaded steps latch the
engine degraded — speculative decoding is suspended (wasted verify
FLOPs are pure loss when demand exceeds capacity; the engine falls
back to the plain decode program and re-enables speculation on
recovery), `serving_degraded`/`/healthz` flip, and a breadcrumb lands
in the flight ring. `recover_after`
consecutive non-overloaded steps clear it. All thresholds default from
engine shape (watermarks at 1x/2x num_slots) so `SheddingPolicy()` is
usable as-is.

The policy is pure host arithmetic over a handful of counters.
"""
from __future__ import annotations

import math

__all__ = ["SheddingPolicy"]


class SheddingPolicy:
    """Telemetry-driven admission control for one ServingEngine.

    ttft_slo_ms: recent TTFT p99 past this marks the engine elevated
        (None disables the TTFT signal).
    queue_low / queue_high: queued-request watermarks for elevated /
        overloaded (defaults: num_slots / 2*num_slots at attach time).
    shed_priority_floor: classes <= this are never shed by overload
        (deadline-infeasible shedding still applies; default 0 keeps
        only the interactive class protected).
    min_ttft_samples: TTFT observations required before the p99 signal
        is trusted.
    deadline_headroom: shed a request whose deadline budget is below
        headroom x estimated queue wait (drain-rate based; only while
        elevated or worse — the estimate is noise when idle).
    degrade_after / recover_after: consecutive step ticks at/below
        level 2 that latch / clear graceful degradation.
    tenant_queue_share: while elevated or worse, shed a request whose
        tenant already holds more than this fraction of the queue
        (ShedError reason="tenant_share") — one tenant's burst must
        not starve the others of queue capacity. None disables the
        signal; it only ever fires for requests that carry a tenant.
    preempt: while OVERLOADED with every slot busy and more-urgent
        work queued, allow the engine to preempt the least-urgent
        running request — its exclusive KV pages swap to the host
        tier and it resumes bit-identically later (engine
        `_preempt_slot`; needs `host_kv_bytes` on the engine). Off by
        default: preemption beats shedding only when the host tier
        exists to keep the partial work.
    slo: an SLOEngine (default: the process-global
        `telemetry.slo.slo_engine`; pass False to disable). Any
        objective whose FAST window is burning error budget at >=
        `fast_burn` counts toward overload exactly like a blown TTFT
        p99 — the multi-window burn rate reacts in ~1 min where the
        raw p99 needs the histogram to rotate, so shedding starts
        while there is still budget left to protect. Evaluation is
        throttled to `slo_eval_interval_s` (assess runs on every
        submit AND every step; burn rates move on window timescales).
    """

    def __init__(self, ttft_slo_ms=None, queue_low=None, queue_high=None,
                 shed_priority_floor=0, min_ttft_samples=8,
                 deadline_headroom=1.0, degrade_after=3,
                 recover_after=6, tenant_queue_share=None,
                 preempt=False, slo=None, slo_eval_interval_s=0.25):
        self.ttft_slo_ms = ttft_slo_ms
        self.queue_low = queue_low
        self.queue_high = queue_high
        self.shed_priority_floor = int(shed_priority_floor)
        self.min_ttft_samples = int(min_ttft_samples)
        self.deadline_headroom = float(deadline_headroom)
        self.degrade_after = int(degrade_after)
        self.recover_after = int(recover_after)
        self.preempt = bool(preempt)
        self.tenant_queue_share = None if tenant_queue_share is None \
            else float(tenant_queue_share)
        if self.tenant_queue_share is not None \
                and not 0.0 < self.tenant_queue_share <= 1.0:
            raise ValueError("tenant_queue_share must be in (0, 1]")
        self.slo = slo             # None → global engine; False → off
        self.slo_eval_interval_s = float(slo_eval_interval_s)
        self._slo_last = None      # (clock_t, frozenset(burning names))
        self._hot = 0              # consecutive overloaded ticks
        self._cool = 0             # consecutive non-overloaded ticks
        self.level = 0
        self.downgrades = 0

    # -- signals -----------------------------------------------------------
    def _watermarks(self, engine):
        low = self.queue_low if self.queue_low is not None \
            else engine.num_slots
        high = self.queue_high if self.queue_high is not None \
            else 2 * engine.num_slots
        return max(1, int(low)), max(2, int(high))

    def _ttft_blown(self, engine):
        if self.ttft_slo_ms is None:
            return False
        h = engine._metrics["ttft"]
        if h.count < self.min_ttft_samples:
            return False
        p99 = h.percentile(99)
        return (not math.isnan(p99)) and p99 * 1e3 > self.ttft_slo_ms

    def _slo_burning(self, engine):
        """Objective names whose fast window is burning, re-evaluated
        at most every `slo_eval_interval_s` (assess runs per submit
        and per step; burn rates only move on window timescales)."""
        if self.slo is False:
            return ()
        eng = self.slo
        if eng is None:
            from .. import telemetry
            eng = telemetry.slo.slo_engine
        if not eng.objectives:
            return ()
        t = engine._clock()
        if self._slo_last is not None \
                and t - self._slo_last[0] < self.slo_eval_interval_s:
            return self._slo_last[1]
        burning = tuple(eng.fast_burning())
        self._slo_last = (t, burning)
        return burning

    def assess(self, engine):
        """Current overload level from live telemetry (also stored on
        `.level` and published as serving_overload_level)."""
        q = engine.scheduler.num_queued
        low, high = self._watermarks(engine)
        ttft_blown = self._ttft_blown(engine)
        burning = bool(self._slo_burning(engine))
        if q >= high or ((ttft_blown or burning) and q >= low):
            level = 2
        elif q >= low or ttft_blown or burning or (
                q > 0 and engine.admission_capacity_estimate()
                <= engine.scheduler.num_active):
            level = 1
        else:
            level = 0
        self.level = level
        engine._metrics["overload_level"].set(level)
        return level

    # -- hooks the engine calls --------------------------------------------
    def on_submit(self, engine, request, now):
        """Admission decision for one request, BEFORE it queues.
        Returns (action, reason): ("admit", None), ("downgrade", ...)
        — request.priority already bumped — or ("shed", reason)."""
        level = self.assess(engine)
        if level >= 2 and request.priority > self.shed_priority_floor:
            return "shed", "overload"
        if level >= 1 and request.deadline_ms is not None:
            wait = engine.estimated_queue_wait()
            if wait is not None and request.deadline_ms / 1e3 \
                    < self.deadline_headroom * wait:
                return "shed", "deadline"
        if level >= 1 and self.tenant_queue_share is not None \
                and request.tenant is not None:
            q = engine.scheduler.num_queued
            mine = engine.scheduler.tenant_queued(request.tenant)
            if q and mine / q > self.tenant_queue_share:
                return "shed", "tenant_share"
        if level >= 1 and request.priority >= 1 \
                and request.priority < engine.scheduler.num_priorities - 1:
            request.priority += 1
            self.downgrades += 1
            return "downgrade", "elevated"
        return "admit", None

    def preempt_victim(self, engine):
        """Pick one running slot to swap out for more-urgent queued
        work, or None. Fires only when `preempt` is on, the engine is
        OVERLOADED (uses the level from this step's assess — call
        after on_step), every slot is busy, and some queued request is
        STRICTLY more urgent than some running one. The victim is the
        least-urgent running request (largest priority number, then
        fewest generated tokens — minimal swapped state); requests
        below the shed floor, mid-replay, or already carrying a
        pending restart plan are never preempted."""
        if not self.preempt or self.level < 2:
            return None
        sched = engine.scheduler
        if sched.num_free > 0:
            return None
        queued = [r.priority for r in sched.queued_requests()]
        if not queued:
            return None
        best_queued = min(queued)
        victim = None
        for slot in sched.active_slots:
            req = sched.request_at(slot)
            if req is None or engine._pending[slot] is not None:
                continue             # mid-prefill/replay: let it land
            if req.priority <= self.shed_priority_floor:
                continue
            if req.priority <= best_queued:
                continue             # only yield to strictly more urgent
            if victim is None or (req.priority, -len(req.output_tokens)) \
                    > (victim[1].priority, -len(victim[1].output_tokens)):
                victim = (slot, req)
        return None if victim is None else victim[0]

    def on_step(self, engine, now):
        """Per-step degradation tick: latch after `degrade_after`
        consecutive overloaded assessments, clear after
        `recover_after` calm ones."""
        level = self.assess(engine)
        if level >= 2:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.degrade_after:
                engine._set_degraded(True, "overload")
        else:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.recover_after:
                engine._set_degraded(False)
        return level

    def snapshot(self):
        """JSON-able config+state for /statusz and flight dumps."""
        return {
            "ttft_slo_ms": self.ttft_slo_ms,
            "queue_low": self.queue_low,
            "queue_high": self.queue_high,
            "shed_priority_floor": self.shed_priority_floor,
            "deadline_headroom": self.deadline_headroom,
            "degrade_after": self.degrade_after,
            "recover_after": self.recover_after,
            "tenant_queue_share": self.tenant_queue_share,
            "preempt": self.preempt,
            "slo_eval_interval_s": self.slo_eval_interval_s,
            "slo_burning": list(self._slo_last[1])
            if self._slo_last else [],
            "level": self.level,
            "downgrades": self.downgrades,
        }
