"""Front-of-house router over N in-process ServingEngine replicas.

Counterpart of mxnet_tpu/serving/router.py, a copy but for one rule: a
CUDA or kernel error out of a replica (the engine's fatal class,
`engine._fatal`) is not a replica death. Every replica shares one
process, one CUDA context and, as a rule, one model: a sticky CUDA
error poisons the survivors too, and a kernel that does not build or
launch fails again on them. So `step()` re-raises such an error (the
failing engine has latched it, never ready again) and migrates
nothing; a frontend over the router then ends its streams with
`backend_failed`. Any other exception out of a replica is its death,
as in the reference.

One engine is one point of failure: a wedged or killed replica takes
every queued and in-flight request with it. `ServingRouter` fronts a
fleet (docs/SERVING.md "Multi-replica serving & failover"):

  * PLACEMENT — radix-prefix affinity: the first page of prompt tokens
    is rendezvous-hashed over the routable replicas, so requests that
    share a prompt prefix land on the replica that already holds its
    pages (multiplying the prefix cache's hit rate under multi-user
    traffic), with load-aware SPILL to the least-loaded ready replica
    when the affinity target's queue is deep. Routable = up, not
    draining, not degraded (and warmed, when require_warm=True) — the
    same conjunction /readyz serves.
  * SUPERVISION — a replica whose step() raises is declared dead
    ("kill"); a busy replica whose dispatch-progress counters freeze
    for `watchdog_ticks` consecutive router steps is declared wedged
    ("stall"; the same progress probe the flight-recorder watchdog
    uses). Either way the router latches ONE flight dump per failure
    (`replica_down:engine<id>`), exports every queued and in-flight
    request off the corpse host-side, and MIGRATES them to survivors.
    A migrated request re-prefills prompt+emitted with its RNG counter
    resumed (ServingEngine.adopt — the restart continuation), so its
    output is bit-identical to a fault-free run: a replica failure
    loses zero accepted requests while a survivor exists.
  * HEDGING — a request still unfinished after a p99-derived delay is
    duplicated to a second replica. Identical RNG streams mean both
    copies emit identical tokens, so the first finisher simply wins
    and the loser is cancelled (ServingEngine.cancel). Hedges won /
    wasted are counted separately: a wasted hedge is the price of the
    tail-latency insurance.
  * ROLLING RESTART — drain(i) closes one replica's admission
    (ShedError(reason="draining") with a drain-time retry estimate),
    optionally migrates its backlog, and rejoin(i) returns it to the
    rotation after mark_warm().

Shed accounting is two-level by construction: a replica that rejects
counts its own serving_shed_total; the router counts router_shed_total
ONLY when no replica accepted — candidate replicas are pre-screened
(queue bounds, overload level) before submit is attempted, so one
rejected request never lands in both families. The aggregated
rejection carries retry_after_s = min over the replicas' estimates.

Everything is single-threaded and deterministic: step() drives each
replica in order, the watchdog counts router steps, and the chaos
harness (serving/faults.py ReplicaFaultPlan) injects kill/hang/degrade
through the `replica_hook` seam — the fleet-level analogue of the
engine's dispatch_hook.
"""
from __future__ import annotations

import itertools
import time
import zlib
from collections import deque

import numpy as np

from .. import telemetry
from ..base import MXNetError
from ..analysis import loop_only
from .engine import _fatal
from .scheduler import (QueueFullError, RejectedError, Request,
                        ShedError)

__all__ = ["ServingRouter"]

_router_ids = itertools.count()

# Router metrics are per-router labeled children (router=<ordinal>) of
# process-global families, mirroring the per-engine convention.
# docs/OBSERVABILITY.md catalogs each one.
_R = ("router",)


def _router_metrics(rid):
    c, g = telemetry.counter, telemetry.gauge
    m = {
        "requests": c("router_requests_total",
                      "requests the router accepted and placed on a "
                      "replica", _R),
        "affinity": c("router_routed_affinity_total",
                      "placements on the prefix-affinity replica", _R),
        "spill": c("router_routed_spill_total",
                   "placements spilled off the affinity replica "
                   "(not routable, or load-aware spill)", _R),
        "migrated": c("router_migrated_requests_total",
                      "queued/in-flight requests moved to a survivor "
                      "after a replica failure or drain", _R),
        "hedges": c("router_hedges_total",
                    "straggler requests duplicated to a second "
                    "replica", _R),
        "hedges_won": c("router_hedges_won_total",
                        "hedges that finished first (primary copy "
                        "cancelled)", _R),
        "hedges_wasted": c("router_hedges_wasted_total",
                           "hedges the primary beat (duplicate "
                           "cancelled — the insurance premium)", _R),
        "drains": c("router_drains_total",
                    "replica drains initiated (rolling restarts)", _R),
        "replicas": g("router_replicas",
                      "replicas fronted by this router", _R),
        "replicas_ready": g("router_replicas_ready",
                            "replicas currently routable (up, not "
                            "draining, not degraded, warmed when "
                            "required)", _R),
    }
    _down_family()
    _router_shed_family()
    return {k: inst.labels(rid) for k, inst in m.items()}


def _down_family():
    return telemetry.counter(
        "router_replica_down_total",
        "replicas declared failed, by reason (kill = step() raised "
        "out of the replica; stall = the watchdog saw a busy replica "
        "make no dispatch progress for watchdog_ticks router steps)",
        ("router", "reason"))


def _router_shed_family():
    return telemetry.counter(
        "router_shed_total",
        "requests the ROUTER shed because no replica could accept "
        "them (replica-level sheds count in serving_shed_total; a "
        "request never lands in both families)", ("router", "reason"))


class _Replica:
    """Router-side state for one fronted engine."""

    __slots__ = ("engine", "state", "down_reason", "last_progress",
                 "stall_ticks")

    def __init__(self, engine):
        self.engine = engine
        self.state = "up"            # "up" | "down"
        self.down_reason = None
        self.last_progress = None
        self.stall_ticks = 0


class ServingRouter:
    """Health-supervising, prefix-affinity router over ServingEngine
    replicas (module docstring).

    replicas: the engines to front (they should share one model and
        one injectable clock with the router for coherent deadlines).
    hedge_after_s: fixed hedge delay; None derives it from the p99 of
        observed request latencies (x hedge_factor) once
        hedge_min_samples finishes landed — no hedging before that.
    spill_queue: affinity-replica queue depth that triggers load-aware
        spill (default: that replica's num_slots).
    watchdog_ticks: consecutive no-progress-while-busy router steps
        before a replica is declared stalled.
    require_warm: when True, only warmed (mark_warm()) replicas are
        routable — production fleets warm before joining; tests and
        benches that compile lazily leave it False.
    """

    def __init__(self, replicas, *, hedge_after_s=None, hedge_factor=1.0,
                 hedge_min_samples=16, spill_queue=None,
                 watchdog_ticks=25, require_warm=False, clock=None):
        replicas = list(replicas)
        if not replicas:
            raise MXNetError("ServingRouter needs at least one replica")
        if len({id(e) for e in replicas}) != len(replicas):
            raise MXNetError("each replica must be a distinct engine")
        self.replicas = [_Replica(e) for e in replicas]
        self.hedge_after_s = hedge_after_s
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_samples = int(hedge_min_samples)
        self.spill_queue = spill_queue
        self.watchdog_ticks = int(watchdog_ticks)
        if self.watchdog_ticks < 2:
            raise MXNetError("watchdog_ticks must be >= 2")
        self.require_warm = bool(require_warm)
        self._clock = clock if clock is not None else time.perf_counter
        # affinity key: the first page of prompt tokens — requests
        # sharing at least one full page share their hash key
        self._affinity_tokens = min(e.page_size for e in replicas)
        self._rid = str(next(_router_ids))
        self._metrics = _router_metrics(self._rid)
        self._down = _down_family()
        self._rshed = _router_shed_family()
        self._down_counts = {}       # reason -> n (host-side)
        self._shed_counts = {}       # reason -> n (host-side)
        self._metrics["replicas"].set(len(self.replicas))
        self._owner = {}             # request id -> (replica idx, Request)
        self._t_submit = {}          # request id -> router-clock submit
        self._hedges = {}            # original id -> (replica idx, clone)
        self._clone_to_orig = {}     # clone id -> original id
        self._lat = deque(maxlen=256)   # finished-request latencies
        self._pending = []           # terminals minted outside step order
        # chaos seam (serving/faults.py ReplicaFaultPlan): called once
        # per step with (router, None, None) — the fleet tick — and
        # once per up replica with (router, idx, engine) right before
        # its step(). May raise (the router treats it as the replica
        # dying) or return "skip" (the replica makes no progress this
        # tick — a wedged dispatch the watchdog must catch).
        self.replica_hook = None
        telemetry.register_status_provider(
            f"router/{self._rid}", self._statusz)
        self._set_gauges()

    # -- telemetry ---------------------------------------------------------
    @property
    def stats(self):
        m = self._metrics
        return {
            "requests": int(m["requests"].value),
            "affinity": int(m["affinity"].value),
            "spill": int(m["spill"].value),
            "migrated": int(m["migrated"].value),
            "hedges": int(m["hedges"].value),
            "hedges_won": int(m["hedges_won"].value),
            "hedges_wasted": int(m["hedges_wasted"].value),
            "drains": int(m["drains"].value),
            "replicas": len(self.replicas),
            "replicas_ready": len(self._routable()),
            "replica_down": dict(self._down_counts),
            "shed": dict(self._shed_counts),
        }

    def _statusz(self):
        reps = []
        for idx, rep in enumerate(self.replicas):
            eng = rep.engine
            reps.append({
                "engine": eng._eid,
                "state": rep.state,
                "down_reason": rep.down_reason,
                "routable": self._is_routable(idx),
                "warmed": eng.warmed,
                "degraded": eng._degraded,
                "draining": eng.draining,
                "queued": eng.scheduler.num_queued,
                "active": eng.scheduler.num_active,
                "stall_ticks": rep.stall_ticks,
            })
        return {
            "config": {
                "num_replicas": len(self.replicas),
                "hedge_after_s": self.hedge_after_s,
                "hedge_factor": self.hedge_factor,
                "hedge_min_samples": self.hedge_min_samples,
                "spill_queue": self.spill_queue,
                "watchdog_ticks": self.watchdog_ticks,
                "require_warm": self.require_warm,
                "affinity_tokens": self._affinity_tokens,
            },
            "hedge_delay_s": self._hedge_delay(),
            "in_flight": len(self._owner),
            "hedges_in_flight": len(self._hedges),
            "replicas": reps,
            "stats": self.stats,
        }

    def _set_gauges(self):
        self._metrics["replicas_ready"].set(len(self._routable()))

    def _shed_inc(self, reason):
        self._rshed.labels(self._rid, reason).inc()
        self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1

    # -- placement ---------------------------------------------------------
    def _is_routable(self, idx):
        rep = self.replicas[idx]
        eng = rep.engine
        return (rep.state == "up" and not eng.draining
                and not eng._degraded
                and (eng.warmed or not self.require_warm))

    def _routable(self):
        return [i for i in range(len(self.replicas))
                if self._is_routable(i)]

    def _load(self, idx):
        s = self.replicas[idx].engine.scheduler
        return s.num_queued + s.num_active

    def _affinity_idx(self, request, candidates):
        """Rendezvous (highest-random-weight) hash of the prompt's
        first page of tokens over the candidate replicas: deterministic
        for a given prefix, and stable — a replica leaving the set only
        moves the keys it owned. The adapter id folds into the key so
        same-adapter traffic co-locates and replicas don't each page in
        every adapter; null-adapter requests hash exactly as before."""
        key = np.asarray(request.prompt[:self._affinity_tokens],
                         np.int32).tobytes()
        if request.adapter_id not in (None, 0):
            key += b"|adapter:" + repr(request.adapter_id).encode()
        best, best_w = None, -1
        for i in candidates:
            w = zlib.crc32(key + b"/%d" % i)
            if w > best_w:
                best, best_w = i, w
        return best

    def _placement_order(self, request, candidates):
        """(ordered candidate list, affinity idx): affinity target
        first unless load-aware spill kicks in — its queue at/over
        spill_queue AND a strictly less-loaded alternative exists."""
        aff = self._affinity_idx(request, candidates)
        others = sorted((i for i in candidates if i != aff),
                        key=lambda i: (self._load(i), i))
        eng = self.replicas[aff].engine
        spill_at = self.spill_queue if self.spill_queue is not None \
            else eng.num_slots
        if others and eng.scheduler.num_queued >= spill_at \
                and self._load(others[0]) < self._load(aff):
            return others + [aff], aff
        return [aff] + others, aff

    def _wait_of(self, idx):
        eng = self.replicas[idx].engine
        return eng.estimated_drain_wait() if eng.draining \
            else eng.estimated_queue_wait()

    def _can_accept(self, idx, request):
        """Pre-screen one replica without side effects: the predicted
        rejection reason, or None when submit should succeed. Screening
        keeps a doomed submit from counting a replica-level shed for a
        request the router is still trying to place elsewhere."""
        eng = self.replicas[idx].engine
        sched = eng.scheduler
        pr = min(max(int(request.priority), 0),
                 sched.num_priorities - 1)
        bound = sched._bounds[pr]
        if bound is not None and len(sched._queues[pr]) >= bound:
            return "queue_full"
        pol = eng.policy
        if pol is not None and pol.assess(eng) >= 2 \
                and pr > pol.shed_priority_floor:
            return "overload"
        return None

    def _reject_all(self, request, fails):
        """Router-level rejection: every replica refused (or none was
        routable). retry_after_s is the MIN over the replicas'
        estimates — the earliest any of them could accept — and the
        shed counts ONLY in router_shed_total (replica-level sheds,
        when a submit was actually attempted, already counted
        theirs)."""
        waits = [w for _, _, w in fails if w is not None]
        wait = min(waits) if waits else None
        reasons = [r for _, r, _ in fails]
        if not reasons:
            reason = "no_ready_replica"
        elif all(r == "queue_full" for r in reasons):
            reason = "queue_full"
        else:
            reason = next(r for r in reasons if r != "queue_full")
        depth = sum(r.engine.scheduler.num_queued
                    for r in self.replicas)
        active = sum(r.engine.scheduler.num_active
                     for r in self.replicas)
        request.status = "shed"
        if request.t_submit is None:
            request.t_submit = self._clock()
        self._shed_inc(reason)
        telemetry.flight.note_shed(f"router{self._rid}")
        telemetry.request_log.terminal(
            request.id, f"router{self._rid}", "rejected",
            reason=reason, priority=request.priority,
            queue_depth=depth, active_slots=active,
            retry_after_s=None if wait is None else round(wait, 4))
        msg = (f"request {request.id} rejected by all "
               f"{len(self.replicas)} replicas ({reason}) "
               f"[queue_depth={depth}, active_slots={active}"
               + (f", retry_after~{wait:.3f}s" if wait is not None
                  else "") + "]")
        cls = QueueFullError if reason == "queue_full" else ShedError
        raise cls(msg, reason=reason, queue_depth=depth,
                  active_slots=active, retry_after_s=wait,
                  priority=request.priority)

    # -- public API --------------------------------------------------------
    @loop_only
    def submit(self, request):
        """Place one request: prefix-affinity target first (load-aware
        spill and pre-screening may reorder), remaining routable
        replicas by load. Raises the aggregated QueueFullError/
        ShedError when nobody accepts."""
        candidates = self._routable()
        if not candidates:
            self._reject_all(request, [])
        order, aff = self._placement_order(request, candidates)
        fails = []
        for idx in order:
            why = self._can_accept(idx, request)
            if why is not None:
                fails.append((idx, why, self._wait_of(idx)))
                continue
            eng = self.replicas[idx].engine
            try:
                eng.submit(request)
            except RejectedError as e:
                fails.append((idx, e.reason or "rejected",
                              e.retry_after_s
                              if e.retry_after_s is not None
                              else self._wait_of(idx)))
                continue
            self._owner[request.id] = (idx, request)
            self._t_submit[request.id] = self._clock()
            m = self._metrics
            m["requests"].inc()
            (m["affinity"] if idx == aff else m["spill"]).inc()
            return request
        self._reject_all(request, fails)

    @loop_only
    def cancel(self, request_id):
        """Cancel a routed request (and any hedge duplicate of it)
        wherever it lives. Returns the Request, or None."""
        h = self._hedges.pop(request_id, None)
        if h is not None:
            hidx, clone = h
            self._clone_to_orig.pop(clone.id, None)
            try:
                self.replicas[hidx].engine.cancel(clone.id)
            except Exception:     # noqa: BLE001 — replica may be dead
                pass
        owner = self._owner.pop(request_id, None)
        self._t_submit.pop(request_id, None)
        if owner is None:
            return None
        idx, req = owner
        try:
            return self.replicas[idx].engine.cancel(request_id) or req
        except Exception:         # noqa: BLE001 — replica may be dead
            return req

    @property
    def has_work(self):
        return bool(self._pending) or any(
            rep.state == "up" and rep.engine.has_work
            for rep in self.replicas)

    @loop_only
    def step(self):
        """One fleet scheduling round: fire the chaos tick, step every
        up replica (its exceptions mean the REPLICA died — requests
        are exported and migrated — except a CUDA or kernel error,
        which propagates, nothing migrated), advance the stall
        watchdog, then launch any due hedges. Returns this round's
        terminal requests (originals only — hedge clones resolve into
        their originals)."""
        now = self._clock()
        out = list(self._pending)
        self._pending = []
        self._fire_hook(None, None)
        for idx, rep in enumerate(self.replicas):
            if rep.state != "up":
                continue
            eng = rep.engine
            try:
                act = self._fire_hook(idx, eng)
                if act != "skip":
                    for req in eng.step():
                        out.extend(self._resolve(idx, req))
            except Exception as e:   # noqa: BLE001 — fleet supervisor
                if _fatal(e):
                    raise           # the card's, not the replica's
                self._replica_down(idx, "kill", e)
                continue
            progress, busy = eng._flight_probe()
            if busy and rep.last_progress is not None \
                    and progress == rep.last_progress:
                rep.stall_ticks += 1
            else:
                rep.stall_ticks = 0
            rep.last_progress = progress
            if rep.stall_ticks >= self.watchdog_ticks:
                self._replica_down(idx, "stall")
        self._maybe_hedge(now)
        out.extend(self._pending)
        self._pending = []
        self._set_gauges()
        return out

    @loop_only
    def serve(self, requests=()):
        """Submit `requests` (router-rejected ones come back with
        status "shed"), run the fleet until it drains, and return
        every terminal request in submission order."""
        done = []
        for r in requests:
            try:
                self.submit(r)
            except (QueueFullError, ShedError):
                done.append(r)
        while self.has_work:
            done.extend(self.step())
        done.sort(key=lambda r: (r.t_submit is None, r.t_submit))
        return done

    @loop_only
    def drain(self, replica, migrate=False):
        """Begin a rolling restart of one replica: admission closes
        (new submits route around it; direct submits shed with
        reason="draining"), in-flight work finishes — or, with
        migrate=True, is exported and adopted by survivors
        immediately. Rejoin with rejoin() after mark_warm()."""
        rep = self.replicas[int(replica)]
        rep.engine.drain()
        self._metrics["drains"].inc()
        if migrate:
            moved = rep.engine.export_requests()
            self._migrate(moved, from_eid=rep.engine._eid)
        self._set_gauges()

    @loop_only
    def rejoin(self, replica):
        """Return a drained (or previously failed) replica to the
        rotation: admission reopens and the watchdog re-arms. The
        caller is responsible for the replica actually being servable
        (warmed via mark_warm() when require_warm is set)."""
        rep = self.replicas[int(replica)]
        rep.engine.undrain()
        rep.state = "up"
        rep.down_reason = None
        rep.stall_ticks = 0
        rep.last_progress = None
        self._set_gauges()

    # -- failover ----------------------------------------------------------
    def _replica_down(self, idx, reason, exc=None):
        """Declare one replica failed: latch ONE flight dump
        (replica_down:engine<id>), close its admission, export its
        queued + in-flight requests host-side, and migrate them."""
        rep = self.replicas[idx]
        if rep.state == "down":
            return
        rep.state = "down"
        rep.down_reason = reason
        eng = rep.engine
        self._down.labels(self._rid, reason).inc()
        self._down_counts[reason] = \
            self._down_counts.get(reason, 0) + 1
        detail = (f"router{self._rid}: replica engine{eng._eid} "
                  f"declared down ({reason})")
        if exc is not None:
            detail += f": {type(exc).__name__}: {exc}"
        telemetry.flight.record("replica_down", router=self._rid,
                                engine=eng._eid, reason=reason)
        telemetry.flight.trigger(f"replica_down:engine{eng._eid}",
                                 detail)
        try:
            eng.drain()           # a dead replica must read not-ready
        except Exception:         # noqa: BLE001
            pass
        try:
            moved = eng.export_requests()
        except Exception:         # noqa: BLE001 — wedged beyond export
            moved = []
        self._migrate(moved, from_eid=eng._eid)
        self._set_gauges()

    def _migrate(self, moved, from_eid):
        """Re-home exported requests onto survivors (affinity first —
        the survivor holding the prefix pages — then by load). adopt()
        preserves emitted tokens, so migrated outputs stay
        bit-identical. With no adoptive survivor the request ends
        status "shed" with a structured ShedError on `.error`."""
        for req in moved:
            oid = self._clone_to_orig.pop(req.id, None)
            if oid is not None:
                # a hedge clone died with its replica: the original is
                # still running — the hedge is simply lost
                self._hedges.pop(oid, None)
                continue
            candidates = self._routable()
            order = []
            if candidates:
                order, _ = self._placement_order(req, candidates)
            placed = False
            for idx in order:
                try:
                    self.replicas[idx].engine.adopt(
                        req, migrated_from=f"engine{from_eid}")
                except Exception:   # noqa: BLE001 — try the next one
                    continue
                self._owner[req.id] = (idx, req)
                self._metrics["migrated"].inc()
                placed = True
                break
            if not placed:
                waits = [self._wait_of(i)
                         for i in range(len(self.replicas))]
                waits = [w for w in waits if w is not None]
                req.status = "shed"
                req.error = ShedError(
                    f"request {req.id} lost its replica and no "
                    f"survivor could adopt it",
                    reason="no_ready_replica",
                    retry_after_s=min(waits) if waits else None,
                    priority=req.priority)
                self._shed_inc("no_ready_replica")
                telemetry.flight.note_shed(f"router{self._rid}")
                self._owner.pop(req.id, None)
                self._t_submit.pop(req.id, None)
                if req.stream is not None:
                    # export detached the request from its engine, so
                    # no terminal transition will close the subscriber
                    # stream — this is the end of the line, wake the
                    # front-end reader
                    try:
                        req.stream.close("shed")
                    except Exception:   # noqa: BLE001 — subscriber
                        pass
                self._pending.append(req)

    # -- hedging -----------------------------------------------------------
    def _hedge_delay(self):
        if self.hedge_after_s is not None:
            return float(self.hedge_after_s)
        n = len(self._lat)
        if n < self.hedge_min_samples:
            return None
        lat = sorted(self._lat)
        return lat[min(n - 1, int(0.99 * n))] * self.hedge_factor

    def _maybe_hedge(self, now):
        delay = self._hedge_delay()
        if delay is None:
            return
        for oid, (idx, req) in list(self._owner.items()):
            if oid in self._hedges:
                continue
            t0 = self._t_submit.get(oid)
            if t0 is None or now - t0 < delay:
                continue
            if req.status not in ("queued", "running"):
                continue
            cands = [i for i in self._routable() if i != idx]
            if not cands:
                continue
            tgt = min(cands, key=lambda i: (self._load(i), i))
            clone = Request(
                req.prompt, req.max_new_tokens,
                request_id=f"hedge:{oid}", do_sample=req.do_sample,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed,
                eos_token_id=req.eos_token_id, priority=req.priority,
                deadline_ms=req.deadline_ms, adapter_id=req.adapter_id,
                tenant=req.tenant,
                # the clone races the SAME logical request — it shares
                # the original's trace id so both attempts correlate
                # to one distributed trace
                trace=dict(req.trace) if req.trace else None)
            try:
                self.replicas[tgt].engine.submit(clone)
            except RejectedError:
                continue
            self._hedges[oid] = (tgt, clone)
            self._clone_to_orig[clone.id] = oid
            self._metrics["hedges"].inc()
            telemetry.request_log.event(
                oid, self.replicas[idx].engine._eid, "hedged",
                to=f"engine{self.replicas[tgt].engine._eid}",
                after_s=round(now - t0, 4))

    def _resolve(self, idx, req):
        """Fold one replica-terminal request into router state.
        Returns the user-visible terminals it produced ([] when a
        hedge clone lost or resolved into its original)."""
        oid = self._clone_to_orig.pop(req.id, None)
        if oid is not None:
            h = self._hedges.pop(oid, None)
            owner = self._owner.get(oid)
            if h is None or owner is None:
                return []            # original already resolved
            if req.status != "finished":
                return []            # clone shed/failed — primary runs on
            # the hedge WON: identical RNG streams mean its tokens are
            # exactly what the primary would have emitted — graft them,
            # cancel the primary copy. The subscriber stream is
            # detached first so the primary's cancel can't close it
            # "cancelled"; the front-end reconciles the grafted token
            # tail from the Request, then sees the "finished" close.
            pidx, orig = owner
            st, orig.stream = orig.stream, None
            try:
                self.replicas[pidx].engine.cancel(oid)
            except Exception:        # noqa: BLE001 — replica may be dead
                pass
            orig.output_tokens = list(req.output_tokens)
            orig.status = "finished"
            orig.t_finish = req.t_finish
            if st is not None:
                orig.stream = st
                try:
                    st.close("finished")
                except Exception:    # noqa: BLE001 — subscriber
                    pass
            self._metrics["hedges_won"].inc()
            self._owner.pop(oid, None)
            self._note_done(orig)
            return [orig]
        h = self._hedges.pop(req.id, None)
        if h is not None:
            hidx, clone = h
            self._clone_to_orig.pop(clone.id, None)
            try:
                self.replicas[hidx].engine.cancel(clone.id)
            except Exception:        # noqa: BLE001 — replica may be dead
                pass
            self._metrics["hedges_wasted"].inc()
        self._owner.pop(req.id, None)
        self._note_done(req)
        return [req]

    def _note_done(self, req):
        t0 = self._t_submit.pop(req.id, None)
        if t0 is not None and req.status == "finished":
            self._lat.append(self._clock() - t0)

    # -- chaos seam --------------------------------------------------------
    def _fire_hook(self, idx, engine):
        hook = self.replica_hook
        if hook is None:
            return None
        return hook(self, idx, engine)

    def __repr__(self):
        up = sum(r.state == "up" for r in self.replicas)
        return (f"ServingRouter(replicas={len(self.replicas)}, up={up}, "
                f"in_flight={len(self._owner)})")
