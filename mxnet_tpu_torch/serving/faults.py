"""Seeded fault-injection harness for the serving engine.

Counterpart of mxnet_tpu/serving/faults.py: `FaultPlan`, `FaultError`
and `ReplicaFaultPlan` (a copy but for `_inject_nan`, which writes with
torch).

A `FaultPlan` is a deterministic, seed-driven schedule of faults
injected through the engine's existing `dispatch_hook` seam (the hook
fires at the top of every step and immediately before every prefill
and decode dispatch, with the requests about to be dispatched). The
chaos soak tests (tests/test_robustness.py) and the overload bench
drive the supervisor with it; nothing here runs in production paths.

Fault kinds (each an independent per-dispatch probability under one
`numpy` Generator, so a given seed + workload replays the same plan):

  * dispatch_exception — raise `FaultError` at a prefill/decode
    boundary: the supervisor must roll the batch back, requeue the
    innocents, and keep serving.
  * slow_dispatch      — sleep `slow_s` before the dispatch: exercises
    deadline cancellation and the flight-recorder stall watchdog
    without breaking anything.
  * nan_logits         — corrupt one victim slot's KV: a page the slot
    holds EXCLUSIVELY (never a shared/radix-tree page — the injected
    poison must not outlive the victim through the prefix cache) is
    filled with NaN, so the next forward produces non-finite logits
    for that slot and the engine's in-program finite guard must catch
    it, discard the dispatch's tokens for the slot, and re-prefill.
  * pool_exhaustion    — allocate (up to) all free pages and hold them
    for `exhaust_steps` steps: admissions fail with PagePoolExhausted
    and must retry without blaming the request.
  * alloc_failure      — arm the pool so its next alloc() raises: the
    transient-allocator-failure path, including the lease rollback in
    `_map_slot_pages`.
  * poison             — request ids whose every dispatch (or every
    dispatch of a given phase) raises: the supervisor must quarantine
    them after max_retries and keep every co-batched innocent's output
    bit-identical to a fault-free run.

`install(engine)` claims the engine's dispatch_hook and wraps
`page_pool.alloc`; `uninstall()` restores both and releases any held
pages. `counts` tallies the faults actually injected.

`ReplicaFaultPlan` is the fleet-level analogue: it claims a
`ServingRouter`'s `replica_hook` seam and injects replica-scoped
faults — kill (the replica's step raises, the router must fail it
over), hang (the replica silently stops making progress, the router's
stall watchdog must catch it), and persistent-degrade (the replica
keeps re-entering degraded state, so readiness-based routing must
route around it) — on explicit per-step schedules and/or seeded
per-step probabilities. Composing a per-replica `FaultPlan` with a
fleet `ReplicaFaultPlan` gives the whole-stack chaos soak.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["FaultPlan", "FaultError", "ReplicaFaultPlan"]


class FaultError(MXNetError):
    """An injected fault (never raised by production code). `kind`
    names the fault; the supervisor treats it like any other dispatch
    exception."""

    def __init__(self, kind, msg=""):
        super().__init__(msg or f"injected fault: {kind}")
        self.kind = kind


class FaultPlan:
    """Deterministic seed-driven fault schedule (module docstring).

    Probabilities are per hooked dispatch (prefill/decode boundary);
    `pool_exhaustion` draws once per step. `poison` is an iterable of
    request ids (fault at every phase) or a {request_id: phase} dict
    with phase in ("prefill", "decode", "both"). `max_faults` caps the
    total number of randomly injected faults (poison is exempt — it
    must keep failing past max_retries to be quarantined)."""

    def __init__(self, seed=0, dispatch_exception=0.0, slow_dispatch=0.0,
                 slow_s=0.001, nan_logits=0.0, pool_exhaustion=0.0,
                 exhaust_steps=3, exhaust_pages=None, alloc_failure=0.0,
                 poison=(), max_faults=None):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.dispatch_exception = float(dispatch_exception)
        self.slow_dispatch = float(slow_dispatch)
        self.slow_s = float(slow_s)
        self.nan_logits = float(nan_logits)
        self.pool_exhaustion = float(pool_exhaustion)
        self.exhaust_steps = int(exhaust_steps)
        self.exhaust_pages = exhaust_pages
        self.alloc_failure = float(alloc_failure)
        if isinstance(poison, dict):
            self.poison = {k: str(v) for k, v in poison.items()}
        else:
            self.poison = {rid: "both" for rid in poison}
        self.max_faults = max_faults
        self.counts = defaultdict(int)
        self._injected = 0         # randomly injected faults so far
        self._step = 0
        self._held = []            # [release_at_step, [pages]]
        self._alloc_armed = False
        self._engine = None
        self._orig_alloc = None

    # -- lifecycle ---------------------------------------------------------
    def install(self, engine):
        """Claim `engine.dispatch_hook` and wrap its pool's alloc()."""
        if self._engine is not None:
            raise MXNetError("FaultPlan is already installed")
        self._engine = engine
        engine.dispatch_hook = self.hook
        pool = engine.page_pool
        self._orig_alloc = pool.alloc

        def alloc(n):
            if self._alloc_armed:
                self._alloc_armed = False
                self.counts["alloc_failure"] += 1
                raise FaultError("alloc_failure",
                                 "injected transient allocator failure")
            return self._orig_alloc(n)

        pool.alloc = alloc
        return self

    def uninstall(self):
        """Restore the engine's hook and pool, release held pages."""
        eng = self._engine
        if eng is None:
            return
        if eng.dispatch_hook is self.hook:
            eng.dispatch_hook = None
        if self._orig_alloc is not None:
            eng.page_pool.alloc = self._orig_alloc
        self._release_held(force=True)
        self._engine = None
        self._orig_alloc = None

    # -- the hook ----------------------------------------------------------
    def _budget_left(self):
        return self.max_faults is None or self._injected < self.max_faults

    def _draw(self, p):
        if not p or not self._budget_left():
            return False
        if self._rng.random() >= p:
            return False
        self._injected += 1
        return True

    def _release_held(self, force=False):
        eng = self._engine
        keep = []
        for release_at, pages in self._held:
            if force or self._step >= release_at:
                eng.page_pool.free(eng.page_pool.decref(pages))
                eng.audit_extra_leases.remove(pages)
            else:
                keep.append([release_at, pages])
        self._held = keep

    def _exhaust(self, engine):
        free = engine.page_pool.num_free
        n = free if self.exhaust_pages is None \
            else min(int(self.exhaust_pages), free)
        if n < 1:
            return
        pages = self._orig_alloc(n)
        self._held.append([self._step + self.exhaust_steps, pages])
        # register the hold so the supervisor's audit can account for
        # refcounts no slot table explains
        engine.audit_extra_leases.append(pages)
        self.counts["pool_exhaustion"] += 1

    def _inject_nan(self, engine):
        """NaN one exclusive, non-tree page of one active slot (the
        first page with readable positions that no other slot or the
        radix tree can see), every layer of its k slab. Skips silently
        when no slot has one. An int8 pool cannot hold a NaN: as in the
        reference, the conversion raises ValueError (which the
        supervisor then catches as a dispatch fault)."""
        ref = engine.page_pool.refcounts()
        member = engine.prefix_cache.member_mask() \
            if engine.prefix_cache is not None \
            else np.zeros(engine.page_pool.num_pages, bool)
        S = engine.page_size
        cands = []
        for slot in engine.scheduler.active_slots:
            length = int(engine._lengths[slot])
            for i in range((length + S - 1) // S):
                p = int(engine._table_host[slot][i])
                if ref[p] == 1 and not member[p]:
                    cands.append(p)
                    break
        if not cands:
            return
        page = cands[int(self._rng.integers(len(cands)))]
        if not engine._kp.dtype.is_floating_point:
            np.asarray(np.nan, np.int8)        # raises, as jnp does
        for kp, _, _, _ in engine._pools:    # every shard's heads
            kp[:, page] = torch.nan
        self.counts["nan_logits"] += 1

    def hook(self, engine, phase="step", requests=()):
        if phase == "step":
            self._step += 1
            self._release_held()
            if self._draw(self.pool_exhaustion) and not self._held:
                self._exhaust(engine)
            return
        for r in requests:
            ph = self.poison.get(getattr(r, "id", None))
            if ph is not None and ph in ("both", phase):
                self.counts["poison"] += 1
                raise FaultError(
                    "poison", f"injected poison dispatch for request "
                              f"{r.id} ({phase})")
        if self._draw(self.slow_dispatch):
            self.counts["slow_dispatch"] += 1
            time.sleep(self.slow_s)
        if phase == "prefill" and self._draw(self.alloc_failure):
            self._alloc_armed = True       # the next pool.alloc raises
        if phase == "decode" and self._draw(self.nan_logits):
            self._inject_nan(engine)
        if self._draw(self.dispatch_exception):
            self.counts["dispatch_exception"] += 1
            raise FaultError("dispatch_exception",
                             f"injected dispatch exception ({phase})")

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, injected={self._injected}, "
                f"counts={dict(self.counts)})")


def _schedule(spec):
    """Normalize {step: replica | [replicas]} / [(step, replica)] into
    {step: [replicas]}."""
    out = {}
    items = spec.items() if isinstance(spec, dict) else spec
    for step, who in items:
        idxs = [who] if isinstance(who, int) else list(who)
        out.setdefault(int(step), []).extend(int(i) for i in idxs)
    return out


class ReplicaFaultPlan:
    """Deterministic replica-level fault schedule for a ServingRouter
    (module docstring). Steps count ROUTER steps (the fleet tick fires
    once per `router.step()`).

    kill / hang / degrade: explicit schedules — {step: replica} (or a
        list of replicas, or [(step, replica), ...]). A kill makes the
        replica's next step raise FaultError("replica_kill"); a hang
        freezes it (the hook answers "skip" — no engine.step() — for
        `hang_ticks` router steps, or forever with hang_ticks=None);
        degrade re-asserts `_set_degraded(True)` on the replica every
        tick from then on — a persistent fault that readiness-based
        placement must route around, not a one-shot blip.
    kill_p / hang_p: additional per-replica per-step probabilities
        under the plan's seeded Generator (a given seed + fleet replays
        the same chaos). `max_faults` caps the RANDOM faults only;
        scheduled ones always fire.
    """

    def __init__(self, seed=0, kill=(), hang=(), degrade=(),
                 hang_ticks=40, kill_p=0.0, hang_p=0.0,
                 max_faults=None):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.kill = _schedule(kill)
        self.hang = _schedule(hang)
        self.degrade = _schedule(degrade)
        self.hang_ticks = hang_ticks
        self.kill_p = float(kill_p)
        self.hang_p = float(hang_p)
        self.max_faults = max_faults
        self.counts = defaultdict(int)
        self._injected = 0
        self._step = 0
        self._pending_kill = set()     # replica idxs to kill on touch
        self._hung_until = {}          # replica idx -> last hung step
        self._degraded = set()         # replica idxs under degrade
        self._router = None

    # -- lifecycle ---------------------------------------------------------
    def install(self, router):
        """Claim `router.replica_hook`."""
        if self._router is not None:
            raise MXNetError("ReplicaFaultPlan is already installed")
        self._router = router
        router.replica_hook = self.hook
        return self

    def uninstall(self):
        """Restore the router's hook; scheduled state stays as-is
        (a killed replica is the router's to rejoin())."""
        router = self._router
        if router is None:
            return
        if router.replica_hook is self.hook:
            router.replica_hook = None
        self._router = None

    # -- the hook ----------------------------------------------------------
    def _budget_left(self):
        return self.max_faults is None or self._injected < self.max_faults

    def _draw(self, p):
        if not p or not self._budget_left():
            return False
        if self._rng.random() >= p:
            return False
        self._injected += 1
        return True

    def _start_hang(self, idx):
        until = None if self.hang_ticks is None \
            else self._step + int(self.hang_ticks)
        self._hung_until[idx] = until
        self.counts["hang"] += 1

    def hook(self, router, idx, engine):
        if idx is None:                 # fleet tick
            self._step += 1
            for i in self.kill.get(self._step, ()):
                self._pending_kill.add(i)
            for i in self.hang.get(self._step, ()):
                self._start_hang(i)
            for i in self.degrade.get(self._step, ()):
                self._degraded.add(i)
                self.counts["degrade"] += 1
            up = [i for i, rep in enumerate(router.replicas)
                  if rep.state == "up"]
            # at most one random fault per tick: a seeded draw should
            # not take the whole fleet down in one step
            for i in up:
                if self._draw(self.kill_p):
                    self._pending_kill.add(i)
                    break
                if self._draw(self.hang_p):
                    self._start_hang(i)
                    break
            return None
        if idx in self._degraded:
            # persistent-degrade: re-assert every tick — the engine's
            # flight-recorder rearm must not bring it back
            engine._set_degraded(True, "injected persistent degrade")
        if idx in self._pending_kill:
            self._pending_kill.discard(idx)
            self._hung_until.pop(idx, None)
            self.counts["kill"] += 1
            raise FaultError("replica_kill",
                             f"injected replica kill (replica {idx}, "
                             f"router step {self._step})")
        until = self._hung_until.get(idx, -1)
        if until is None or until > self._step:
            self.counts["hang_ticks"] += 1
            return "skip"               # frozen: no step, no progress
        return None

    def __repr__(self):
        return (f"ReplicaFaultPlan(seed={self.seed}, step={self._step}, "
                f"counts={dict(self.counts)})")
