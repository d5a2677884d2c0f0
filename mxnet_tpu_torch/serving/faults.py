"""Seeded fault-injection harness for the serving engine.

Counterpart of mxnet_tpu/serving/faults.py: `FaultPlan` and `FaultError`
(a copy but for `_inject_nan`, which writes with torch). The fleet-level
`ReplicaFaultPlan` waits for the router, which is not ported yet.

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
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["FaultPlan", "FaultError"]


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
        engine._kp[:, page] = torch.nan
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
