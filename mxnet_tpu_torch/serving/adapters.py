"""Paged LoRA adapter pool: many fine-tuned variants over one base model.

Counterpart of mxnet_tpu/serving/adapters.py. The engine serves ONE
resident base model; fine-tuned variants are low-rank (A, B) deltas on
the four attention projections (query/key/value/proj) of every layer.
``AdapterPool`` packs the deltas of up to ``slots - 1`` adapters into one
device-resident slab (slot 0 is the NULL adapter: all zeros, scale 0),
each adapter's rank zero-padded to a fixed ``max_rank`` so the slab has
one shape forever:

    A     (4, num_layers, slots, units, max_rank)   model dtype or int8
    B     (4, num_layers, slots, max_rank, units)   model dtype or int8
    scale (slots,)                                  float32 = alpha/rank

In the batched forward each row gathers its own slab slot
(models/gpt2.py, `AdapterBatch`), so which adapter a slot wears is data
(one more per-slot int in the engine's device state), never a shape.
With ``dtype="int8"`` the slab holds int8 codes with one absmax/127
float32 scale per (projection, layer, slot) beside it.

Residency is a host-side ref-counted ledger over slab slots, as the
page pool is over pages: ``register`` keeps host weights, ``acquire``
pins an adapter for a slot's lifetime and pages it in on a miss (an
in-place copy into one slab slot, LRU-evicting an unpinned resident
when the slab is full), raising ``AdapterPoolExhausted`` when every
slot is pinned (backpressure in the engine, like PagePoolExhausted);
``release`` drops a pin; ``audit`` checks the invariants.

Under tensor parallelism (``shard_batches``) each shard reads its slices
of the slab: A split on its U axis, B on its out axis (the head-aligned
split of the base weights, so each shard's delta lands in its projection
before the reduction), the scales whole. The slices are cached by the
slab's identity and page-in count, so a page-in replaces them whole; on
the slab's own device they are views and cost no copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis import loop_only, thread_safe
from ..base import MXNetError, resolve_device
from ..models.gpt2 import _DTYPES, AdapterBatch
from ..parallel.mesh import place

__all__ = ["AdapterPool", "AdapterPoolExhausted", "random_lora",
           "merged_weights"]

# projection axis order of the slab's leading dim — gpt2.py indexes it
PROJ = ("query", "key", "value", "proj")


class AdapterPoolExhausted(MXNetError):
    """acquire() found every slab slot pinned by an active request. A
    distinct type because the engine treats exhaustion as BACKPRESSURE
    (requeue the admission and retry once a slot drains), exactly like
    PagePoolExhausted."""


def random_lora(config, rank, alpha=None, seed=0, scale=0.02):
    """Host-side random LoRA weights for tests/benches: dict with
    ``A`` (4, L, units, rank), ``B`` (4, L, rank, units), ``alpha``,
    ``rank``.  B is deliberately non-zero (real checkpoints start B=0,
    which would make every adapter a no-op oracle)."""
    rng = np.random.default_rng(seed)
    L, U = config.num_layers, config.units
    return {
        "A": rng.normal(0.0, scale, (4, L, U, rank)).astype(np.float32),
        "B": rng.normal(0.0, scale, (4, L, rank, U)).astype(np.float32),
        "alpha": float(alpha if alpha is not None else rank),
        "rank": int(rank),
    }


def merged_weights(base_w, weights, proj, layer):
    """Dense merged-weight oracle for one projection of one layer:
    ``W + (B A)^T * alpha/rank`` on the host.  ``base_w`` is the Dense
    kernel ((units, units), out-major as Dense stores it); the delta
    transposes because the forward computes x @ A @ B = x @ (A B) and
    Dense computes x @ W^T."""
    p = PROJ.index(proj)
    a = weights["A"][p, layer]          # (U, r)
    b = weights["B"][p, layer]          # (r, U)
    delta = (a @ b) * (weights["alpha"] / weights["rank"])
    return base_w + delta.T.astype(base_w.dtype)


class AdapterPool:
    """Device-resident LoRA slab + host-side ref-counted slot ledger.

    dtype: the slab's dtype, default the config's ("float32" or
    "bfloat16"); "int8" packs it quantized. device: where the slab lives
    (default the CUDA card; it must be the serving engine's)."""

    def __init__(self, config, slots=8, max_rank=8, dtype=None,
                 device=None):
        if slots < 2:
            raise MXNetError("AdapterPool needs at least 2 slots "
                             "(slot 0 is the reserved null adapter)")
        if max_rank < 1:
            raise MXNetError("AdapterPool needs max_rank >= 1")
        self.config = config
        self.slots = int(slots)
        self.max_rank = int(max_rank)
        self.device = resolve_device(device)
        L, U = config.num_layers, config.units
        name = str(dtype or getattr(config, "dtype", "float32"))
        name = name.replace("torch.", "")
        self.quantized = name == "int8"
        if not self.quantized and name not in _DTYPES:
            raise MXNetError(f"AdapterPool dtype {name!r} unsupported "
                             f"(int8, {', '.join(_DTYPES)})")
        self.dtype = torch.int8 if self.quantized else _DTYPES[name]
        kw = dict(device=self.device)
        self.A = torch.zeros((4, L, self.slots, U, self.max_rank),
                             dtype=self.dtype, **kw)
        self.B = torch.zeros((4, L, self.slots, self.max_rank, U),
                             dtype=self.dtype, **kw)
        self.scale = torch.zeros((self.slots,), dtype=torch.float32, **kw)
        if self.quantized:
            self.a_scale = torch.zeros((4, L, self.slots),
                                       dtype=torch.float32, **kw)
            self.b_scale = torch.zeros((4, L, self.slots),
                                       dtype=torch.float32, **kw)
        else:
            self.a_scale = self.b_scale = None
        self._registry = {}             # adapter_id -> host weights
        self._slot_of = {}              # adapter_id -> resident slot
        self._adapter_at = [None] * self.slots   # slot -> adapter_id
        self._pins = np.zeros(self.slots, np.int64)
        self._last_used = np.zeros(self.slots, np.int64)
        self._tick = 0
        self.page_ins = 0
        self.evictions = 0
        self._shard_cache = None

    def batch(self, slots):
        """The forward's adapter operand for per-row slab slots
        `slots` (Bsz,) int."""
        return AdapterBatch(self.A, self.B, self.scale, slots,
                            self.a_scale, self.b_scale)

    def shard_batches(self, slots, group):
        """One adapter operand per shard of a parallel.tp.TPGroup: shard
        r's U-slice of A, out-slice of B, the scales whole, and `slots`,
        each on the shard's device."""
        key = (id(self.A), id(self.B), self.page_ins,
               tuple(group.devices))
        if self._shard_cache is None or self._shard_cache[0] != key:
            u = self.config.units // group.size
            views = []
            for r, dev in enumerate(group.devices):
                leaves = [self.A[..., r * u:(r + 1) * u, :],
                          self.B[..., r * u:(r + 1) * u], self.scale,
                          self.a_scale, self.b_scale]
                views.append([None if x is None else place(x, dev)
                              for x in leaves])
            self._shard_cache = (key, views)
        return [AdapterBatch(a, b, sc, s, asc, bsc)
                for (a, b, sc, asc, bsc), s in
                zip(self._shard_cache[1], group.broadcast(slots))]

    # -- queries -----------------------------------------------------------
    @property
    def num_resident(self):
        return len(self._slot_of)

    @property
    def num_registered(self):
        return len(self._registry)

    @property
    def num_pinned(self):
        return int((self._pins[1:] > 0).sum())

    def has(self, adapter_id):
        """True when ``adapter_id`` can be served (registered, or the
        always-available null adapter None/0)."""
        return adapter_id in (None, 0) or adapter_id in self._registry

    def slot_of(self, adapter_id):
        """Resident slab slot of an adapter (None on a miss; 0 for the
        null adapter)."""
        if adapter_id in (None, 0):
            return 0
        return self._slot_of.get(adapter_id)

    def pins(self, adapter_id):
        slot = self._slot_of.get(adapter_id)
        return int(self._pins[slot]) if slot is not None else 0

    def slab_bytes(self):
        leaves = [self.A, self.B, self.scale]
        if self.quantized:
            leaves += [self.a_scale, self.b_scale]
        return int(sum(x.numel() * x.element_size() for x in leaves))

    # -- host-side registry ------------------------------------------------
    def register(self, adapter_id, weights):
        """Register host-side LoRA weights under ``adapter_id``.  No
        device work happens here — the slab is touched on first
        acquire().  Re-registering a resident adapter re-pages it on
        its next miss (the resident copy is invalidated)."""
        if adapter_id in (None, 0):
            raise MXNetError("adapter ids None and 0 are reserved for "
                             "the null adapter")
        L, U = self.config.num_layers, self.config.units
        a, b = np.asarray(weights["A"]), np.asarray(weights["B"])
        r = int(weights["rank"])
        if r > self.max_rank:
            raise MXNetError(f"adapter {adapter_id!r} rank {r} exceeds "
                             f"pool max_rank {self.max_rank}")
        if a.shape != (4, L, U, r) or b.shape != (4, L, r, U):
            raise MXNetError(
                f"adapter {adapter_id!r} shapes A{a.shape} B{b.shape} "
                f"do not match (4, {L}, {U}, {r}) / (4, {L}, {r}, {U})")
        slot = self._slot_of.get(adapter_id)
        if slot is not None and self._pins[slot]:
            raise MXNetError(f"re-registering adapter {adapter_id!r} "
                             "while pinned by active requests")
        self._registry[adapter_id] = {
            "A": a.astype(np.float32), "B": b.astype(np.float32),
            "alpha": float(weights["alpha"]), "rank": r,
        }
        if slot is not None:            # invalidate the stale resident
            self._slot_of.pop(adapter_id)
            self._adapter_at[slot] = None

    def weights(self, adapter_id):
        """The registered host weights (for the merged-weight oracle)."""
        return self._registry[adapter_id]

    # -- residency ---------------------------------------------------------
    @staticmethod
    def _quantize_proj(w):
        """Host-side symmetric int8 quantization of a padded (4, L, ...)
        delta slab slice: one absmax/127 scale per (proj, layer)."""
        sa = np.abs(w).max(axis=tuple(range(2, w.ndim))) / 127.0  # (4, L)
        s = sa[..., None, None]
        q = np.where(s > 0, np.round(w / np.maximum(s, 1e-30)), 0.0)
        return np.clip(q, -127, 127).astype(np.int8), \
            sa.astype(np.float32)

    def _page_in(self, slot, adapter_id):
        """Copy one adapter into slab slot `slot`, in place."""
        w = self._registry[adapter_id]
        L, U, R = self.config.num_layers, self.config.units, self.max_rank
        r = w["rank"]
        a_pad = np.zeros((4, L, U, R), np.float32)
        b_pad = np.zeros((4, L, R, U), np.float32)
        a_pad[..., :r] = w["A"]
        b_pad[:, :, :r, :] = w["B"]
        dev = self.device
        if self.quantized:
            qa, sa = self._quantize_proj(a_pad)
            qb, sb = self._quantize_proj(b_pad)
            self.a_scale[:, :, slot] = torch.from_numpy(sa).to(dev)
            self.b_scale[:, :, slot] = torch.from_numpy(sb).to(dev)
            a_pad, b_pad = qa, qb
        self.A[:, :, slot] = torch.from_numpy(a_pad).to(dev, self.dtype)
        self.B[:, :, slot] = torch.from_numpy(b_pad).to(dev, self.dtype)
        self.scale[slot] = float(np.float32(w["alpha"] / r))
        self._slot_of[adapter_id] = slot
        self._adapter_at[slot] = adapter_id
        self.page_ins += 1

    def effective_weights(self, adapter_id):
        """The weights a served request actually sees: the registered
        host weights, round-tripped through the slab's int8
        quantization when the pool is quantized — feed these to
        ``merged_weights`` to build the dense oracle for a quantized
        pool."""
        w = self._registry[adapter_id]
        if not self.quantized:
            return w
        qa, sa = self._quantize_proj(w["A"])
        qb, sb = self._quantize_proj(w["B"])
        return {
            "A": qa.astype(np.float32) * sa[..., None, None],
            "B": qb.astype(np.float32) * sb[..., None, None],
            "alpha": w["alpha"], "rank": w["rank"],
        }

    def _find_slot(self):
        """A slab slot for a page-in: a never-used slot, else LRU-evict
        an unpinned resident.  None when every slot is pinned."""
        victim, victim_tick = None, None
        for slot in range(1, self.slots):
            if self._adapter_at[slot] is None:
                return slot
            if self._pins[slot] == 0:
                t = self._last_used[slot]
                if victim is None or t < victim_tick:
                    victim, victim_tick = slot, t
        if victim is None:
            return None
        self._slot_of.pop(self._adapter_at[victim], None)
        self._adapter_at[victim] = None
        self.evictions += 1
        return victim

    @loop_only
    def acquire(self, adapter_id):
        """Pin ``adapter_id`` for the lifetime of one active request and
        return its slab slot (paging it in on a miss).  None/0 is the
        null adapter: slot 0, never pinned, never paged."""
        if adapter_id in (None, 0):
            return 0
        if adapter_id not in self._registry:
            raise MXNetError(f"adapter {adapter_id!r} is not registered")
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            slot = self._find_slot()
            if slot is None:
                raise AdapterPoolExhausted(
                    f"adapter slab exhausted: all {self.slots - 1} slots "
                    f"pinned by active requests (adapter {adapter_id!r} "
                    "must wait for a slot to drain)")
            self._page_in(slot, adapter_id)
        self._pins[slot] += 1
        self._tick += 1
        self._last_used[slot] = self._tick
        return slot

    @loop_only
    def release(self, adapter_id):
        """Drop one pin.  The adapter stays resident (warm) until LRU
        eviction needs its slot."""
        if adapter_id in (None, 0):
            return
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            raise MXNetError(f"release of non-resident adapter "
                             f"{adapter_id!r}")
        if self._pins[slot] < 1:
            raise MXNetError(f"pin underflow on adapter {adapter_id!r} "
                             f"(slot {slot})")
        self._pins[slot] -= 1

    @loop_only
    def evict(self, adapter_id):
        """Explicitly drop a resident adapter from the slab (refused
        while pinned).  The slab data is left in place — slot reuse
        overwrites it; correctness only reads slots named by the
        per-request slot ids."""
        slot = self._slot_of.get(adapter_id)
        if slot is None:
            return False
        if self._pins[slot]:
            raise MXNetError(f"evicting adapter {adapter_id!r} with "
                             f"{int(self._pins[slot])} live pin(s)")
        self._slot_of.pop(adapter_id)
        self._adapter_at[slot] = None
        self.evictions += 1
        return True

    @thread_safe
    def audit(self, assignments=None, raise_on_error=False):
        """O(slots) invariant check — the supervisor runs this after
        every caught dispatch fault (next to ``PagePool.audit``) and
        the chaos soak runs it at drain.

        assignments: optional iterable of the adapter_ids currently
        worn by active engine slots (None/0 entries ignored).  When
        given, every assigned adapter must be resident and its pin
        count must equal its assignment count exactly — anything else
        is a leaked or double-counted pin.

        Returns the list of violation strings ([] = clean); with
        raise_on_error=True a non-empty list raises MXNetError.
        """
        v = []
        if self._adapter_at[0] is not None or self._pins[0]:
            v.append("slot 0 (null adapter) is occupied or pinned")
        seen = {}
        for slot in range(1, self.slots):
            aid = self._adapter_at[slot]
            pins = int(self._pins[slot])
            if pins < 0:
                v.append(f"slot {slot}: negative pin count {pins}")
            if aid is None:
                if pins:
                    v.append(f"slot {slot}: {pins} pin(s) on an empty "
                             "slot")
                continue
            if aid in seen:
                v.append(f"adapter {aid!r} resident in slots "
                         f"{seen[aid]} and {slot}")
            seen[aid] = slot
            if self._slot_of.get(aid) != slot:
                v.append(f"slot {slot}: adapter {aid!r} not in the "
                         "resident map (or mapped elsewhere)")
            if aid not in self._registry:
                v.append(f"slot {slot}: resident adapter {aid!r} has no "
                         "host registration")
        for aid, slot in self._slot_of.items():
            if self._adapter_at[slot] != aid:
                v.append(f"resident map says adapter {aid!r} in slot "
                         f"{slot} but the slot holds "
                         f"{self._adapter_at[slot]!r}")
        if assignments is not None:
            want = {}
            for aid in assignments:
                if aid in (None, 0):
                    continue
                want[aid] = want.get(aid, 0) + 1
            for aid, n in want.items():
                slot = self._slot_of.get(aid)
                if slot is None:
                    v.append(f"adapter {aid!r}: {n} active slot(s) but "
                             "not resident")
                    continue
                pins = int(self._pins[slot])
                if pins != n:
                    v.append(f"adapter {aid!r}: pin count {pins} != {n} "
                             "active slot assignment(s)")
            for slot in range(1, self.slots):
                aid = self._adapter_at[slot]
                if aid is not None and aid not in want \
                        and self._pins[slot]:
                    v.append(f"adapter {aid!r}: {int(self._pins[slot])} "
                             "pin(s) with no active slot assignment "
                             "(leaked pin)")
        if v and raise_on_error:
            raise MXNetError("adapter pool audit failed: " + "; ".join(v))
        return v

    def snapshot(self):
        """Introspection block for /statusz."""
        return {
            "slots": self.slots, "max_rank": self.max_rank,
            "registered": self.num_registered,
            "resident": sorted(
                (str(a) for a in self._slot_of), key=str),
            "pinned": {str(a): int(self._pins[s])
                       for a, s in sorted(self._slot_of.items(),
                                          key=lambda kv: kv[1])
                       if self._pins[s]},
            "page_ins": self.page_ins, "evictions": self.evictions,
            "slab_bytes": self.slab_bytes(),
        }

    def __repr__(self):
        return (f"AdapterPool(slots={self.slots}, max_rank="
                f"{self.max_rank}, registered={self.num_registered}, "
                f"resident={self.num_resident}, "
                f"pinned={self.num_pinned})")
