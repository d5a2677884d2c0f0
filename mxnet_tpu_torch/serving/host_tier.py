"""Host-RAM KV spill tier: a byte-budgeted pool of spilled page
payloads.

A copy of mxnet_tpu/serving/host_tier.py (pure Python and numpy; the
port keeps its own so that it never imports the JAX package). In the
port a payload's arrays come from a torch page gather copied through
pinned host memory (engine._tier_gather); bfloat16 pages, which numpy
has no dtype for, travel as their 2-byte bit patterns (int16), so a
payload's nbytes equal the reference's for the same page.

The serving stack was HBM-only for state: when the page budget ran
out, the radix prefix cache LRU-*discarded* pages and every eviction
became a future full re-prefill. `HostPagePool` is the second tier
under `PagePool`/`PrefixCache` (docs/SERVING.md "Tiered KV cache"):
spilled page payloads — k/v codes plus the int8 dequant scale leaves —
live here as host numpy arrays keyed by what owns them (a radix node's
chunk path, or a preempted request id for a whole-request swap), and a
later radix hit pages them back into freshly allocated device pages
instead of recomputing the prefix.

The pool stores BYTES, not pages: entries are admitted while the
budget holds, evicted LRU when it does not. An entry's lifecycle:

  * ``put(key, payload)``      — admit a payload (dict of numpy
                                 arrays), LRU-evicting unpinned entries
                                 to fit; returns False (payload
                                 dropped) when the budget cannot be
                                 met — spilling is best-effort, the
                                 caller falls back to plain discard.
  * ``checkout(key)``          — take a LEASE on an entry for an
                                 in-flight page-in: the payload is
                                 returned and the entry pinned
                                 (unevictable) until released. Same
                                 release-post-dominance discipline as
                                 device page leases.
  * ``release(key, drop=...)`` — drop the lease; ``drop=True`` removes
                                 the entry too (the payload now lives
                                 on device again).
  * ``discard(key)``           — remove an unpinned entry outright
                                 (its owner died: node discarded,
                                 request cancelled).

``evict_cb(key) -> bool`` is consulted before the pool LRU-drops an
entry to make room: the owner (the engine, which forwards radix-node
keys to the prefix cache) either detaches its reference and answers
True, or answers False and the entry is skipped — the two tiers can
never disagree about who holds a payload. ``audit()`` checks the
byte accounting and pin invariants the same way ``PagePool.audit()``
checks refcounts.

Payloads are plain host numpy arrays (see engine._tier_gather); the
pool itself never touches torch.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError
from ..analysis import loop_only, thread_safe

__all__ = ["HostPagePool"]


def _payload_bytes(payload):
    n = 0
    for v in payload.values():
        if isinstance(v, np.ndarray):
            n += int(v.nbytes)
    return n


class HostPagePool:
    """Byte-budgeted LRU store of spilled KV page payloads (host RAM).

    budget_bytes: total payload bytes the pool may hold. evict_cb:
    optional ``cb(key) -> bool`` asked before an LRU eviction — False
    vetoes (the entry is skipped this round). Counters: ``puts``,
    ``rejected`` (budget could not be met), ``evictions`` (LRU drops).
    """

    def __init__(self, budget_bytes, evict_cb=None):
        if int(budget_bytes) < 1:
            raise MXNetError("HostPagePool needs budget_bytes >= 1")
        self.budget_bytes = int(budget_bytes)
        self.evict_cb = evict_cb
        self._entries = OrderedDict()   # key -> payload dict
        self._bytes = {}                # key -> payload bytes
        self._pins = {}                 # key -> lease count
        self.bytes_used = 0
        self.puts = 0
        self.rejected = 0
        self.evictions = 0

    # -- queries -----------------------------------------------------------
    @property
    def num_entries(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def keys(self):
        """Snapshot of every key, LRU-oldest first."""
        return list(self._entries)

    def entry_bytes(self, key):
        return int(self._bytes.get(key, 0))

    # -- lifecycle ---------------------------------------------------------
    def _evict_for(self, need):
        """LRU-drop unpinned, owner-approved entries until `need` bytes
        fit. Returns True when the budget can take the new entry."""
        if need > self.budget_bytes:
            return False
        while self.bytes_used + need > self.budget_bytes:
            victim = None
            for key in self._entries:          # oldest first
                if self._pins.get(key, 0):
                    continue
                if self.evict_cb is not None and not self.evict_cb(key):
                    continue
                victim = key
                break
            if victim is None:
                return False
            self._drop(victim)
            self.evictions += 1
        return True

    def _drop(self, key):
        del self._entries[key]
        self.bytes_used -= self._bytes.pop(key)
        self._pins.pop(key, None)

    @loop_only
    def put(self, key, payload):
        """Admit `payload` (a dict of numpy arrays) under `key`,
        LRU-evicting to fit. Returns False — payload NOT stored — when
        the budget cannot be met by dropping unpinned entries; the
        caller falls back to plain discard. Replacing an existing key
        is an error: a spilled page's payload is immutable."""
        if key in self._entries:
            raise MXNetError(f"host tier already holds key {key!r}")
        self.puts += 1
        need = _payload_bytes(payload)
        if not self._evict_for(need):
            self.rejected += 1
            return False
        self._entries[key] = payload
        self._bytes[key] = need
        self.bytes_used += need
        self._entries.move_to_end(key)
        return True

    @loop_only
    def checkout(self, key):
        """Lease an entry for a page-in: returns the payload and pins
        the entry until release(). Raises when the key is absent — the
        caller must treat a missing payload as a plain cache miss
        BEFORE checking out."""
        payload = self._entries.get(key)
        if payload is None:
            raise MXNetError(f"host tier has no entry for key {key!r}")
        self._pins[key] = self._pins.get(key, 0) + 1
        self._entries.move_to_end(key)
        return payload

    @loop_only
    def release(self, key, drop=False):
        """Return a checkout() lease. drop=True removes the entry (the
        payload landed on device; the host copy is dead)."""
        pins = self._pins.get(key, 0)
        if pins < 1:
            raise MXNetError(f"host tier release of unpinned key {key!r}")
        if pins == 1:
            self._pins.pop(key)
        else:
            self._pins[key] = pins - 1
        if drop and not self._pins.get(key, 0):
            self._drop(key)

    @loop_only
    def discard(self, key):
        """Remove an unpinned entry (its owner died). Returns True when
        an entry was dropped, False for an unknown key."""
        if key not in self._entries:
            return False
        if self._pins.get(key, 0):
            raise MXNetError(f"host tier discard of pinned key {key!r}")
        self._drop(key)
        return True

    @thread_safe
    def audit(self, raise_on_error=False):
        """O(entries) invariant check, the host-tier counterpart of
        PagePool.audit(): byte accounting exact, budget respected,
        pins only on live entries. Returns violation strings ([] =
        clean); raise_on_error raises MXNetError instead."""
        v = []
        total = 0
        for key, payload in self._entries.items():
            b = self._bytes.get(key)
            if b is None:
                v.append(f"entry {key!r} has no byte record")
                continue
            real = _payload_bytes(payload)
            if real != b:
                v.append(f"entry {key!r}: recorded {b} bytes, "
                         f"payload holds {real}")
            total += b
        if total != self.bytes_used:
            v.append(f"bytes_used {self.bytes_used} != entry sum {total}")
        if self.bytes_used > self.budget_bytes:
            v.append(f"bytes_used {self.bytes_used} over budget "
                     f"{self.budget_bytes}")
        for key, pins in self._pins.items():
            if key not in self._entries:
                v.append(f"pin on missing entry {key!r}")
            if pins < 1:
                v.append(f"entry {key!r}: non-positive pin count {pins}")
        if v and raise_on_error:
            raise MXNetError("host tier audit failed: " + "; ".join(v))
        return v

    def __repr__(self):
        return (f"HostPagePool(entries={self.num_entries}, "
                f"bytes={self.bytes_used}/{self.budget_bytes}, "
                f"evictions={self.evictions})")
