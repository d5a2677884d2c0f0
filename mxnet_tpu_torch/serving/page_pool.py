"""Ref-counted KV page allocator — explicit ownership for the page pool.

A copy of mxnet_tpu/serving/page_pool.py (pure Python and numpy; the
port keeps its own so that it never imports the JAX package).

The first serving engine gave every decode slot a fixed, implicit set
of physical pages (slot ``b`` owned pages ``[b*P, (b+1)*P)`` forever).
Prefix reuse
(serving/prefix_cache.py) breaks that model: a physical page holding a
cached prompt prefix may be mapped into several slots' page tables at
once and must outlive all of them, so ownership has to be counted, not
assumed. ``PagePool`` is that ledger — a host-side allocator over the
``num_pages`` axis of the device pools in ``PagedKVCache``:

  * ``alloc(n)``      — take n free pages, each born with refcount 1
                        (the caller's lease).
  * ``incref(pages)`` — add a lease (a second slot mapping a shared
                        prefix page, serving/prefix_cache.py match()).
  * ``decref(pages)`` — drop a lease; returns the pages that hit zero.
                        Zero-ref pages are NOT auto-freed: the prefix
                        cache keeps them materialized (and evictable)
                        until its LRU policy says otherwise.
  * ``free(pages)``   — return zero-ref pages to the free list.
  * ``cow(page)``     — copy-on-write split decision: a shared page
                        about to be written must first be re-homed to a
                        fresh exclusive page (the engine performs the
                        device-side copy; the pool only does the
                        accounting).

The pool never touches device memory — it indexes it. All methods are
O(pages) numpy/list work on the host, called between compiled
dispatches. Invariants are enforced loudly (double free, refcount
underflow, incref of a free page all raise MXNetError): a silent
accounting bug here becomes silent KV corruption on device.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..base import MXNetError
from ..analysis import loop_only, thread_safe

__all__ = ["PagePool", "PagePoolExhausted"]


class PagePoolExhausted(MXNetError):
    """alloc() could not satisfy the request. A distinct type because
    the engine supervisor treats exhaustion as BACKPRESSURE (requeue
    the admission and retry once pages drain — nobody's fault), not as
    a dispatch fault that blames the request."""


class PagePool:
    """Host-side ref-counted allocator over a pool of physical KV pages."""

    def __init__(self, num_pages, page_bytes=None):
        if num_pages < 1:
            raise MXNetError("PagePool needs at least one page")
        self.num_pages = int(num_pages)
        # optional bytes per page (KV slabs + dequant scales) — set by
        # from_bytes / the engine so capacity introspection can report
        # the pool in HBM terms
        self.page_bytes = int(page_bytes) if page_bytes else None
        self._refcount = np.zeros(self.num_pages, np.int32)
        self._allocated = np.zeros(self.num_pages, bool)
        self._free = deque(range(self.num_pages))

    @classmethod
    def from_bytes(cls, hbm_budget_bytes, page_bytes):
        """Byte-denominated sizing: as many whole pages as the HBM
        budget affords at ``page_bytes`` per page (one page's k+v slabs
        across all layers, plus the per-page dequant scales when the
        pools are quantized). Storing pages at int8 instead of fp32
        shrinks ``page_bytes`` ~4× — the freed budget comes back as
        MORE PAGES, i.e. real admitted-slot capacity, with no caller
        arithmetic."""
        if page_bytes < 1:
            raise MXNetError("from_bytes needs page_bytes >= 1")
        n = int(hbm_budget_bytes) // int(page_bytes)
        if n < 1:
            raise MXNetError(
                f"hbm_budget_bytes {int(hbm_budget_bytes)} below one "
                f"page ({int(page_bytes)} bytes)")
        return cls(n, page_bytes=page_bytes)

    # -- queries -----------------------------------------------------------
    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_allocated(self):
        return self.num_pages - len(self._free)

    def refcount(self, page):
        return int(self._refcount[page])

    def refcounts(self):
        """Copy of the (num_pages,) int32 refcount vector."""
        return self._refcount.copy()

    def shared_mask(self):
        """(num_pages,) bool: pages with more than one lease."""
        return self._refcount > 1

    def exclusive_mask(self):
        """(num_pages,) bool: pages with exactly one lease — the only
        pages a decode write may legally land in."""
        return self._refcount == 1

    # -- lifecycle ---------------------------------------------------------
    def _check(self, pages, allocated):
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise MXNetError(f"page {p} outside pool "
                                 f"[0, {self.num_pages})")
            if bool(self._allocated[p]) != allocated:
                state = "allocated" if allocated else "free"
                raise MXNetError(f"page {p} is not {state}")

    @loop_only
    def alloc(self, n):
        """Take `n` free pages (refcount 1 each). Raises when the pool
        cannot satisfy the request — the caller (prefix cache) evicts
        and retries; the pool itself never reclaims."""
        if n < 0:
            raise MXNetError("alloc(n) needs n >= 0")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: want {n} pages, {len(self._free)} "
                f"free of {self.num_pages} (evict cached prefixes or "
                "grow prefix_cache_pages)")
        pages = [self._free.popleft() for _ in range(n)]
        self._refcount[pages] = 1
        self._allocated[pages] = True
        return pages

    @loop_only
    def incref(self, pages):
        """Add one lease per page (pages must be live)."""
        pages = list(pages)
        self._check(pages, allocated=True)
        for p in pages:
            if self._refcount[p] < 1:
                raise MXNetError(f"incref of zero-ref page {p} (only the "
                                 "prefix cache may resurrect idle pages)")
        np.add.at(self._refcount, pages, 1)
        return pages

    @loop_only
    def adopt(self, pages):
        """Add one lease per page where refcount may be 0 (the prefix
        cache re-leasing an idle cached page on a match)."""
        pages = list(pages)
        self._check(pages, allocated=True)
        np.add.at(self._refcount, pages, 1)
        return pages

    @loop_only
    def decref(self, pages):
        """Drop one lease per page; returns the pages that reached zero
        (still allocated — pass them to free() to recycle)."""
        pages = list(pages)
        self._check(pages, allocated=True)
        for p in pages:
            if self._refcount[p] < 1:
                raise MXNetError(f"refcount underflow on page {p}")
        np.subtract.at(self._refcount, pages, 1)
        return [p for p in pages if self._refcount[p] == 0]

    @loop_only
    def free(self, pages):
        """Return zero-ref pages to the free list."""
        pages = list(pages)
        self._check(pages, allocated=True)
        for p in pages:
            if self._refcount[p] != 0:
                raise MXNetError(f"freeing page {p} with live refcount "
                                 f"{int(self._refcount[p])}")
        for p in pages:
            self._allocated[p] = False
            self._free.append(p)
        return pages

    @loop_only
    def cow(self, page):
        """Copy-on-write split: given a page the caller wants to WRITE,
        return (dst_page, needs_copy). Exclusive pages come straight
        back (write in place). Shared pages cost one fresh page — the
        caller must copy the slab on device, then holds dst exclusively;
        the caller's lease on `page` is dropped here."""
        self._check([page], allocated=True)
        if self._refcount[page] == 1:
            return page, False
        (dst,) = self.alloc(1)
        self.decref([page])
        return dst, True

    @thread_safe
    def audit(self, leases=None, members=(), raise_on_error=False,
              scales=None, host_keys=None, spilled_keys=None):
        """O(pages) invariant check — the supervisor runs this after
        every caught dispatch fault, and tests run it at drain.

        leases: optional iterable of page-id rows (one per mapped slot
        table). Tree membership adds no refcount (the prefix cache
        parks idle pages at refcount 0), so when leases are given,
        refcount == slot-lease count must hold exactly for every
        allocated page, and an allocated page with refcount 0 must be
        a tree member — anything else is a leaked page.
        members: page ids the prefix-cache radix tree owns.
        scales: optional (num_pages,) per-page quantization-scale
        summary (max |scale| over layers/heads, host-side) for int8
        pools. Scale leaves must stay lease-consistent: one entry per
        pool page, finite and non-negative everywhere — a NaN/inf or
        negative scale is corrupted quantization state that would
        silently poison every future read of that page.
        host_keys / spilled_keys: the cross-TIER check (give both or
        neither). host_keys = radix-node keys currently held by the
        host spill tier; spilled_keys = keypaths of the radix tree's
        spilled nodes. The sets must match exactly: a host payload
        with no spilled node is a leaked host page (unreachable, yet
        burning budget), a spilled node with no payload is lost state
        a match() would page garbage in for.

        Returns the list of violation strings ([] = clean); with
        raise_on_error=True a non-empty list raises MXNetError instead.
        """
        v = []
        if host_keys is not None or spilled_keys is not None:
            host_keys = set(host_keys or ())
            spilled_keys = set(spilled_keys or ())
            for k in sorted(host_keys - spilled_keys, key=repr):
                v.append(f"host tier holds payload for {k!r} but no "
                         "spilled tree node references it (leaked "
                         "across tiers)")
            for k in sorted(spilled_keys - host_keys, key=repr):
                v.append(f"spilled tree node {k!r} has no host-tier "
                         "payload (lost state)")
        if scales is not None:
            scales = np.asarray(scales)
            if scales.shape != (self.num_pages,):
                v.append(f"scale leaf covers {scales.shape} pages, pool "
                         f"has {self.num_pages}")
            else:
                bad = ~np.isfinite(scales) | (scales < 0)
                for p in np.nonzero(bad)[0]:
                    v.append(f"page {int(p)}: corrupt quant scale "
                             f"{float(scales[p])!r}")
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            v.append(f"free list holds duplicates "
                     f"({len(free) - len(free_set)})")
        members = set(int(p) for p in members)
        for p in free_set:
            if not 0 <= p < self.num_pages:
                v.append(f"free list holds out-of-range page {p}")
        for p in range(self.num_pages):
            alloc = bool(self._allocated[p])
            ref = int(self._refcount[p])
            if alloc == (p in free_set):
                v.append(f"page {p}: allocated={alloc} but "
                         f"{'in' if p in free_set else 'not in'} "
                         "free list")
            if ref < 0:
                v.append(f"page {p}: negative refcount {ref}")
            if ref > 0 and not alloc:
                v.append(f"page {p}: refcount {ref} on free page")
            if p in members and not alloc:
                v.append(f"page {p}: tree member but not allocated")
        if leases is not None:
            lease_count = np.zeros(self.num_pages, np.int64)
            for row in leases:
                for p in row:
                    p = int(p)
                    if not 0 <= p < self.num_pages:
                        v.append(f"slot table references out-of-range "
                                 f"page {p}")
                        continue
                    lease_count[p] += 1
            for p in range(self.num_pages):
                ref = int(self._refcount[p])
                n = int(lease_count[p])
                if n and p in free_set:
                    v.append(f"page {p}: {n} slot lease(s) on a free "
                             "page")
                    continue
                if not self._allocated[p]:
                    continue
                if ref != n:
                    v.append(f"page {p}: refcount {ref} != {n} slot "
                             "lease(s)")
                if ref == 0 and n == 0 and p not in members:
                    v.append(f"page {p}: allocated with no lease and "
                             "no tree membership (leaked)")
        if v and raise_on_error:
            raise MXNetError("page pool audit failed: " + "; ".join(v))
        return v

    def __repr__(self):
        return (f"PagePool(pages={self.num_pages}, free={self.num_free}, "
                f"shared={int((self._refcount > 1).sum())})")
