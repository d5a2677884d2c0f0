"""Radix-tree prompt prefix cache over ref-counted KV pages.

A copy of mxnet_tpu/serving/prefix_cache.py (pure Python and numpy; the
port keeps its own so that it never imports the JAX package). The
serving engine installs the host-tier seams `evict_hook` and
`pagein_hook` when it is built with `host_kv_bytes` (engine._spill_node,
engine._pagein_nodes).

Production traffic is dominated by shared prompt prefixes — system
prompts, few-shot templates, multi-turn history (the Gemma-on-TPU
serving study calls the workload prefill-bound, PAPERS.md). Because
every attention read in the serving path already goes through a
per-slot page table (PagedKVCache + the ragged paged-attention kernel),
a cached prefix can be attached to a new request by *page-table
surgery* alone: map the shared physical pages into the slot's table,
set the cache length past them, and prefill only the uncached suffix.
Zero recompute, zero copy — repeated-prefix prefill cost drops from
O(prompt) to O(suffix).

Structure: a radix tree at PAGE granularity. Each edge is one full
page's worth of token ids (``page_size`` tokens, as a tuple key); each
node owns exactly one physical page in the PagePool holding that
chunk's K/V for every layer. Partial trailing pages are never cached —
a node's page is always complete and therefore read-only forever,
which is what makes sharing safe (see the CoW rule in engine._admit
for the one exception: a fully-cached prompt whose last token must be
re-run for logits).

Ownership protocol (see page_pool.py):
  * ``match(tokens)`` walks the tree and takes one lease per matched
    page for the caller; the engine maps those pages into the slot.
  * ``insert(tokens, pages)`` adopts the slot's freshly prefilled full
    prompt pages as tree nodes — membership, not a lease: when the
    slot later releases, the page's refcount drops to zero but the
    page stays materialized in the tree, instantly re-attachable.
  * ``release(pages)`` drops the slot's leases; zero-ref pages NOT in
    the tree are freed, zero-ref tree pages become EVICTABLE.
  * Eviction is LRU-by-leaf: only leaves (no children — an interior
    node's chunk is a prefix of live entries) with zero leases are
    candidates, oldest touch first. ``budget_pages`` bounds the
    tree's page footprint so churn can never OOM the pool.

Tiered mode (docs/SERVING.md "Tiered KV cache"): with ``evict_hook``
installed, ``_evict_one`` offers the victim's payload to the host
tier before freeing the device page. A hook that answers True took
the payload — the node survives as a SPILLED node (``page=None``,
out of ``_by_page``), and a later ``match`` that walks onto it
allocates a fresh device page and asks ``pagein_hook`` to restore
the payload, so a radix hit on spilled state costs one copy instead
of a full suffix re-prefill. Two invariants keep the tiers honest:

  * the RESIDENT node set is prefix-closed along every root path
    (spill only strips from the bottom up; insert never grows a
    resident node under a spilled ancestor), so a match walk is
    always "resident prefix, then spilled run";
  * a spilled node in the tree always has a live host payload — the
    host pool's LRU may only drop one through ``drop_spilled``,
    which detaches the node (marking it ``dead`` for anyone holding
    a reference, e.g. a preempted request's swap record).
"""
from __future__ import annotations

import itertools

from ..base import MXNetError
from .page_pool import PagePool, PagePoolExhausted

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("parent", "key", "page", "children", "stamp",
                 "spilled", "dead")

    def __init__(self, parent=None, key=None, page=None):
        self.parent = parent
        self.key = key          # tuple of page_size token ids (edge label)
        self.page = page        # physical page id, None while spilled
        self.children = {}      # chunk tuple -> _Node
        self.stamp = 0          # LRU touch stamp (monotonic)
        self.spilled = False    # payload lives in the host tier
        self.dead = False       # detached from the tree (evicted/dropped)


class PrefixCache:
    """Radix tree over token-id prefixes; nodes own full KV pages."""

    def __init__(self, pool, page_size, budget_pages=None):
        if not isinstance(pool, PagePool):
            raise MXNetError("PrefixCache needs a PagePool")
        if page_size < 1:
            raise MXNetError("page_size must be >= 1")
        self.pool = pool
        self.page_size = int(page_size)
        self.budget_pages = None if budget_pages is None \
            else int(budget_pages)
        self._root = _Node()
        self._by_page = {}               # page id -> RESIDENT node
        self._clock = itertools.count(1)
        # tier seams (engine-installed; None = single-tier behaviour)
        self.evict_hook = None           # (keypath, page) -> bool (spilled?)
        self.pagein_hook = None          # [(keypath, page)] -> None
        # counters (the engine mirrors these into mx.telemetry)
        self.hits = 0                    # match() calls returning >= 1 page
        self.misses = 0
        self.tokens_matched = 0
        self.evicted_pages = 0           # discarded outright (both modes)
        self.spilled_pages = 0           # cumulative spills to host
        self.paged_in_pages = 0          # cumulative host -> device restores
        self.num_spilled = 0             # spilled nodes currently in-tree

    # -- introspection -----------------------------------------------------
    @property
    def num_pages(self):
        """Device pages currently owned by tree nodes (leased or idle).
        Spilled nodes hold no device page and are not counted — this is
        what ``budget_pages`` bounds."""
        return len(self._by_page)

    @property
    def num_resident(self):
        """Alias of num_pages, paired with num_spilled for the
        prefix_resident_pages / prefix_spilled_pages gauges."""
        return len(self._by_page)

    def _keypath(self, node):
        """Root-to-node tuple of chunk keys — the host-tier key."""
        path = []
        while node.parent is not None:
            path.append(node.key)
            node = node.parent
        return tuple(reversed(path))

    def spilled_keypaths(self):
        """Keypaths of every spilled node in the tree — the audit's
        ground truth for the cross-tier check (PagePool.audit
        host_keys/spilled_keys): these must match the host tier's
        node keys exactly."""
        out = []
        stack = [(self._root, ())]
        while stack:
            node, path = stack.pop()
            for key, child in node.children.items():
                cp = path + (key,)
                if child.spilled:
                    out.append(cp)
                stack.append((child, cp))
        return out

    def member_mask(self):
        """(num_pages,) bool over the pool: True for tree-owned pages.
        The engine ORs this into the decode program's page_lock so a
        cached page can never be clobbered by a stray write."""
        import numpy as np
        mask = np.zeros(self.pool.num_pages, bool)
        if self._by_page:
            mask[list(self._by_page)] = True
        return mask

    def contains(self, tokens):
        """True when every full page of `tokens` is cached."""
        node = self._root
        for chunk in self._chunks(tokens):
            node = node.children.get(chunk)
            if node is None:
                return False
        return True

    def _chunks(self, tokens):
        S = self.page_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + S])
                for i in range(0, len(toks) - len(toks) % S, S)]

    # -- the hot path ------------------------------------------------------
    def match(self, tokens):
        """Longest-prefix match at page granularity. Returns the matched
        physical pages in prefix order, each carrying ONE new lease for
        the caller (release() them when the slot frees). Spilled nodes
        on the matched path are paged back in from the host tier (a
        fresh page per node; its birth refcount IS the caller's lease) —
        on pool exhaustion the walk stops there and the match is the
        restorable prefix. Touches the matched path's LRU stamps."""
        stamp = next(self._clock)
        node, pages, path = self._root, [], []
        pending = []                 # spilled (keypath, node) tail run
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            path.append(chunk)
            if child.spilled:
                pending.append((tuple(path), child))
            elif pending:
                break                # resident under spilled ancestor:
                                     # cannot happen (prefix-closure),
                                     # stop rather than corrupt order
            else:
                child.stamp = stamp
                pages.append(child.page)
            node = child
        if pages:
            self.pool.adopt(pages)       # lease, even if the page was idle
        pages += self._pagein(pending, stamp)
        if pages:
            self.hits += 1
            self.tokens_matched += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages

    def _pagein(self, pending, stamp):
        """Restore a run of spilled nodes: allocate a device page per
        node (evicting idle residents if needed), hand the batch to
        pagein_hook, and re-register the nodes as resident. Returns the
        restored pages in prefix order; stops early (prefix kept) on
        pool exhaustion or when reclaim's own spill traffic drops a
        pending node's payload from the host LRU."""
        if not pending or self.pagein_hook is None:
            return []
        staged = []                  # (keypath, node, page)
        for keypath, child in pending:
            if child.dead:
                break
            try:
                page = self.pool.alloc(1)[0]
            except PagePoolExhausted:
                if not self.reclaim(1):
                    break
                page = self.pool.alloc(1)[0]
            if child.dead:           # dropped while we reclaimed
                self.pool.free([page])
                break
            staged.append((keypath, child, page))
        if not staged:
            return []
        try:
            self.pagein_hook([(kp, pg) for kp, _, pg in staged])
        except BaseException:
            self.pool.free([pg for _, _, pg in staged])
            raise
        pages = []
        for keypath, child, page in staged:
            child.page = int(page)
            child.spilled = False
            child.stamp = stamp
            self._by_page[child.page] = child
            self.num_spilled -= 1
            self.paged_in_pages += 1
            pages.append(child.page)
        return pages

    def insert(self, tokens, pages):
        """Adopt the slot's prompt pages into the tree. ``pages`` maps
        1:1 onto the full-page chunks of ``tokens`` (the slot's table
        prefix after prefill). Chunks already cached keep their existing
        node/page — the supplied duplicate page stays slot-owned and is
        freed at release. Returns the number of pages adopted."""
        chunks = self._chunks(tokens)
        if len(pages) < len(chunks):
            raise MXNetError(f"insert: {len(chunks)} full pages of tokens "
                             f"but only {len(pages)} pages supplied")
        stamp = next(self._clock)
        node, adopted = self._root, 0
        for chunk, page in zip(chunks, pages):
            child = node.children.get(chunk)
            if child is None:
                if node.spilled:
                    # never grow a resident node under a spilled
                    # ancestor — the resident set must stay
                    # prefix-closed for match()'s walk order
                    break
                if page in self._by_page:
                    raise MXNetError(f"page {page} already owned by "
                                     "another tree node")
                child = _Node(parent=node, key=chunk, page=int(page))
                node.children[chunk] = child
                self._by_page[child.page] = child
                adopted += 1
            child.stamp = stamp
            node = child
        self.enforce_budget()
        return adopted

    def release(self, pages):
        """Drop one lease per page (a slot freeing its table). Zero-ref
        pages outside the tree go back to the free list; zero-ref tree
        pages stay cached (evictable)."""
        zeroed = self.pool.decref(pages)
        stray = [p for p in zeroed if p not in self._by_page]
        if stray:
            self.pool.free(stray)
        self.enforce_budget()

    # -- eviction ----------------------------------------------------------
    def _discard(self, node):
        """Detach a childless resident node and free its page."""
        del node.parent.children[node.key]
        del self._by_page[node.page]
        node.dead = True
        self.pool.free([node.page])
        self.evicted_pages += 1

    def _evict_one(self):
        """Reclaim the least-recently-touched idle page. With an
        evict_hook installed the victim's payload is offered to the
        host tier first: True from the hook spills (the node survives,
        pageless), False falls back to plain discard for childless
        nodes — an interior node the hook declines is skipped, because
        discarding it would orphan its spilled subtree. Without a
        hook: original LRU-by-leaf discard. Returns True when a device
        page was reclaimed."""
        if self.evict_hook is None:
            best = None
            for page, node in self._by_page.items():
                if node.children or self.pool.refcount(page) != 0:
                    continue
                if best is None or node.stamp < best.stamp:
                    best = node
            if best is None:
                return False
            self._discard(best)
            return True
        # tiered: any idle node with no RESIDENT children is a victim
        # (spilled descendants are fine — stripping bottom-up keeps the
        # resident set prefix-closed), oldest touch first
        cands = [node for page, node in self._by_page.items()
                 if self.pool.refcount(page) == 0
                 and not any(not c.spilled
                             for c in node.children.values())]
        cands.sort(key=lambda n: n.stamp)
        for node in cands:
            # the hook gathers the device payload BEFORE we free it
            if self.evict_hook(self._keypath(node), node.page):
                page = node.page
                del self._by_page[page]
                node.page = None
                node.spilled = True
                self.pool.free([page])
                self.num_spilled += 1
                self.spilled_pages += 1
                return True
            if not node.children:
                self._discard(node)
                return True
        return False

    def drop_spilled(self, keypath):
        """Host-LRU callback: detach the childless spilled node at
        `keypath` so its host payload may be dropped. Returns False —
        vetoing the host eviction — when the node is absent, resident,
        or still has children (its subtree's keys embed this path);
        the dropped node is marked ``dead`` for any swap record still
        holding it."""
        node = self._root
        for chunk in keypath:
            node = node.children.get(chunk)
            if node is None:
                return False
        if not node.spilled or node.children:
            return False
        del node.parent.children[node.key]
        node.dead = True
        self.num_spilled -= 1
        return True

    def enforce_budget(self):
        """Evict idle leaves until the tree fits its page budget (leased
        pages can push past it transiently — they are pinned)."""
        if self.budget_pages is None:
            return
        while len(self._by_page) > self.budget_pages:
            if not self._evict_one():
                break

    def reclaim(self, n_free):
        """Evict idle leaves until the POOL has `n_free` free pages (an
        admission that needs pages the free list cannot cover). Returns
        True when the target was reached."""
        while self.pool.num_free < n_free:
            if not self._evict_one():
                return False
        return True

    def clear(self):
        """Drop every idle page (leased pages survive — they belong to
        live slots)."""
        while self._evict_one():
            pass

    def __repr__(self):
        return (f"PrefixCache(pages={self.num_pages}, "
                f"spilled={self.num_spilled}, "
                f"budget={self.budget_pages}, hits={self.hits}, "
                f"misses={self.misses}, evicted={self.evicted_pages})")
