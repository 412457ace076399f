"""Radix prefix cache over paged KV blocks (prefix sharing); port of
``repro/serve/prefix_cache.py``, host Python with identical decisions.

Real traffic overwhelmingly shares prompt *prefixes* — system prompts,
few-shot headers, per-tenant preambles. The paged engine's per-slot page
tables already make K/V location a pure indirection, so a warm prefix
does not need to be prefilled again: admission can point the new
sequence's page table at the physical blocks a previous request already
filled and start prefill past the shared boundary. This module owns the
host-side index that makes that lookup possible:

* **Radix tree over full pages.** Each node represents one *full* page
  (``page_size`` tokens) and is keyed by the tuple of token ids written
  into it; a node's path from the root spells a prompt prefix in
  page-size steps. Only full pages are cached — a partially-filled page
  is still written by its owner's decode ticks, so it can never be
  shared (this is the copy-on-write boundary: sharing stops strictly
  before the first page any writer can touch, so no fork ever needs a
  device-side block copy — the tail is simply prefilled privately).
* **Refcounts, not ownership.** The cache holds one reference
  (``BlockAllocator.share``) on every cached block; sequences that hit
  hold their own. A block is only reusable while its content is live,
  and the refcount is exactly that liveness: the pool reclaims it when
  the last sequence *and* the cache have released it.
* **LRU leaf eviction under pool pressure.** When an allocation fails,
  the scheduler asks the cache to give blocks back: evictable nodes are
  tree *leaves* whose block nobody but the cache references
  (``refcount == 1``), dropped oldest-touch first. Interior nodes become
  leaves as their children evict, so sustained pressure drains whole
  cold branches back to the free list while hot prefixes stay resident.

Correctness notes that the tests pin:

* Page content is a pure function of the token ids and absolute
  positions written (RoPE uses absolute positions; KV quantization is
  per-row deterministic), so a cached block is byte-identical to what
  the hitting request's own prefill would have produced — shared-prefix
  serving is token-identical to solo serving, not merely close.
* Lookup caps the shared extent at ``len(tokens) - 1`` so at least one
  real token always prefills (the engine needs last-token logits to
  sample the first output token), and so decode's first write lands
  strictly past every shared page.
* Recurrent-state families (ssm/hybrid/enc-dec) integrate every prompt
  token into slot-resident state that no page table can share; the
  engine keeps the cache inert for them (see Engine ctor) rather than
  serving a stale-state prefix.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.serve.paged_cache import BlockAllocator


@dataclasses.dataclass(eq=False)
class PrefixNode:
    """One cached full page: ``key`` is the page's token ids, ``block``
    the physical pool block holding its K/V."""
    key: tuple
    block: int
    parent: "PrefixNode | None"
    children: dict = dataclasses.field(default_factory=dict)
    last_used: int = 0

    @property
    def depth(self) -> int:
        d, n = 0, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d


class PrefixCache:
    """Radix tree mapping prompt prefixes (in full-page steps) to the
    physical blocks that already hold their K/V."""

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = PrefixNode(key=(), block=-1, parent=None)
        self._nodes: set[PrefixNode] = set()  # flat registry (membership)
        self._clock = 0                       # LRU touch counter
        # lazy-deletion min-heap of (last_used, tiebreak, node): every
        # touch pushes a fresh entry and leaves the old one stale in
        # place; evict_one pops in LRU order and discards entries whose
        # stamp no longer matches the node (superseded or evicted). This
        # keeps eviction O(log n) amortized — the old full-registry scan
        # plus list.remove made draining a cold cache under pool
        # pressure O(n^2).
        self._heap: list[tuple[int, int, PrefixNode]] = []
        self._heap_seq = 0
        # host-side stats (the engine mirrors these into obs/ metrics)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    # -- helpers -----------------------------------------------------------

    def _touch(self, node: PrefixNode):
        self._clock += 1
        node.last_used = self._clock
        self._heap_seq += 1
        heapq.heappush(self._heap, (node.last_used, self._heap_seq, node))

    def _page_key(self, tokens, page: int) -> tuple:
        lo = page * self.page_size
        return tuple(int(t) for t in tokens[lo: lo + self.page_size])

    @property
    def cached_blocks(self) -> int:
        return len(self._nodes)

    def blocks(self) -> set[int]:
        """Physical blocks currently referenced by the cache (fuzz/test
        ground truth for the refcount invariants)."""
        return {n.block for n in self._nodes}

    # -- lookup / insert ---------------------------------------------------

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Longest cached prefix of ``tokens`` in full pages; returns the
        physical blocks in logical page order, with one reference taken
        on each (the caller owns releasing them — normally by putting
        them at the front of a Sequence's page list, whose pages are
        released uniformly at finish/preempt).

        At most ``(len(tokens) - 1) // page_size`` pages match: the final
        token — and any partially-filled page — always prefills privately
        so the engine gets last-token logits and decode never writes a
        shared page.
        """
        max_pages = max(0, (len(tokens) - 1) // self.page_size)
        node, blocks = self.root, []
        for page in range(max_pages):
            child = node.children.get(self._page_key(tokens, page))
            if child is None:
                break
            blocks.append(child.block)
            node = child
        if blocks:
            self.allocator.share(blocks)
            # touch leaf-to-root so LRU order can never evict an ancestor
            # of a fresher descendant first
            n = node
            while n is not self.root:
                self._touch(n)
                n = n.parent
            self.hits += 1
            self.hit_tokens += len(blocks) * self.page_size
        else:
            self.misses += 1
        return blocks

    def insert(self, tokens: np.ndarray, pages: list[int]):
        """Register a fully-prefilled prompt's full pages. ``pages`` is
        the owning sequence's physical block list (logical page order).
        Existing nodes are only LRU-touched (their block stays — content
        is identical by determinism); new nodes take one cache-owned
        reference on the sequence's block, which is what keeps the page
        alive after the sequence itself finishes and releases."""
        full = min(len(tokens) // self.page_size, len(pages))
        node = self.root
        for page in range(full):
            key = self._page_key(tokens, page)
            child = node.children.get(key)
            if child is None:
                child = PrefixNode(key=key, block=pages[page], parent=node)
                self.allocator.share([child.block])
                node.children[key] = child
                self._nodes.add(child)
            self._touch(child)
            node = child

    # -- eviction ----------------------------------------------------------

    def _evictable(self, node: PrefixNode) -> bool:
        # leaves only (evicting an interior node would orphan live
        # descendants whose lookup path runs through it), and only blocks
        # nobody but the cache still references
        return (not node.children
                and self.allocator.refcount(node.block) == 1)

    def evict_one(self) -> bool:
        """Drop the least-recently-used evictable leaf, returning its
        block to the pool. False when nothing can be evicted (every
        cached block is still shared with a live sequence).

        O(log n) amortized: pop the heap in LRU order, skipping stale
        entries (node already evicted, or its stamp superseded by a
        later touch). Entries that are current but not evictable —
        interior nodes, blocks a live sequence still holds — are set
        aside and re-pushed with their unchanged stamp, so they keep
        their LRU position and become poppable once their children
        evict or the co-holder releases."""
        deferred = []
        victim = None
        while self._heap:
            stamp, seq, node = heapq.heappop(self._heap)
            if node not in self._nodes or stamp != node.last_used:
                continue
            if not self._evictable(node):
                deferred.append((stamp, seq, node))
                continue
            victim = node
            break
        for entry in deferred:
            heapq.heappush(self._heap, entry)
        if victim is None:
            return False
        self.allocator.release([victim.block])
        del victim.parent.children[victim.key]
        self._nodes.remove(victim)
        self.evictions += 1
        return True

    def clear(self):
        """Release every cached block and reset the LRU clock and the
        hit/miss/eviction counters (engine teardown — a restarted engine
        must not report stale prefix stats)."""
        for n in self._nodes:
            self.allocator.release([n.block])
        self._nodes.clear()
        self.root.children.clear()
        self._heap.clear()
        self._heap_seq = 0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
