"""Continuous-batching scheduler: FCFS admission, chunked prefill,
preempt-on-pool-exhaustion (port of ``repro/serve/scheduler.py``; host
Python whose decisions are identical to the reference's).

Pure policy/bookkeeping — no tensors in the hot path. The engine asks the
scheduler *what* to run each tick (admissions, the next prefill chunk,
block allocations, preemption victims) and executes the forwards itself.

Policies:
* **Admission** — FCFS. A request is placed when a slot is free AND its
  prompt pages allocate; otherwise it waits at the queue head (no
  head-of-line bypass). Requests that can never fit (prompt + generation
  budget over ``max_len`` or over the whole pool) raise ``CapacityError``
  at submit time instead of dying on an assert mid-flight.
* **Chunked prefill** — prompts enter the cache at most ``prefill_chunk``
  tokens per tick, so a long prompt never stalls concurrent decode ticks.
  Chunk widths are powers of two (the reference compiles one prefill
  variant per width; the port keeps the same plan so both make the same
  decisions). Attention-only
  families (``pad_prefill=True``) pad the final chunk up to a power-of-two
  bucket — padded positions are causally masked out and their cache writes
  land beyond the prompt's pages (scratch, or slots decode overwrites
  before reading), so one forward usually covers the whole prompt.
  Recurrent-state families (ssm/hybrid) integrate every token fed through
  them, so padding would corrupt their state; they instead feed the exact
  greedy power-of-two decomposition of the remainder (64, ..., 8, 2, 1).
* **Preemption** — when decode needs a fresh block and the pool is dry,
  the *youngest* running request is evicted back to the queue front (it
  is younger than anything still queued under FCFS, so the front keeps
  arrival order). Eviction is recompute-style: its blocks are released
  and its generated tokens discarded; greedy requests regenerate
  identically. A preempted sharer only ever *releases* its references —
  blocks still referenced by the prefix cache or co-sharers survive, and
  the replayed request re-finds them through a fresh lookup.
* **Prefix sharing** — with a ``prefix_cache`` attached, ``try_place``
  looks the prompt up first: matched full pages are shared (page table
  points at existing blocks, ``pos`` starts past them so their prefill
  chunks are skipped) and only the tail allocates fresh blocks. Under
  pool pressure the scheduler evicts cold cached prefixes before it
  resorts to preempting live sequences.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.serve.paged_cache import BlockAllocator


class CapacityError(ValueError):
    """Request can never be served by this engine configuration."""


def next_chunk_len(remaining: int, max_chunk: int) -> int:
    """Largest power of two <= min(remaining, max_chunk)."""
    if remaining <= 0:
        raise ValueError(f"no tokens left to chunk ({remaining})")
    return min(1 << (remaining.bit_length() - 1), max_chunk)


@dataclasses.dataclass
class Sequence:
    """Runtime state of one placed request."""
    req: object                 # serve.engine.Request
    slot: int
    pages: list                 # physical block ids, logical page order
    order: int                  # admission sequence number (preemption age)
    pos: int = 0                # tokens written to the cache so far
    phase: str = "prefill"      # "prefill" -> "decode"
    shared_tokens: int = 0      # prefix tokens served from shared blocks
                                # (prefill starts at pos == shared_tokens)

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)


class Scheduler:
    def __init__(self, *, max_batch: int, max_len: int, page_size: int,
                 allocator: BlockAllocator, prefill_chunk: int = 64,
                 pad_prefill: bool = False, on_submit=None,
                 prefix_cache=None):
        if prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1):
            raise ValueError(
                f"prefill_chunk must be a power of two, got {prefill_chunk}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.allocator = allocator
        self.prefill_chunk = prefill_chunk
        self.pad_prefill = pad_prefill
        self.prefix_cache = prefix_cache
        self.queue: deque = deque()
        self.running: list[Sequence | None] = [None] * max_batch
        self._order = 0
        # telemetry hook: fires once per accepted submit (after
        # validation), so enqueue records exist no matter whether a
        # request entered through Engine.submit/run or a direct
        # scheduler.submit (bench drivers, fuzz suites)
        self.on_submit = on_submit

    # -- admission ---------------------------------------------------------

    def validate(self, req):
        if len(req.prompt) == 0:
            raise CapacityError(f"request {req.rid}: empty prompt")
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise CapacityError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} exceeds max_len "
                f"{self.max_len}")
        pages = -(-need // self.page_size)
        if pages > self.allocator.capacity:
            raise CapacityError(
                f"request {req.rid}: needs {pages} blocks, pool has "
                f"{self.allocator.capacity}")

    def submit(self, req):
        self.validate(req)
        self.queue.append(req)
        if self.on_submit is not None:
            self.on_submit(req)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.running)

    def active(self) -> list[Sequence]:
        return [s for s in self.running if s is not None]

    def _alloc_with_evict(self, n: int) -> list | None:
        """``allocator.alloc`` that sheds cold cached prefixes first:
        each failed attempt evicts one refcount-1 cached leaf and
        retries, so the prefix cache yields to live demand before the
        scheduler resorts to preempting running sequences."""
        while True:
            got = self.allocator.alloc(n)
            if got is not None:
                return got
            if self.prefix_cache is None or not self.prefix_cache.evict_one():
                return None

    def try_place(self, req) -> Sequence | None:
        """Free slot + prompt pages, or None (request stays queued).

        With a prefix cache, matched full pages come shared (one extra
        reference each, already taken by ``lookup``) and only the tail
        allocates; ``pos`` starts at the shared boundary so the engine
        skips those prefill chunks entirely.
        """
        slot = next((i for i, s in enumerate(self.running) if s is None),
                    None)
        if slot is None:
            return None
        shared: list = []
        if self.prefix_cache is not None:
            shared = self.prefix_cache.lookup(req.prompt)
        need = -(-len(req.prompt) // self.page_size) - len(shared)
        pages = self._alloc_with_evict(need)
        if pages is None:
            if shared:
                self.allocator.release(shared)
            return None
        boundary = len(shared) * self.page_size
        seq = Sequence(req=req, slot=slot, pages=shared + pages,
                       order=self._order, pos=boundary,
                       shared_tokens=boundary)
        self._order += 1
        self.running[slot] = seq
        return seq

    def admit_from_queue(self) -> list[Sequence]:
        placed = []
        while self.queue:
            seq = self.try_place(self.queue[0])
            if seq is None:
                break
            self.queue.popleft()
            placed.append(seq)
        return placed

    # -- prefill -----------------------------------------------------------

    def prefill_chunk_len(self, seq: Sequence) -> tuple[int, int]:
        """(chunk_width, real_tokens) for the next prefill forward."""
        remaining = seq.prompt_len - seq.pos
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk, self.prefill_chunk
        if self.pad_prefill:
            return 1 << (remaining - 1).bit_length(), remaining
        size = next_chunk_len(remaining, self.prefill_chunk)
        return size, size

    # -- decode block supply / preemption ----------------------------------

    def ensure_block(self, seq: Sequence) -> list[Sequence]:
        """Make sure ``seq`` has a block mapped for its next write position.

        Returns the sequences preempted to make room (possibly ``seq``
        itself when it is the youngest). The caller must drop preempted
        sequences from its current tick.
        """
        preempted = []
        while seq.pos // self.page_size >= len(seq.pages):
            got = self._alloc_with_evict(1)
            if got is not None:
                seq.pages.extend(got)
                continue
            victim = max(self.active(), key=lambda s: s.order)
            self.preempt(victim)
            preempted.append(victim)
            if victim is seq:
                break
        return preempted

    def preempt(self, seq: Sequence):
        """Evict back to the queue front; recompute-style (state dropped).

        ``release`` — never a raw free — so blocks co-held by the prefix
        cache or other sharers survive the eviction; the replayed request
        re-finds them with a fresh lookup on re-admission.
        """
        self.allocator.release(seq.pages)
        self.running[seq.slot] = None
        seq.pages = []
        seq.pos = 0
        seq.shared_tokens = 0
        seq.phase = "prefill"
        self.queue.appendleft(seq.req)

    def finish(self, seq: Sequence):
        self.allocator.release(seq.pages)
        self.running[seq.slot] = None
