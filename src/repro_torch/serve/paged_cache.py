"""Paged KV-cache pool management for the serving engine (port of
``repro/serve/paged_cache.py``).

The device-side layout lives in the model layer (``models/attention``:
one ``PagedKVCache`` per layer — block pools + page table). This module
owns the host side:

* ``BlockAllocator`` — refcounted free list over block ids; block 0 is the
  scratch block that idle slots' page-table entries point at.
* slot views/merges — the engine prefills one request at a time through a
  B=1 view of the cache: the slot's page-table row, with the block pools
  shared (the same tensors, never copies). Which axis of each cache leaf
  is the batch axis is derived: ``batch_axes`` diffs the shapes of
  ``init_cache`` at two batch sizes on the ``meta`` device.
* ``push_page_table`` — puts the host page table into every layer's cache.

Cache trees are lists, dicts and NamedTuples (``PagedKVCache``,
``hybrid.HybridCache``, ``encdec.EncDecCache``, recurrent states) of
tensors or None; ``tree_map`` walks them to the tensors, ``map_paged`` to
the ``PagedKVCache`` nodes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import kv_quant
from repro_torch.models.attention import PagedKVCache, PagedLayout


class BlockAllocator:
    """Refcounted free-list allocator over block ids 1..num_blocks-1
    (0 is scratch).

    ``alloc`` hands out fresh blocks at refcount 1, ``share`` takes an extra
    reference (prefix sharing), ``release`` drops one; a block returns to
    the free list when its count reaches zero. ``free`` is an alias of
    ``release``. Releasing an unallocated or already-free id raises
    ``ValueError`` instead of corrupting the free list.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least scratch + one usable block")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}   # block id -> refcount (>= 1)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Distinct blocks handed out, shared or not."""
        return self.capacity - len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def shared_blocks(self) -> int:
        """Blocks with more than one live reference."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, block: int) -> int:
        """Live reference count of ``block`` (0 if free)."""
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        """n fresh blocks at refcount 1, or None (all-or-nothing)."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._ref[b] = 1
        return got

    def share(self, ids: list[int]):
        """Take one extra reference on each (already-allocated) block."""
        for b in ids:
            if b not in self._ref:
                raise ValueError(f"share of unallocated block {b}")
        for b in ids:
            self._ref[b] += 1

    def release(self, ids: list[int]):
        """Drop one reference per block; a block whose count hits zero
        returns to the free list. Raises ValueError on ids that are out of
        range, free, or never allocated."""
        for b in ids:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"release of invalid block id {b}")
            if b not in self._ref:
                raise ValueError(
                    f"release of block {b} that is not allocated "
                    f"(double-release or foreign id)")
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def free(self, ids: list[int]):
        """Alias of ``release``."""
        self.release(ids)


# ---------------------------------------------------------------------------
# cache trees
# ---------------------------------------------------------------------------

def tree_map(f, tree, *rest):
    """Map ``f`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); lists, dicts and NamedTuples are walked, None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(f, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)


def batch_axes(model, max_batch: int, max_len: int, dtype,
               paged: PagedLayout):
    """Tree (matching the cache tree) of per-leaf batch-axis indices; -1
    marks leaves without a batch axis (the shared block pools)."""
    a = model.init_cache(max_batch, max_len, dtype=dtype, paged=paged,
                         device="meta")
    b = model.init_cache(max_batch + 1, max_len, dtype=dtype, paged=paged,
                         device="meta")

    def ax(sa, sb):
        diff = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape))
                if x != y]
        if len(diff) > 1:
            raise ValueError(f"leaf {tuple(sa.shape)} has no single batch "
                             "axis")
        return diff[0] if diff else -1

    return tree_map(ax, a, b)


def _slot_idx(ndim: int, axis: int, slot: int):
    idx = [slice(None)] * ndim
    idx[axis] = slice(slot, slot + 1)
    return tuple(idx)


def slot_merge(cache, new, axes, slot: int, *, shared: bool = True):
    """Write a B=1 view back into the full cache at ``slot``.
    ``shared=True`` takes the view's pools (they are the cache's own tensors
    after a prefill through the view); ``shared=False`` keeps the cache's
    pools, for resetting a slot's state from a template. Batch-axis leaves
    (small: page tables, per-slot state) are copied before the write, so a
    table tensor that other holders share is never changed under them.
    """
    def put(o, n, a):
        if a < 0:
            return n if shared else o
        o = o.clone()
        o[_slot_idx(o.dim(), a, slot)] = n.to(o.dtype)
        return o

    return tree_map(put, cache, new, axes)


def slot_view_dyn(cache, axes, slot: int):
    """B=1 view of ``slot``: batch-axis leaves sliced (views), pools shared.
    (The reference's traced-slot form; here the slot is a plain int.)"""
    return tree_map(
        lambda x, a: x if a < 0 else x.narrow(a, slot, 1), cache, axes)


def slot_merge_dyn(cache, new, axes, slot: int):
    """slot_merge with the view's pools taken wholesale."""
    return slot_merge(cache, new, axes, slot, shared=True)


def restore_masked(old, new, axes, keep_mask: torch.Tensor):
    """Rows of batch-axis leaves where ``keep_mask`` (B,) is True keep
    their ``old`` value. This matters for slot-resident recurrent state
    only; on the dense family the batch-axis leaves are the page tables,
    which a decode tick does not change, so it returns ``new``. A leaf
    the forward returned as it was (``o is n``: the audio family's cross
    K/V outside a prefill with frames) is passed through without a
    ``torch.where``."""
    def f(o, n, a):
        if a < 0 or o is n:
            return n
        shape = [1] * n.dim()
        shape[a] = keep_mask.shape[0]
        return torch.where(keep_mask.reshape(shape), o.to(n.dtype), n)

    return tree_map(f, old, new, axes)


def map_paged(f, tree, *rest):
    """Map ``f`` over the ``PagedKVCache`` nodes of a cache tree (and the
    matching nodes of ``rest``); every other leaf passes through."""
    if isinstance(tree, PagedKVCache):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_paged(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_paged(f, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paged(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def has_slot_state(cache) -> bool:
    """True when the cache holds a tensor outside the ``PagedKVCache``
    pools: per-slot state (the xLSTM's, the hybrid's Mamba state, the
    audio family's cross K/V), which a page-table share cannot replay."""
    found = []
    tree_map(found.append, map_paged(lambda c: None, cache))
    return bool(found)


def push_page_table(cache, table):
    """Put the (max_batch, n_pages) table — host array or device tensor —
    into every PagedKVCache of the cache tree (one int32 device tensor
    shared by all layers, and by every group of the hybrid); pools, scales
    and codebooks pass through."""
    t = None

    def put(leaf):
        nonlocal t
        if t is None:
            dev = leaf.page_table.device
            t = (table.to(dev, torch.int32) if torch.is_tensor(table)
                 else torch.as_tensor(np.asarray(table, np.int32),
                                      device=dev))
        if t.shape != leaf.page_table.shape:
            raise ValueError(f"page table {tuple(t.shape)} vs the "
                             f"cache's {tuple(leaf.page_table.shape)}")
        return leaf._replace(page_table=t)

    return map_paged(put, cache)


# ---------------------------------------------------------------------------
# byte-denominated pool sizing
# ---------------------------------------------------------------------------

def pool_blocks_for_bytes(pool_bytes: int, cfg, layout_page_size: int,
                          kv_bits, dtype=torch.bfloat16) -> int:
    """Blocks a per-layer byte budget buys for this model's K/V pool
    (scratch block included); see kv_quant.blocks_for_bytes."""
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    return kv_quant.blocks_for_bytes(
        pool_bytes, layout_page_size, cfg.n_kv_heads, cfg.hd, kv_bits,
        dtype_bytes=dtype_bytes)


def pool_bytes_of(cfg, layout: PagedLayout, dtype=torch.bfloat16) -> int:
    """Per-layer byte size of a pool with this layout (both pools, scales
    and, for vq2, the codebooks; the page table is excluded)."""
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    total = layout.num_blocks * kv_quant.page_bytes(
        layout.page_size, cfg.n_kv_heads, cfg.hd, layout.kv.fmt,
        dtype_bytes=dtype_bytes)
    if layout.kv.vq:
        total += kv_quant.vq_overhead_bytes(cfg.n_kv_heads)
    return total
