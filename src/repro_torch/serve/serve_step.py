"""Prefill / decode step builders (port of ``repro/serve/serve_step.py``).

Parameter trees may hold ``VQLinear`` leaves (densified per layer, the
"gather" form) or ``FusedVQLinear`` leaves (every matmul through the
``vq_dequant_matmul`` kernel, the "fused" form); see core/vq_linear.

``make_paged_decode`` / ``make_slot_prefill`` are the paged engine's tick
functions (per-slot position vectors, page tables, chunked prefill over
B=1 slot views). The reference compiles each with ``jax.jit``; here they
run eagerly and update the pools in place. ``make_prefill`` /
``make_decode`` are the dense-cache builders, the correctness anchor of the
paged path, and ``teacher_forced_logits`` is the paged path's drift probe.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_zoo import Model


def make_prefill(model: Model, last_only: bool = False, axis=None):
    """Whole-prompt prefill from position 0 over a dense cache. ``axis``
    (``parallel.serve_axis``): a rank of a sharded step, given its
    parameters (``Layout.rank_params``), rows (``parallel.rank_rows``) and
    cache (``parallel.rank_tree``); its logits are its vocabulary
    columns."""
    from repro_torch.models import parallel as par

    def prefill(params, batch, cache):
        with torch.no_grad(), par.using(axis):
            logits, cache, _ = model.forward(params, batch, cache=cache,
                                             pos=0, last_only=last_only)
        return logits, cache

    return prefill


def make_decode(model: Model, axis=None):
    """One decode step; ``axis`` as ``make_prefill``'s."""
    from repro_torch.models import parallel as par

    def decode(params, tokens, cache, pos):
        """tokens (B, S); pos: scalar start position, or a per-slot (B,)
        vector over a paged cache."""
        with torch.no_grad(), par.using(axis):
            logits, cache, _ = model.forward(params, {"tokens": tokens},
                                             cache=cache, pos=pos)
        return logits, cache

    return decode


def make_paged_decode(model: Model, axes, paged_impl: str = "gather"):
    """One decode tick over a paged cache. ``axes`` is the batch-axis tree
    from paged_cache.batch_axes. ``paged_impl`` is captured per engine and
    threaded through the forward (no module state); the params arrive in
    their VQ form already (the engine retags them once)."""
    from repro_torch.serve import paged_cache as pc
    from repro_torch.serve import sampling

    def decode(params, tokens, cache, pos, table, keep_mask, gen, temps):
        """tokens (B, 1); pos (B,) per-slot write positions; table
        (B, n_pages) rows of decoding slots (scratch elsewhere); keep_mask
        (B,) slots whose slot-resident state keeps its pre-tick value;
        ``gen`` the engine's generator; temps (B,) per-slot temperatures
        (<= 0 greedy). Returns (next tokens (B,) int32, cache)."""
        cache = pc.push_page_table(cache, table)
        with torch.no_grad():
            logits, new_cache, _ = model.forward(
                params, {"tokens": tokens}, cache=cache, pos=pos,
                paged_impl=paged_impl)
            nxt = sampling.sample(gen, logits[:, -1], temperature=temps)
        return nxt, pc.restore_masked(cache, new_cache, axes, keep_mask)

    return decode


def make_slot_prefill(model: Model, axes):
    """One chunked-prefill step: push the page table, take a B=1 view of
    ``slot``, run the chunk from position ``start``, merge the view back.
    Prefill is pinned to the gather read path, width-1 tail chunks
    included."""
    from repro_torch.serve import paged_cache as pc

    def chunk(params, tokens, cache, slot, start, last_idx, table):
        cache = pc.push_page_table(cache, table)
        view = pc.slot_view_dyn(cache, axes, slot)
        pos = torch.full((1,), start, dtype=torch.long, device=tokens.device)
        with torch.no_grad():
            logits, new_view, _ = model.forward(
                params, {"tokens": tokens}, cache=view, pos=pos,
                paged_impl="gather")
        # only the last real token's logits are ever sampled
        return logits[0, last_idx], pc.slot_merge_dyn(cache, new_view, axes,
                                                      slot)

    return chunk


def teacher_forced_logits(model: Model, params, prompt, forced, *, cache,
                          paged_impl: str = "gather") -> torch.Tensor:
    """Per-step next-token logits of one sequence through a paged cache:
    the whole prompt in one gather prefill (the cache's table row 0 must
    map enough pages), then one S=1 decode step per token of ``forced``
    with ``paged_impl``. Returns (len(forced) + 1, V) f32: row 0 after the
    prompt, row i after forced[i-1]. The drift probe of the paged path: two
    runs on the same forced tokens compare logits of identical inputs."""
    dev = params["embed"].device
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    rows = []
    with torch.no_grad():
        logits, cache, _ = model.forward(
            params, {"tokens": tokens}, cache=cache,
            pos=torch.zeros((1,), dtype=torch.long, device=dev),
            paged_impl="gather")
        rows.append(logits[0, -1])
        pos = tokens.shape[1]
        for tok in forced:
            logits, cache, _ = model.forward(
                params, {"tokens": torch.tensor([[int(tok)]], device=dev)},
                cache=cache, pos=torch.full((1,), pos, device=dev),
                paged_impl=paged_impl)
            rows.append(logits[0, -1])
            pos += 1
    return torch.stack(rows).to(torch.float32)
