"""Paged decode attention over a shared KV block pool.

Port of ``repro/kernels/paged_attention.py`` (the Pallas kernel) and of its
oracle ``repro/kernels/ref.py::paged_attention_ref``; ``paged_attention``
also takes the place of the dispatch in ``repro/kernels/ops.py``. For CUDA
tensors ``paged_attention`` launches the CUDA kernels
``csrc/paged_attention.cu``; for CPU tensors it runs the plain PyTorch
version ``paged_attention_plain``. ``paged_attention.launches`` counts
calls of the kernel path (a split kernel and, with more than one split, the
merge of the splits: one call, one count).

One query token per slot attends over its own pages: logical row kpos of
slot b lives in block ``page_table[b, kpos // page_size]``, row
``kpos % page_size``, and only rows with ``kpos <= pos[b]`` count (this
masks the last page's tail, stale rows of recycled blocks and the scratch
block 0 that idle slots map). Pools hold f32 or bf16 values, int8 or packed
int4 codes with per-row per-kv-head f32 scales, or vq2 indices into
per-kv-head (16, 2) codebooks with scales; ``kernels/kv_quant.py`` decodes
them.

The kernel splits each slot's walk over its pages into runs of
``split_plan(...).pages_per_split`` pages, one CTA each, and merges the
runs in order. The plan depends on the page size, the head dim, the query
heads per kv head and the page format only, never on the batch, the table's
width or any slot's position, so a slot's output is the same bits alone or
in any batch. The wrapper never reads a device tensor on the host.

Fake tensors (the dry run, ``launch/dryrun``) launch nothing: the plan is
made as on the card, the output and the splits' scratch are made, and the
work is recorded in ``obs/work`` over every slot's whole table (the
positions are data: neither the trace nor the count reads them); the
launch counter stays as it was. On CUDA tensors the same record is made
while a count is on.
"""
from __future__ import annotations

import array
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import kv_quant as kvq
from repro_torch.obs import work

NEG_INF = -1e30
# the card's shared memory per block (H100: 227 KB)
_SMEM_LIMIT = 227 * 1024
# the kernel's page formats (csrc/paged_attention.cu, enum Fmt)
_FMT_F32, _FMT_BF16, _FMT_INT8, _FMT_INT4, _FMT_VQ2 = range(5)
# storage bits of one head dim in each format
_DIM_BITS = {_FMT_F32: 32, _FMT_BF16: 16, _FMT_INT8: 8, _FMT_INT4: 4,
             _FMT_VQ2: 2}
# csrc constants: threads (4 warps) a CTA, codebook bytes, read slack
_WARPS, _CB_BYTES, _SLACK = 4, 2 * kvq.VQ_K * kvq.VQ_D * 4, 32
# live rows a split walks and the page buffers of its ring: near the
# fastest of a sweep over 1-16 pages a split and 1-2 buffers on the H100 at
# Llama-2-7B's and Qwen2-72B's heads over 4096 tokens (PERF.md).
# Shorter splits pay their fixed costs (the merge of the warps, the
# partial) more often, longer ones leave short slots to few CTAs; one
# buffer read nearly as fast as two (the kernel is instruction-bound once
# the bytes are in flight), and more buffers cost CTAs an SM
_SPLIT_ROWS = 128
_RING_BYTES, _MAX_STAGES = 32 * 1024, 2


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts a slot's walk and lays out a CTA:
    ``pages_per_split`` logical pages a split (CTA), ``stages`` (1 or 2)
    page buffers in its shared-memory ring, ``heads_per_cta`` query heads of one
    kv head a CTA, ``dims_per_lane`` head dims a lane holds in registers (4
    or 8; 0: the wide variant, head dims above 256, with q and the sums in
    shared memory), ``lanes_per_row`` lanes that share a row, and the CTA's
    ``smem_bytes``."""

    pages_per_split: int
    stages: int
    heads_per_cta: int
    dims_per_lane: int
    lanes_per_row: int
    smem_bytes: int


def _round16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=1024)
def split_plan(page_size: int, hd: int, G: int, fmt: int) -> SplitPlan:
    """The split plan of a call, a function of the page size, the head dim,
    the query heads per kv head and the page format only: never of the
    batch, the page table's width or any slot's position, so the order of
    every sum of a slot is fixed. Raises if even one page buffer does not
    fit in shared memory. Mirrors csrc ``smem_bytes`` and ``stage_bytes``."""
    pps = max(1, _SPLIT_ROWS // page_size)
    row_bytes = -(-hd * _DIM_BITS[fmt] // 8)
    stage = _round16(2 * page_size * _round16(row_bytes)
                     + (8 * page_size if fmt >= _FMT_INT8 else 0))
    head = _CB_BYTES + _round16(4 * pps)  # codebooks, the split's block ids
    if hd > 256:
        gt, dpl, lpr = 1, 0, 32
        fixed = (head + _round16(4 * hd) + 4 * _WARPS * hd
                 + _round16(_WARPS * 2 * 4))
        smem = lambda s: fixed + s * stage + _SLACK
    else:
        gt = next(n for n in (8, 4, 2, 1) if G % n == 0)
        dpl = 4 if hd <= 128 else 8
        lpr = 1 << (-(-hd // dpl) - 1).bit_length()
        red = 4 * _WARPS * gt * (hd + 2)
        smem = lambda s: head + max(s * stage + _SLACK, red)
    stages = max(1, min(_MAX_STAGES, _RING_BYTES // stage))
    while stages > 1 and smem(stages) > _SMEM_LIMIT:
        stages -= 1
    if smem(stages) > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: a page of {page_size} rows of "
                         f"{row_bytes} bytes (K and V) needs "
                         f"{smem(stages)} B of shared memory, above "
                         f"{_SMEM_LIMIT}")
    return SplitPlan(pps, stages, gt, dpl, lpr, smem(stages))


def _decoded_view(pool, scale, codebook, page_table, hd: int):
    """(B, n_pages * page_size, KV, hd) f32 logical view of a pool."""
    B, n_pages = page_table.shape
    page_size, KV = pool.shape[1], pool.shape[2]
    Sk = n_pages * page_size
    tbl = page_table.long()
    g = pool[tbl].reshape(B, Sk, KV, -1)
    if codebook is not None:
        return kvq.vq_dequant_rows(g, scale[tbl].reshape(B, Sk, KV), codebook)
    if scale is not None:
        bits = kvq.infer_bits(pool.shape[-1], hd)
        return kvq.dequant_rows(g, scale[tbl].reshape(B, Sk, KV), bits)
    return g.to(torch.float32)


def paged_attention_plain(q, k_pool, v_pool, page_table, pos, k_scale=None,
                          v_scale=None, k_codebook=None, v_codebook=None):
    """Plain version, the math of ``ref.paged_attention_ref``: gather and
    decode the logical view through the page table, mask kpos > pos to
    -1e30, dense softmax attention in f32. q (B, H, hd) -> (B, H, hd) in
    q's dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    kg = _decoded_view(k_pool, k_scale, k_codebook, page_table, hd)
    vg = _decoded_view(v_pool, v_scale, v_codebook, page_table, hd)
    Sk = kg.shape[1]
    qh = q.reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qh, kg) / math.sqrt(hd)
    valid = (torch.arange(Sk, device=q.device)[None, None, None, :]
             <= pos.to(torch.long)[:, None, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, vg)
    return o.reshape(B, H, hd).to(q.dtype)


def _page_format(q, k_pool, k_scale, k_codebook) -> int:
    """The kernel's format code for these pools; raises on a layout that
    neither the kernel nor the plain version takes."""
    hd = q.shape[-1]
    cols = k_pool.shape[-1]
    if k_codebook is not None:
        if hd % (2 * kvq.VQ_D) or cols != hd // (2 * kvq.VQ_D):
            raise ValueError(f"paged_attention: vq2 pages need head_dim % 4 "
                             f"== 0 and hd/4 columns, got hd={hd}, "
                             f"cols={cols}")
        return _FMT_VQ2
    if k_scale is not None:
        if cols == hd:
            return _FMT_INT8
        if hd % 2 == 0 and cols == hd // 2:
            return _FMT_INT4
        raise ValueError(f"paged_attention: {cols} code columns fit neither "
                         f"int8 nor int4 pages of head_dim {hd}")
    if cols != hd:
        raise ValueError(f"paged_attention: pool has {cols} columns, "
                         f"head_dim is {hd}")
    if k_pool.dtype == torch.float32:
        return _FMT_F32
    if k_pool.dtype == torch.bfloat16:
        return _FMT_BF16
    raise ValueError(f"paged_attention: pool dtype {k_pool.dtype}")


def _copy_width(row_bytes: int, *ptrs: int) -> int:
    """Bytes a cp.async copies (16, 8 or 4) for rows of ``row_bytes`` in
    pools at ``ptrs``; 0 (plain loads) when not even 4 bytes divide them."""
    for w in (16, 8, 4):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 0


def paged_attention(q, k_pool, v_pool, page_table, pos, *, k_scale=None,
                    v_scale=None, k_codebook=None, v_codebook=None):
    """Paged decode attention; q (B, H, hd) f32/bf16, pools
    (num_blocks, page_size, KV, cols), page_table (B, n_pages) int32,
    pos (B,) int32 -> (B, H, hd) in q's dtype. ``k_scale``/``v_scale``
    (num_blocks, page_size, KV) f32 mark int8/int4 code pools;
    ``k_codebook``/``v_codebook`` (KV, 16, 2) f32 with scales mark vq2
    pools. Inputs are checked on every device, so CPU callers meet the
    kernel's contract too."""
    cuda = q.is_cuda
    if not cuda and q.device.type != "cpu":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(page_table.shape)} must be 3-, 4-, 2-D")
    B, H, hd = q.shape
    pool_shape = k_pool.shape
    num_blocks, page_size, KV, cols = pool_shape
    n_pages = page_table.shape[1]
    if (H % KV or v_pool.shape != pool_shape
            or v_pool.dtype != k_pool.dtype or page_table.shape[0] != B
            or pos.shape != (B,)):
        raise ValueError(
            f"paged_attention: inconsistent shapes q {tuple(q.shape)} pools "
            f"{tuple(pool_shape)}/{tuple(v_pool.shape)} table "
            f"{tuple(page_table.shape)} pos {tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None) or (
            (k_codebook is None) != (v_codebook is None)):
        raise ValueError("paged_attention: give both K and V scales "
                         "(codebooks) or neither")
    if k_codebook is not None and k_scale is None:
        raise ValueError("paged_attention: vq2 pools need their scales")
    fmt = _page_format(q, k_pool, k_scale, k_codebook)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: q dtype {q.dtype}")
    checks = [("q", q, q.dtype), ("k_pool", k_pool, k_pool.dtype),
              ("v_pool", v_pool, k_pool.dtype),
              ("page_table", page_table, torch.int32),
              ("pos", pos, torch.int32)]
    if fmt >= _FMT_INT8:
        checks.append(("k_pool", k_pool, torch.int8))
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != pool_shape[:3]:
                raise ValueError(f"paged_attention: {name} "
                                 f"{tuple(t.shape)} vs the pool's "
                                 f"{tuple(pool_shape[:3])}")
            checks.append((name, t, torch.float32))
    if fmt == _FMT_VQ2:
        for name, t in (("k_codebook", k_codebook),
                        ("v_codebook", v_codebook)):
            if t.shape != (KV, kvq.VQ_K, kvq.VQ_D):
                raise ValueError(f"paged_attention: {name} "
                                 f"{tuple(t.shape)} vs "
                                 f"{(KV, kvq.VQ_K, kvq.VQ_D)}")
            checks.append((name, t, torch.float32))
    where = q.get_device()  # the card's index, -1 on the CPU
    for name, t, dt in checks:
        if (t.dtype != dt or t.get_device() != where
                or not t.is_contiguous()):
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    G = H // KV
    plan = split_plan(page_size, hd, G, fmt)
    if not cuda:
        return paged_attention_plain(q, k_pool, v_pool, page_table, pos,
                                     k_scale, v_scale, k_codebook, v_codebook)
    out = torch.empty_like(q)
    if B == 0:
        return out
    pps = plan.pages_per_split
    n_splits = -(-n_pages // pps)
    # each split's (acc[G, hd], max, sum) per kv head; the tensor stays
    # referenced until the launch has been queued
    part = None
    if n_splits > 1:
        part = torch.empty((B * KV * n_splits * G * (hd + 2),),
                           dtype=torch.float32, device=q.device)
    row_bytes = cols * k_pool.element_size()
    fake = work.is_fake(q)
    if fake or work.active() is not None:
        # every slot's table span: the positions are data, read by
        # neither the trace nor the count
        work.kernel("paged_attention", "split_kv", work.paged_attention_work(
            B * n_pages * page_size, B, H, KV, hd,
            row_bytes + (4 if k_scale is not None else 0), q.element_size(),
            page_table.numel(), fmt == _FMT_VQ2))
    if fake:  # the dry run: the kernel's outputs and scratch, nothing run
        return out
    k_ptr, v_ptr = k_pool.data_ptr(), v_pool.data_ptr()
    cp = _copy_width(row_bytes, k_ptr, v_ptr)
    units = row_bytes // cp if cp else row_bytes
    copy_lanes = min(32, 1 << (units.bit_length() - 1))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    # every argument in one int64 array, in the order of csrc's struct Args
    args = array.array("q", (
        q.data_ptr(), q.dtype == torch.bfloat16, k_ptr, v_ptr,
        ptr(k_scale), ptr(v_scale), ptr(k_codebook), ptr(v_codebook),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), ptr(part),
        B, H, KV, hd, row_bytes, page_size, n_pages, num_blocks, fmt, pps,
        n_splits, plan.stages, plan.heads_per_cta, plan.dims_per_lane,
        plan.lanes_per_row, cp, copy_lanes, build.current_stream(q.device)))
    rc = build.load("paged_attention").paged_attention_launch(
        args.buffer_info()[0])
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
