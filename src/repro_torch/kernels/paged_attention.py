"""Paged decode attention over a shared KV block pool.

Port of ``repro/kernels/paged_attention.py`` (the Pallas kernel) and of its
oracle ``repro/kernels/ref.py::paged_attention_ref``; ``paged_attention``
also takes the place of the dispatch in ``repro/kernels/ops.py``. For CUDA
tensors ``paged_attention`` launches the CUDA kernel
``csrc/paged_attention.cu``; for CPU tensors it runs the plain PyTorch
version ``paged_attention_plain``. ``paged_attention.launches`` counts
kernel launches.

One query token per slot attends over its own pages: logical row kpos of
slot b lives in block ``page_table[b, kpos // page_size]``, row
``kpos % page_size``, and only rows with ``kpos <= pos[b]`` count (this
masks the last page's tail, stale rows of recycled blocks and the scratch
block 0 that idle slots map). Pools hold f32 or bf16 values, int8 or packed
int4 codes with per-row per-kv-head f32 scales, or vq2 indices into
per-kv-head (16, 2) codebooks with scales; ``kernels/kv_quant.py`` decodes
them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import kv_quant as kvq

NEG_INF = -1e30
_SMEM_LIMIT = 200 * 1024
# the kernel's page formats (csrc/paged_attention.cu, enum Fmt)
_FMT_F32, _FMT_BF16, _FMT_INT8, _FMT_INT4, _FMT_VQ2 = range(5)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_attention(q, k_pool, v_pool, page_table, pos, *, k_scale=None,
                    v_scale=None, k_codebook=None, v_codebook=None):
    """Paged decode attention; q (B, H, hd) f32/bf16, pools
    (num_blocks, page_size, KV, cols), page_table (B, n_pages) int32,
    pos (B,) int32 -> (B, H, hd) in q's dtype. ``k_scale``/``v_scale``
    (num_blocks, page_size, KV) f32 mark int8/int4 code pools;
    ``k_codebook``/``v_codebook`` (KV, 16, 2) f32 with scales mark vq2
    pools. Inputs are checked on every device, so CPU callers meet the
    kernel's contract too."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(page_table.shape)} must be 3-, 4-, 2-D")
    B, H, hd = q.shape
    num_blocks, page_size, KV, cols = k_pool.shape
    n_pages = page_table.shape[1]
    if (H % KV or tuple(v_pool.shape) != tuple(k_pool.shape)
            or v_pool.dtype != k_pool.dtype or page_table.shape[0] != B
            or tuple(pos.shape) != (B,)):
        raise ValueError(
            f"paged_attention: inconsistent shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} table "
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
            if tuple(t.shape) != (num_blocks, page_size, KV):
                raise ValueError(f"paged_attention: {name} "
                                 f"{tuple(t.shape)} vs the pool's "
                                 f"{(num_blocks, page_size, KV)}")
            checks.append((name, t, torch.float32))
    if fmt == _FMT_VQ2:
        for name, t in (("k_codebook", k_codebook),
                        ("v_codebook", v_codebook)):
            if tuple(t.shape) != (KV, kvq.VQ_K, kvq.VQ_D):
                raise ValueError(f"paged_attention: {name} "
                                 f"{tuple(t.shape)} vs "
                                 f"{(KV, kvq.VQ_K, kvq.VQ_D)}")
            checks.append((name, t, torch.float32))
    for name, t, dt in checks:
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    G = H // KV
    smem = 4 * (2 * G * hd + 2 * page_size * hd + G * page_size + 3 * G
                + 2 * kvq.VQ_K * kvq.VQ_D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: G={G}, hd={hd}, page_size="
                         f"{page_size} need {smem} B of shared memory")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, pos,
                                     k_scale, v_scale, k_codebook, v_codebook)
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = build.load("paged_attention").paged_attention_launch
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
            v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            _ptr(k_codebook), _ptr(v_codebook), page_table.data_ptr(),
            pos.data_ptr(),
            out.data_ptr(), B, H, KV, hd, cols, page_size, n_pages,
            num_blocks, fmt, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
