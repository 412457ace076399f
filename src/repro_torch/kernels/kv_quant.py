"""Low-bit KV-page quantization math, shared by every paged read/write path
(port of ``repro/kernels/kv_quant.py``).

The write site (``models/attention._paged_apply``), the gather read path,
the plain paged attention (``kernels/paged_attention.paged_attention_plain``)
and, expression for expression, the CUDA kernel
(``kernels/csrc/paged_attention.cu``) all decode pages through this module,
so a page decodes to the same f32 values whichever path reads it. Each op is
bitwise equal to the reference's.

Format: symmetric per-row, per-kv-head scales
``scale[row, kv] = amax(|x[row, kv, :]|) / qmax`` (f32) and int8 codes
``clip(round_half_even(x / scale), -qmax, qmax)``. int4 packs two codes per
byte along the head dim (column 2j in the low nibble, 2j+1 in the high
nibble, sign-extended on unpack). Zero rows get scale 0 and decode to 0.

vq2 pages: each row stores 4-bit codebook indices over d=2 vectors along
the head dim (2 bits per value) against frozen per-(pool, kv-head)
codebooks (KV, 16, 2); rows are amax-normalized before assignment and the
per-row f32 scale is kept, so dequant is ``codebook[idx] * scale``. The
reference decodes with a one-hot matmul (its Pallas kernel cannot gather);
in f32 that is bitwise a gather, which is what this port does.
"""
from __future__ import annotations

import torch

# bits -> largest code magnitude (int4 uses [-7, 7]; -8 is never produced)
QMAX = {8: 127, 4: 7}
PASSTHROUGH_BITS = 16

# vector-quantized page format: d=2 vectors, 16-entry codebooks
VQ_BITS = "vq2"
VQ_D = 2
VQ_K = 16


def storage_cols(hd: int, bits) -> int:
    """Last-axis width of a quantized pool holding ``hd`` head dims."""
    if bits == VQ_BITS:
        if hd % (2 * VQ_D):
            raise ValueError(f"vq2 packing needs head_dim % 4 == 0, got {hd}")
        return hd // (2 * VQ_D)
    if bits == 4:
        if hd % 2:
            raise ValueError(f"int4 packing needs even head_dim, got {hd}")
        return hd // 2
    if bits != 8:
        raise ValueError(f"no quantized storage for bits={bits!r}")
    return hd


def infer_bits(stored_cols: int, hd: int) -> int:
    """Code width from the pool's stored last axis: hd -> 8, hd//2 -> 4."""
    if stored_cols == hd:
        return 8
    if stored_cols != hd // 2:
        raise ValueError(f"stored cols {stored_cols} fit neither int8 nor "
                         f"int4 pages of head_dim {hd}")
    return 4


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(..., hd) int8 codes in [-7, 7] -> (..., hd//2) int8 bytes."""
    lo = codes[..., 0::2] & 0x0F
    hi = codes[..., 1::2] & 0x0F
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., hd//2) int8 bytes -> (..., hd) int8 codes (sign-extended)."""
    lo = (packed << 4) >> 4          # int8 shifts: arithmetic, wrapping
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def quantize_kv(x: torch.Tensor, bits: int):
    """Fresh K or V rows for a page write: x (..., KV, hd) float ->
    (codes (..., KV, storage_cols) int8, scales (..., KV) f32)."""
    qmax = QMAX[bits]
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = amax / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(xf / safe[..., None]), -qmax, qmax)
    codes = codes.to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes)
    return codes, scale


def dequant_rows(codes: torch.Tensor, scales: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """codes (..., storage_cols) int8 + scales (...,) f32 -> (..., hd) f32."""
    if bits == 4:
        codes = unpack_int4(codes)
    return codes.to(torch.float32) * scales[..., None].to(torch.float32)


# ---------------------------------------------------------------------------
# vector-quantized pages (vq2)
# ---------------------------------------------------------------------------

def default_codebook(n_kv_heads: int, device=None) -> torch.Tensor:
    """A 4x4 uniform grid over [-1, 1]^2 per kv head -> (KV, 16, 2) f32:
    the uncalibrated codebook a vq2 pool starts with."""
    # jnp.linspace's f32 arithmetic, start * (1 - t) + stop * t, so the
    # grid is bitwise the reference's (torch.linspace rounds differently)
    t = torch.arange(4, dtype=torch.float32, device=device) / 3.0
    axis = -1.0 * (1.0 - t) + 1.0 * t
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return grid[None].expand(n_kv_heads, VQ_K, VQ_D).contiguous()


def pack_vq2(idx: torch.Tensor) -> torch.Tensor:
    """(..., hd//2) indices in [0, 16) -> (..., hd//4) int8 bytes (index 2j
    in the low nibble, 2j+1 in the high nibble)."""
    lo = idx[..., 0::2].to(torch.int32) & 0x0F
    hi = idx[..., 1::2].to(torch.int32) & 0x0F
    return (lo | (hi << 4)).to(torch.int8)


def unpack_vq2(packed: torch.Tensor) -> torch.Tensor:
    """(..., hd//4) int8 bytes -> (..., hd//2) int32 indices in [0, 16);
    unsigned nibbles, never sign-extended."""
    p = packed.to(torch.int32) & 0xFF
    lo = p & 0x0F
    hi = (p >> 4) & 0x0F
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def vq_quantize_rows(x: torch.Tensor, codebook: torch.Tensor):
    """Assign fresh K or V rows to a frozen codebook for a page write:
    x (..., KV, hd) float, codebook (KV, 16, 2) f32 ->
    (codes (..., KV, hd//4) int8, scales (..., KV) f32). L2-nearest entry,
    lowest index on ties; zero rows keep scale 0."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    xn = xf / safe[..., None]
    vecs = xn.reshape(*xn.shape[:-1], xn.shape[-1] // VQ_D, VQ_D)
    # (..., KV, S, 1, d) - (KV, 1, k, d) -> (..., KV, S, k)
    diff = vecs[..., :, None, :] - codebook.to(torch.float32)[..., None, :, :]
    dist = torch.sum(diff * diff, dim=-1)
    idx = torch.argmin(dist, dim=-1)  # first minimum: lowest index on ties
    return pack_vq2(idx), amax


def vq_dequant_rows(codes: torch.Tensor, scales: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """codes (..., hd//4) int8 + scales (...,) f32 + codebook (..., 16, 2)
    f32, its leading dims broadcasting against codes' -> (..., hd) f32."""
    idx = unpack_vq2(codes)                          # (..., hd//2)
    lead = codebook.shape[:-2]
    n_cb = 1
    for s in lead:
        n_cb *= s
    # flat row of each leading position's codebook in (n_cb * 16, 2)
    base = torch.arange(n_cb, device=codes.device).reshape(lead)
    base = base.expand(codes.shape[:-1])
    flat = codebook.to(torch.float32).reshape(n_cb * VQ_K, VQ_D)
    vecs = flat[base[..., None] * VQ_K + idx]        # (..., hd//2, 2)
    out = vecs.reshape(*codes.shape[:-1], -1)
    return out * scales[..., None].to(torch.float32)


# ---------------------------------------------------------------------------
# byte accounting (serve-side pool sizing)
# ---------------------------------------------------------------------------

def row_bytes(hd: int, bits, *, dtype_bytes: int = 2) -> int:
    """Bytes one written token costs per kv head in ONE pool (K or V),
    including its f32 scale; ``dtype_bytes`` is the passthrough element
    size."""
    if bits == PASSTHROUGH_BITS:
        return hd * dtype_bytes
    if bits == VQ_BITS:
        return hd // (2 * VQ_D) + 4
    return hd * bits // 8 + 4


def vq_overhead_bytes(n_kv_heads: int) -> int:
    """Fixed per-layer bytes of the two frozen f32 codebooks (K and V)."""
    return 2 * n_kv_heads * VQ_K * VQ_D * 4


def page_bytes(page_size: int, n_kv_heads: int, hd: int, bits, *,
               dtype_bytes: int = 2) -> int:
    """Bytes of one physical block across both K and V pools (+ scales)."""
    return 2 * page_size * n_kv_heads * row_bytes(hd, bits,
                                                  dtype_bytes=dtype_bytes)


def blocks_for_bytes(pool_bytes: int, page_size: int, n_kv_heads: int,
                     hd: int, bits, *, dtype_bytes: int = 2) -> int:
    """Physical blocks (scratch block 0 included) a per-layer byte budget
    buys; vq2 deducts its codebooks first. A budget below scratch + one
    usable block raises ValueError."""
    per_block = page_bytes(page_size, n_kv_heads, hd, bits,
                           dtype_bytes=dtype_bytes)
    budget = pool_bytes
    if bits == VQ_BITS:
        budget = pool_bytes - vq_overhead_bytes(n_kv_heads)
    n = int(budget // per_block)
    if n < 2:
        raise ValueError(
            f"pool_bytes={pool_bytes} buys {n} block(s) of {per_block} B "
            f"(page_size={page_size}, kv_bits={bits}); need >= 2 "
            f"(scratch + one usable)")
    return n
