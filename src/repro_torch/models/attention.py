"""GQA attention with dense and paged KV caches (port of
``repro/models/attention.py``).

Layout convention: activations (B, S, D); q/k/v (B, S, H, hd). Sequences
longer than ``FLASH_THRESHOLD`` (2048) tokens, in ``pre_out`` and in a
dense-``KVCache`` prefill, attend through ``flash_attention``
(kernels/flash_attention: the CUDA kernel on CUDA tensors, its plain
version, the reference's two-level scan, on CPU tensors); shorter ones
through ``_plain_attention``. ``causal=False`` and ``use_rope=False`` give
the whisper encoder's bidirectional attention and its decoder's un-rotated
self-attention; ``cross_pre_out`` / ``cross_apply`` attend from x to an
encoder memory (keys and values projected from ``memory``).

Cache updates are in place: the reference's caches are functional
(``.at[...].set`` under a donated ``jit``), while here a write goes straight
into the pool (``pool[blk, off] = rows``) and ``apply`` returns the same
cache object, so a decode tick never copies a pool.

Under a model axis that splits the heads (``models/parallel``, set by the
sharded train and serving steps) self-attention runs on the rank's own
heads: q from its columns of wq, its KV heads (its own columns of wk/wv,
or the ones its query heads read out of the whole projection), ``wo``'s
rows for its heads, and the output summed over the model axis. A serving
step's dense cache may hold only the rank's slice of the sequence
(``parallel.CacheSplit``): the new K/V go to the rank whose slice holds
their positions, a decode step attends over the slice
(``_partial_attention``) and merges over the group
(``parallel.merge_softmax``), and a prefill attends over its own whole
k and v.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_quant as kvq
from repro_torch.models import common as cm
from repro_torch.models import parallel as par
from repro_torch.obs import dispatch as obs_dispatch

NEG_INF = -1e30
# sequences longer than this take the chunked flash path
FLASH_THRESHOLD = 2048

# The "flash" dispatch counter: one impl, "fused" (the kernel on CUDA
# tensors, its plain version on CPU tensors). Unlike the reference's
# set_flash_impl there is no settable default: on the card the S > 2048
# path always takes the kernel. The reference's "xla" and "pallas" are
# both "fused" here.
_FLASH_COUNTS = obs_dispatch.register_dispatch("flash", ("fused",))

# Paged decode-attention read path of _paged_apply's S == 1 case:
#   "gather" — attend over the page-table-gathered logical view (the
#              reference default; also every prefill chunk)
#   "fused"  — kernels/paged_attention.paged_attention: the CUDA kernel on
#              CUDA tensors, its plain version on CPU tensors. The
#              reference's "xla" (oracle) and "pallas" (TPU kernel) pair
#              collapses into this one name.
# Callers thread their choice through apply(paged_impl=...). The live
# dispatch counter is registered with obs.dispatch.
PAGED_IMPLS = ("gather", "fused")
_PAGED_COUNTS = obs_dispatch.register_dispatch("paged", PAGED_IMPLS)


def check_paged_impl(impl: str) -> str:
    if impl not in PAGED_IMPLS:
        raise ValueError(
            f"paged attention impl {impl!r} not in {PAGED_IMPLS} (the "
            "reference's 'xla' and 'pallas' are both 'fused' here)")
    return impl


def init(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
         d_in: int | None = None):
    """q/k/v project from ``d_in`` (default d_model; the hybrid's shared
    block reads 2 * d_model), wo back to d_model."""
    D = d_in or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": cm.dense_init(gen, D, H * hd, dtype=dtype, device=device),
        "wk": cm.dense_init(gen, D, KV * hd, dtype=dtype, device=device),
        "wv": cm.dense_init(gen, D, KV * hd, dtype=dtype, device=device),
        "wo": cm.dense_init(gen, H * hd, cfg.d_model, dtype=dtype,
                            device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs (``common.P``): q/k/v columns and
    ``wo`` rows over the model axis, the other side over data."""
    s = {"wq": cm.P("data", "model"), "wk": cm.P("data", "model"),
         "wv": cm.P("data", "model"), "wo": cm.P("model", "data")}
    if cfg.qkv_bias:
        s.update({"bq": cm.P("model"), "bk": cm.P("model"),
                  "bv": cm.P("model")})
    if cfg.qk_norm:
        s.update({"q_norm": cm.P(None), "k_norm": cm.P(None)})
    return s


def split_modes(cfg: ModelConfig, axis) -> dict:
    """How a step on ``axis`` (``parallel.ModelAxis``) reads each leaf of
    ``specs``, as ``_project_qkv`` and ``attend`` read them under
    ``axis.heads``: wq / bq columns and wo rows of the rank's heads
    (SPLIT); wk / wv / bk / bv the rank's KV heads' columns (SPLIT), or
    whole when it keeps its KV heads from the whole projection
    (FULL_SUM); the norms applied to the rank's heads (FULL_SUM)."""
    split = axis.heads(cfg)
    if split is None:
        return {k: par.FULL for k in specs(cfg)}
    kv = par.SPLIT if split.kv_lo is None else par.FULL_SUM
    modes = {"wq": par.SPLIT, "bq": par.SPLIT, "wo": par.SPLIT, "wk": kv,
             "wv": kv, "bk": kv, "bv": kv, "q_norm": par.FULL_SUM,
             "k_norm": par.FULL_SUM}
    return {k: modes[k] for k in specs(cfg)}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Storage format of the paged KV pool: ``bits=16`` passthrough (the
    cache dtype verbatim), 8/4 int8 or packed-int4 code pages with per-row
    per-kv-head f32 scales, or ``mode="vq"`` (``KVQuantSpec.of("vq2")``,
    bits 2) packed 4-bit codebook indices over d=2 head-dim vectors against
    per-(pool, kv-head) codebooks carried as cache leaves, with scales."""
    bits: int = 16
    mode: str = "scalar"

    def __post_init__(self):
        if self.mode not in ("scalar", "vq"):
            raise ValueError(f"KV quant mode {self.mode!r}")
        if (self.mode == "vq") != (self.bits == 2) or self.bits not in (
                16, 8, 4, 2):
            raise ValueError(f"KV quant bits {self.bits} with mode "
                             f"{self.mode!r}")

    @classmethod
    def of(cls, bits) -> "KVQuantSpec":
        """Parse an engine/CLI ``kv_cache_bits``: 16/8/4 or "vq2"."""
        if isinstance(bits, KVQuantSpec):
            return bits
        if bits == kvq.VQ_BITS:
            return cls(bits=2, mode="vq")
        return cls(bits=int(bits))

    @property
    def quantized(self) -> bool:
        return self.bits < 16

    @property
    def vq(self) -> bool:
        return self.mode == "vq"

    @property
    def fmt(self):
        """kv_quant's format token: int bits or "vq2"."""
        return kvq.VQ_BITS if self.vq else self.bits

    def storage_cols(self, hd: int) -> int:
        return kvq.storage_cols(hd, self.fmt) if self.quantized else hd


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """``num_blocks`` blocks of ``page_size`` tokens shared by every slot;
    block 0 is the scratch block that idle slots' table entries point at
    (the allocator hands out 1..num_blocks-1). ``kv`` is the page format."""
    num_blocks: int
    page_size: int
    kv: KVQuantSpec = KVQuantSpec()

    def n_pages(self, max_len: int) -> int:
        return -(-max_len // self.page_size)


class PagedKVCache(NamedTuple):
    """KV pool + per-slot page table. ``k``/``v`` have no batch axis: logical
    page p of slot b lives in block ``page_table[b, p]``. Quantized pools
    hold int8 codes (``k``/``v`` last axis hd, hd//2 for int4, hd//4 for
    vq2) and f32 scales; vq2 pools also carry their frozen codebooks. The
    read and write paths key on which leaves are present, never on a spec.
    """
    k: torch.Tensor            # (num_blocks, page_size, KV, storage_cols)
    v: torch.Tensor
    page_table: torch.Tensor   # (B, n_pages) int32; 0 = scratch block
    k_scale: torch.Tensor | None = None     # (num_blocks, page_size, KV) f32
    v_scale: torch.Tensor | None = None
    k_codebook: torch.Tensor | None = None  # (KV, 16, 2) f32
    v_codebook: torch.Tensor | None = None


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     layout: PagedLayout, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    table = torch.zeros((batch, layout.n_pages(max_len)), dtype=torch.int32,
                        device=device)
    if layout.kv.quantized:
        shape = (layout.num_blocks, layout.page_size, cfg.n_kv_heads,
                 layout.kv.storage_cols(cfg.hd))
        codes = [torch.zeros(shape, dtype=torch.int8, device=device)
                 for _ in range(2)]
        scales = [torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                  for _ in range(2)]
        cbs = ([kvq.default_codebook(cfg.n_kv_heads, device=device)
                for _ in range(2)] if layout.kv.vq else [None, None])
        return PagedKVCache(codes[0], codes[1], table, *scales, *cbs)
    shape = (layout.num_blocks, layout.page_size, cfg.n_kv_heads, cfg.hd)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), table)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable (B,1,1,Sq,Sk).

    Scores and the value contraction accumulate in f32 (the reference's
    preferred_element_type); probabilities are rounded to v's dtype first,
    as the reference does."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k.to(torch.float32))
    s = s / math.sqrt(hd)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Chunked online-softmax attention (kernels/flash_attention) over
    q (B, Sq, H, hd), k/v (B, Sk, KV, hd); ``q_offset`` is q's first
    row's absolute position in the kv range (a Python int, always static
    here)."""
    _FLASH_COUNTS["fused"] += 1
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, q_offset=q_offset)


def _project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """q from x; k and v from ``kv_x`` (cross-attention's memory), or from
    x when it is None. Under a head split, the rank's heads."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    split = par.head_split(cfg) if kv_x is None else None
    if split is not None:
        x, H = par.enter(x, split.group), split.heads
    kv_x = x if kv_x is None else kv_x
    q = cm.matmul(x, p["wq"])
    k = cm.matmul(kv_x, p["wk"])
    v = cm.matmul(kv_x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, kv_x.shape[1], -1, hd)
    v = v.reshape(B, kv_x.shape[1], -1, hd)
    if split is not None and split.kv_lo is not None:
        heads = slice(split.kv_lo, split.kv_lo + split.kv_heads)
        k, v = k[:, :, heads], v[:, :, heads]
    if cfg.qk_norm:
        q = cm.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = cm.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _mask(Sq: int, Sk: int, device, causal: bool = True) -> torch.Tensor:
    """(1, 1, 1, Sq, Sk): column j <= row i when ``causal``, else all."""
    if not causal:
        return torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=device)
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])[None, None, None]


def _rope(q, k, cfg: ModelConfig, pos_arr, use_rope: bool):
    if not use_rope:
        return q, k
    return (cm.apply_rope(q, pos_arr, cfg.rope_theta),
            cm.apply_rope(k, pos_arr, cfg.rope_theta))


def project(p, cfg: ModelConfig, x, *, pos=0, use_rope: bool = True):
    """Self-attention's q (B, S, H, hd), k and v (B, S, KV, hd) of x, q and
    k rotated from ``pos`` unless ``use_rope=False``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    pos_arr = cm.position_ids(pos, B, S, device=x.device)
    q, k = _rope(q, k, cfg, pos_arr, use_rope)
    return q, k, v


def pre_out(p, cfg: ModelConfig, x, *, pos=0, causal: bool = True,
            use_rope: bool = True):
    """Self-attention (causal and with RoPE unless told otherwise) up to
    (but not including) ``wo``; returns (B, S, H*hd). The Hessian tap for
    the output projection."""
    B, S, _ = x.shape
    q, k, v = project(p, cfg, x, pos=pos, use_rope=use_rope)
    return _self_attention(q, k, v, causal=causal).reshape(B, S, -1)


def attend(p, cfg: ModelConfig, q, k, v, out_dtype, *,
           causal: bool = True):
    """The cache-free rest of self-attention after ``project``: attention
    of q over k/v and ``wo``; returns (B, S, D) in ``out_dtype``. Under a
    head split, the rank's part is summed over the model axis."""
    B, S = q.shape[:2]
    o = _self_attention(q, k, v, causal=causal).reshape(B, S, -1)
    y = cm.matmul(o, p["wo"])
    split = par.head_split(cfg)
    if split is not None:
        y = par.reduce(y, split.group)
    return y.to(out_dtype)


def _self_attention(q, k, v, *, causal: bool = True):
    """Attention of q over the same S positions of k/v (causal, or every
    position): the flash path for S > FLASH_THRESHOLD, else the dense
    masked softmax."""
    S = q.shape[1]
    if S > FLASH_THRESHOLD:
        return flash_attention(q, k, v, causal=causal)
    return _plain_attention(q, k, v, _mask(S, S, q.device, causal))


def cross_pre_out(p, cfg: ModelConfig, x, memory, *,
                  flash_threshold: int = FLASH_THRESHOLD):
    """Cross-attention from x (B, S, D) to ``memory`` (B, Sk, D) up to (but
    not including) ``wo``; returns (B, S, H*hd). Past ``flash_threshold``
    rows on either side it takes flash, which refuses an Sk the
    reference's kv chunks do not divide (whisper's 1,500 frames), as the
    reference does."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_x=memory)
    Sk = memory.shape[1]
    if max(S, Sk) > flash_threshold:
        o = flash_attention(q, k, v, causal=False)
    else:
        o = _plain_attention(q, k, v, _mask(S, Sk, x.device, causal=False))
    return o.reshape(B, S, -1)


def cross_apply(p, cfg: ModelConfig, x, memory):
    """Cross-attention (the whisper decoder's): keys and values from the
    encoder memory."""
    o = cross_pre_out(p, cfg, x, memory)
    return cm.matmul(o, p["wo"]).to(x.dtype)


def apply(p, cfg: ModelConfig, x: torch.Tensor, *, pos=0, cache=None,
          causal: bool = True, use_rope: bool = True,
          paged_impl: str = "gather"):
    """Self-attention; returns (y, cache).

    * no cache: attention over x (B, S, D), causal unless ``causal=False``.
    * ``KVCache``: K/V written at [pos, pos+S) (scalar pos); S == 1 decodes
      over cache[:pos+1], S > 1 is a prefill from position 0.
    * ``PagedKVCache``: ``pos`` may be a per-slot (B,) vector; K/V go into
      each slot's blocks through the page table (``_paged_apply``, whose
      mask is kpos <= pos: it refuses ``causal=False``).
    ``use_rope=False`` leaves q and k un-rotated, in the pages too.
    """
    B, S, _ = x.shape
    if not causal and isinstance(cache, PagedKVCache):
        raise ValueError("a PagedKVCache's mask is causal (kpos <= pos); "
                         "causal=False has no paged path")
    q, k, v = project(p, cfg, x, pos=pos, use_rope=use_rope)
    if cache is None:
        return attend(p, cfg, q, k, v, x.dtype, causal=causal), None

    if isinstance(cache, PagedKVCache):
        pos_arr = cm.position_ids(pos, B, S, device=x.device)  # (B, S)
        return _paged_apply(p, cache, q, k, v, pos_arr, x.dtype,
                            impl=paged_impl)

    start = int(pos)
    seq = par.cache_split()
    if seq is not None and seq.seq_group is None:
        seq = None
    # the rank's slice of the sequence: [lo, lo + Sl)
    Sl = cache.k.shape[1]
    lo = 0 if seq is None else seq.seq_rank * Sl
    a, b = max(start, lo), min(start + S, lo + Sl)
    if a < b:  # the new positions this rank's slice holds
        cache.k[:, a - lo:b - lo] = k[:, a - start:b - start].to(cache.k.dtype)
        cache.v[:, a - lo:b - lo] = v[:, a - start:b - start].to(cache.v.dtype)
    if S == 1:
        # decode: attend over the whole cache with a length mask
        valid = (lo + torch.arange(Sl, device=x.device) <= start)[
            None, None, None, None, :]
        if seq is None:
            o = _plain_attention(q, cache.k, cache.v, valid)
        else:  # each rank over its slice, merged over the group
            o = par.merge_softmax(*_partial_attention(
                q, cache.k, cache.v, valid), seq.seq_group).to(q.dtype)
    elif seq is None:
        # prefill from position 0
        o = _self_attention(q, cache.k[:, :S], cache.v[:, :S],
                            causal=causal)
    else:  # prefill from position 0 on the whole k, v, on every rank
        o = _self_attention(q, k.to(cache.k.dtype), v.to(cache.v.dtype),
                            causal=causal)
    y = cm.matmul(o.reshape(B, S, -1), p["wo"])
    split = par.head_split(cfg)
    if split is not None:
        y = par.reduce(y, split.group)
    return y.to(x.dtype), cache


def _partial_attention(q, k, v, mask):
    """``_plain_attention``'s softmax over one part of the keys, before
    its normalisation: (o (B, Sq, H, hd) f32, the sum of p @ v, m (B, Sq,
    H), the rows' max score, l (B, Sq, H), the sum of p), p = exp(s - m)
    rounded to v's dtype as ``_plain_attention`` rounds it."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k.to(torch.float32))
    s = s / math.sqrt(hd)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bkgqs,bskh->bqkgh", e.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))

    def rows(t):  # (B, KV, G, Sq) -> (B, Sq, H)
        return t.permute(0, 3, 1, 2).reshape(B, Sq, H)

    return o.reshape(B, Sq, H, hd), rows(m), rows(e.sum(-1))


def _page_slots(cache: PagedKVCache, pos_arr: torch.Tensor):
    """(block, row) of every new token: positions past the table (a padded
    prefill chunk can overhang max_len) go to the scratch block 0, never
    clipped into the slot's last live page."""
    page_size = cache.k.shape[1]
    n_pages = cache.page_table.shape[-1]
    page = pos_arr // page_size
    blk = torch.gather(cache.page_table, 1,
                       torch.clamp(page, max=n_pages - 1).long())
    blk = torch.where(page < n_pages, blk, torch.zeros_like(blk))
    return blk.long(), (pos_arr % page_size).long()


def _paged_apply(p, cache: PagedKVCache, q, k, v, pos_arr, out_dtype,
                 impl: str = "gather"):
    """Write the new K/V through the page table (in place), then attend.
    ``pos_arr`` (B, S) holds every new token's absolute position per slot
    (S > 1 in chunked prefill, 1 at decode).

    Quantized pools: the fresh rows are quantized here (per-row per-kv-head
    amax scales; int8 codes, int4 packed, or vq2 indices against the
    frozen codebooks) and every read path decodes through kernels/kv_quant.
    Decode (S == 1) with impl "fused" runs kernels/paged_attention; "gather"
    and every prefill chunk attend over the materialized logical view. The
    mask kpos <= pos hides scratch and stale rows on both paths.
    """
    B, S = pos_arr.shape
    page_size = cache.k.shape[1]
    n_pages = cache.page_table.shape[-1]
    blk, off = _page_slots(cache, pos_arr)
    if cache.k_codebook is not None:
        kc, ks = kvq.vq_quantize_rows(k, cache.k_codebook)
        vc, vs = kvq.vq_quantize_rows(v, cache.v_codebook)
    elif cache.k_scale is not None:
        bits = kvq.infer_bits(cache.k.shape[-1], q.shape[-1])
        kc, ks = kvq.quantize_kv(k, bits)
        vc, vs = kvq.quantize_kv(v, bits)
    else:
        kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
    cache.k[blk, off] = kc
    cache.v[blk, off] = vc
    if cache.k_scale is not None:
        cache.k_scale[blk, off] = ks
        cache.v_scale[blk, off] = vs

    check_paged_impl(impl)
    if S == 1 and impl == "fused":
        from repro_torch.kernels.paged_attention import paged_attention

        _PAGED_COUNTS["fused"] += 1
        o = paged_attention(
            q[:, 0].contiguous(), cache.k, cache.v, cache.page_table,
            pos_arr[:, 0].to(torch.int32).contiguous(),
            k_scale=cache.k_scale, v_scale=cache.v_scale,
            k_codebook=cache.k_codebook, v_codebook=cache.v_codebook)
        y = cm.matmul(o.reshape(B, 1, -1), p["wo"])
        return y.to(out_dtype), cache
    _PAGED_COUNTS["gather"] += 1

    from repro_torch.kernels.paged_attention import _decoded_view

    hd = q.shape[-1]
    if cache.k_scale is None:
        Sk = n_pages * page_size
        tbl = cache.page_table.long()
        kg = cache.k[tbl].reshape(B, Sk, *cache.k.shape[2:])
        vg = cache.v[tbl].reshape(B, Sk, *cache.v.shape[2:])
    else:
        kg = _decoded_view(cache.k, cache.k_scale, cache.k_codebook,
                           cache.page_table, hd)
        vg = _decoded_view(cache.v, cache.v_scale, cache.v_codebook,
                           cache.page_table, hd)
    # per-slot causal + length mask over logical positions
    msk = (torch.arange(kg.shape[1], device=q.device)[None, None, :]
           <= pos_arr[:, :, None])  # (B, S, Sk)
    o = _plain_attention(q, kg, vg, msk[:, None, None])
    y = cm.matmul(o.reshape(B, S, -1), p["wo"])
    return y.to(out_dtype), cache
