"""GQA attention, the cache-free half (port of ``repro/models/attention.py``).

Layout convention: activations (B, S, D); q/k/v (B, S, H, hd). The KV caches
(dense and paged) and cross-attention are not ported yet (ROADMAP.md queue
1, "Paged serving engine", "The other five families"), nor is the chunked
flash path for S > 2048 (ROADMAP.md queue 1, "Kernel 4").
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.pending import not_ported

NEG_INF = -1e30
# sequences longer than this take the reference's chunked flash path
FLASH_THRESHOLD = 2048

init_cache = not_ported("attention.init_cache", "Paged serving engine")
init_paged_cache = not_ported("attention.init_paged_cache",
                              "Paged serving engine")


def init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D = cfg.d_model
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


def _project_qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = cm.matmul(x, p["wq"])
    k = cm.matmul(x, p["wk"])
    v = cm.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = cm.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = cm.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def pre_out(p, cfg: ModelConfig, x, *, pos=0):
    """Causal self-attention with RoPE up to (but not including) ``wo``;
    returns (B, S, H*hd). The Hessian tap for the output projection."""
    B, S, _ = x.shape
    if S > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {S} > {FLASH_THRESHOLD} needs the chunked "
            "flash-attention path, not ported yet (ROADMAP.md queue 1, "
            "'Kernel 4')")
    q, k, v = _project_qkv(p, cfg, x)
    pos_arr = cm.position_ids(pos, B, S, device=x.device)
    q = cm.apply_rope(q, pos_arr, cfg.rope_theta)
    k = cm.apply_rope(k, pos_arr, cfg.rope_theta)
    ar = torch.arange(S, device=x.device)
    causal = (ar[None, :] <= ar[:, None])[None, None, None]
    return _plain_attention(q, k, v, causal).reshape(B, S, -1)


def apply(p, cfg: ModelConfig, x: torch.Tensor, *, pos=0) -> torch.Tensor:
    """Cache-free causal self-attention, (B, S, D) -> (B, S, D)."""
    return cm.matmul(pre_out(p, cfg, x, pos=pos), p["wo"]).to(x.dtype)
