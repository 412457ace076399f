"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings (B, encoder_seq, d_model). Learned absolute
positional embeddings on both sides, GELU MLPs, biased QKV, pre-norm. The
encoder attends bidirectionally without RoPE; the decoder's self-attention
is causal without RoPE, and its cross-attention reads the encoder memory.

Layout: ``params["enc_layers"]`` and ``params["dec_layers"]`` are lists of
per-layer dicts (the reference stacks them on a leading axis and scans).
A cache is an ``EncDecCache``: per decoder layer one self-attention cache
(``KVCache``, or ``PagedKVCache`` when serving) and one pair of cross K/V
(B, S_enc, KV, hd) tensors, computed from the memory at a prefill with
frames and slot-resident after that, like recurrent state.

Under a model axis (``models/parallel``) the tied embedding reads the
rank's vocabulary rows (the lookup and the head's columns), every self-
and cross-attention the rank's heads (the cross K/V of its KV heads from
the memory, its q and ``wo`` rows, summed over the axis) and every MLP
its hidden units; ``param_modes`` says how each leaf is read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common as cm, mlp
from repro_torch.models import parallel as par


class EncDecCache(NamedTuple):
    self_kv: Any   # [layer] KVCache or PagedKVCache
    cross_k: Any   # [layer] (B, S_enc, KV, hd) in the cache dtype
    cross_v: Any


def _enc_block_init(gen, cfg: ModelConfig, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return {"norm1": torch.ones((cfg.d_model,), **kw),
            "attn": attention.init(gen, cfg, dtype, device=device),
            "norm2": torch.ones((cfg.d_model,), **kw),
            "ffn": mlp.init(gen, cfg, dtype, device=device)}


def _dec_block_init(gen, cfg: ModelConfig, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return {"norm1": torch.ones((cfg.d_model,), **kw),
            "self_attn": attention.init(gen, cfg, dtype, device=device),
            "norm_x": torch.ones((cfg.d_model,), **kw),
            "cross_attn": attention.init(gen, cfg, dtype, device=device),
            "norm2": torch.ones((cfg.d_model,), **kw),
            "ffn": mlp.init(gen, cfg, dtype, device=device)}


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device=None) -> dict:
    """Random weights; the lm head is tied to ``embed`` (whisper)."""
    dtype = cm.DTYPES[cfg.dtype]
    kw = dict(dtype=dtype, device=device)
    return {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, **kw),
        "pos_enc": cm.embed_init(gen, cfg.encoder_seq, cfg.d_model, **kw),
        "pos_dec": cm.embed_init(gen, cfg.max_seq_len, cfg.d_model, **kw),
        "enc_layers": [_enc_block_init(gen, cfg, dtype, device)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [_dec_block_init(gen, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
        "enc_norm": torch.ones((cfg.d_model,), **kw),
        "final_norm": torch.ones((cfg.d_model,), **kw),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs on the port's tree: one dict a layer
    in ``enc_layers`` and ``dec_layers`` (the stacked axis dropped)."""
    P = cm.P

    def enc_one():
        return {"norm1": P(None), "attn": attention.specs(cfg),
                "norm2": P(None), "ffn": mlp.specs(cfg)}

    def dec_one():
        return {"norm1": P(None), "self_attn": attention.specs(cfg),
                "norm_x": P(None), "cross_attn": attention.specs(cfg),
                "norm2": P(None), "ffn": mlp.specs(cfg)}

    return {"embed": P("model", "data"), "pos_enc": P(None, "data"),
            "pos_dec": P(None, "data"),
            "enc_layers": [enc_one() for _ in range(cfg.n_encoder_layers)],
            "dec_layers": [dec_one() for _ in range(cfg.n_layers)],
            "enc_norm": P(None), "final_norm": P(None)}


def param_modes(cfg: ModelConfig, axis) -> dict:
    """``param_specs``' tree of how a step on ``axis`` reads each leaf:
    the embedding split as the vocabulary is, the positional tables and
    norms whole, each attention (cross-attention too) as
    ``attention.split_modes`` reads its heads and each MLP as
    ``mlp.split_modes``."""
    vocab = par.SPLIT if axis.vocab(cfg) is not None else par.FULL
    attn, ffn = attention.split_modes(cfg, axis), mlp.split_modes(cfg, axis)
    F = par.FULL
    return {"embed": vocab, "pos_enc": F, "pos_dec": F,
            "enc_layers": [{"norm1": F, "attn": attn, "norm2": F,
                            "ffn": ffn}
                           for _ in range(cfg.n_encoder_layers)],
            "dec_layers": [{"norm1": F, "self_attn": attn, "norm_x": F,
                            "cross_attn": attn, "norm2": F, "ffn": ffn}
                           for _ in range(cfg.n_layers)],
            "enc_norm": F, "final_norm": F}


def embed_frames(params, cfg: ModelConfig, frames: torch.Tensor):
    """Add learned positional embeddings to the (stub) frame embeddings;
    the stream keeps the frames' dtype, as the reference's."""
    return frames + params["pos_enc"][None, :frames.shape[1]].to(frames.dtype)


def enc_block_apply(layer_p, cfg: ModelConfig, h):
    """One encoder block (bidirectional attention + MLP) on (B, S_enc, D)."""
    a, _ = attention.apply(layer_p["attn"], cfg,
                           cm.rmsnorm(h, layer_p["norm1"], cfg.norm_eps),
                           causal=False, use_rope=False)
    h = h + a
    return h + mlp.apply(layer_p["ffn"], cfg,
                         cm.rmsnorm(h, layer_p["norm2"], cfg.norm_eps))


def encode(params, cfg: ModelConfig, frames: torch.Tensor, remat=False):
    """frames (B, S_enc, D) -> the memory (B, S_enc, D). ``VQLinear``
    leaves are densified layer by layer (the gather form);
    ``FusedVQLinear`` ones reach the fused kernel. ``remat`` (truthy)
    checkpoints each layer where autograd records, as the reference's
    ``jax.checkpoint`` of its layer body."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import vq_linear as vql_mod

    def body(h, layer_p):
        return enc_block_apply(
            vql_mod.dequant_tree(layer_p, cm.DTYPES[cfg.dtype]), cfg, h)

    remat = remat and torch.is_grad_enabled()
    x = embed_frames(params, cfg, frames)
    for layer_p in params["enc_layers"]:
        x = (checkpoint(body, x, layer_p, use_reentrant=False) if remat
             else body(x, layer_p))
    return cm.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, paged=None, device=None) -> EncDecCache:
    """Self-attention K/V pages when serving (``paged``: a PagedLayout), a
    dense (B, max_len) cache otherwise; the cross K/V are fixed-size
    per-slot encoder projections and stay slot-resident either way,
    zeroed."""
    def self_kv():
        if paged is not None:
            return attention.init_paged_cache(cfg, batch, max_len, paged,
                                              dtype, device=device)
        return attention.init_cache(cfg, batch, max_len, dtype,
                                    device=device)

    shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    zeros = lambda: [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(cfg.n_layers)]
    return EncDecCache(self_kv=[self_kv() for _ in range(cfg.n_layers)],
                       cross_k=zeros(), cross_v=zeros())


def cache_specs(cfg: ModelConfig) -> EncDecCache:
    """The reference's cache specs on the port's tree (one entry a layer;
    its stacked layer axis, a leading None, dropped): self and cross K/V
    batch over ``("pod", "data")`` and heads over ``model``."""
    kv = cm.P(("pod", "data"), None, "model", None)
    n = cfg.n_layers
    return EncDecCache(self_kv=[attention.KVCache(kv, kv) for _ in range(n)],
                       cross_k=[kv] * n, cross_v=[kv] * n)


def _cross_kv(layer_p, cfg: ModelConfig, memory):
    """The cross K/V (B, S_enc, KV, hd) of ``memory``; under a head split
    the KV heads the rank's query heads read (its own columns of wk/wv, or
    its heads of the whole projection)."""
    B, S, _ = memory.shape
    hd = cfg.hd
    split = par.head_split(cfg)
    if split is not None:
        memory = par.enter(memory, split.group)
    k = cm.matmul(memory, layer_p["wk"]).reshape(B, S, -1, hd)
    v = cm.matmul(memory, layer_p["wv"]).reshape(B, S, -1, hd)
    if cfg.qkv_bias:
        k = k + layer_p["bk"].reshape(-1, hd)
        v = v + layer_p["bv"].reshape(-1, hd)
    if split is not None and split.kv_lo is not None:
        heads = slice(split.kv_lo, split.kv_lo + split.kv_heads)
        k, v = k[:, :, heads], v[:, :, heads]
    return k, v


def _cross_attend(layer_p, cfg: ModelConfig, x, ck, cv):
    """Plain all-ones-mask attention of x over the cross K/V, then wo;
    under a head split the rank's heads, summed over the model axis."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    split = par.head_split(cfg)
    if split is not None:
        x, H = par.enter(x, split.group), split.heads
    q = cm.matmul(x, layer_p["wq"]).reshape(B, S, H, hd)
    if cfg.qkv_bias:
        q = q + layer_p["bq"].reshape(H, hd)
    o = attention._plain_attention(
        q, ck, cv, attention._mask(S, ck.shape[1], x.device, causal=False))
    y = cm.matmul(o.reshape(B, S, H * hd), layer_p["wo"])
    if split is not None:
        y = par.reduce(y, split.group)
    return y.to(x.dtype)


def dec_block_apply(layer_p, cfg: ModelConfig, h, memory):
    """One decoder block (causal self-attention, cross-attention over
    ``memory``, MLP) on (B, S, D): the cache-free path, which the audio
    adapter's advance runs (core/adapters/encdec.py)."""
    a, _ = attention.apply(layer_p["self_attn"], cfg,
                           cm.rmsnorm(h, layer_p["norm1"], cfg.norm_eps),
                           use_rope=False)
    h = h + a
    ck, cv = _cross_kv(layer_p["cross_attn"], cfg, memory)
    h = h + _cross_attend(layer_p["cross_attn"], cfg,
                          cm.rmsnorm(h, layer_p["norm_x"], cfg.norm_eps),
                          ck.to(h.dtype), cv.to(h.dtype))
    return h + mlp.apply(layer_p["ffn"], cfg,
                         cm.rmsnorm(h, layer_p["norm2"], cfg.norm_eps))


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, frames=None,
            memory=None, pos=0, cache: EncDecCache | None = None,
            last_only: bool = False, paged_impl: str = "gather",
            remat=False):
    """Decoder forward; returns (logits f32, new_cache, aux 0). Give
    ``frames`` (prefill or evaluation: the encoder runs) or a cache whose
    cross K/V a previous prefill filled; ``memory`` (the encoder's output)
    stands in for frames beside a cache.

    With a cache and frames or memory, the new cache holds the cross K/V
    computed from the memory (in the cache's dtype); with a cache and
    neither, the cache's own cross K/V are read and returned, the same
    tensor objects (the engine's ``restore_masked`` then skips them). The
    self-attention cache is updated in place, as ``attention.apply``
    does.

    ``remat`` (truthy) checkpoints each encoder and each decoder layer
    where autograd records a cache-free forward, as the reference's
    ``jax.checkpoint`` of its layer bodies does (non-reentrant
    ``torch.utils.checkpoint``; the backward re-runs the layer)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import vq_linear as vql_mod

    if frames is None and cache is None:
        raise ValueError("encdec.forward needs frames or a cache whose "
                         "cross K/V a prefill filled")
    dtype = cm.DTYPES[cfg.dtype]
    top = {k: v for k, v in params.items()
           if k not in ("enc_layers", "dec_layers")}
    params = {**params, **vql_mod.dequant_tree(top, dtype)}
    remat = remat if cache is None and torch.is_grad_enabled() else False
    if frames is not None:
        memory = encode(params, cfg, frames, remat)

    B, S = tokens.shape
    x = par.embed(params["embed"], tokens, cfg)
    pos_ids = cm.position_ids(pos, B, S, device=x.device)
    x = x + params["pos_dec"][pos_ids].to(x.dtype)
    fill_cross = cache is not None and memory is not None
    new_kv, new_ck, new_cv = [], [], []
    for i, layer_p in enumerate(params["dec_layers"]):
        if remat:
            x = checkpoint(
                lambda h, p, m: dec_block_apply(
                    vql_mod.dequant_tree(p, dtype), cfg, h, m),
                x, layer_p, memory, use_reentrant=False)
            continue
        lp = vql_mod.dequant_tree(layer_p, dtype)
        a, kv = attention.apply(
            lp["self_attn"], cfg, cm.rmsnorm(x, lp["norm1"], cfg.norm_eps),
            pos=pos, cache=None if cache is None else cache.self_kv[i],
            use_rope=False, paged_impl=paged_impl)
        x = x + a
        if memory is not None:
            ck, cv = _cross_kv(lp["cross_attn"], cfg, memory)
        else:
            ck, cv = cache.cross_k[i], cache.cross_v[i]
        x = x + _cross_attend(lp["cross_attn"], cfg,
                              cm.rmsnorm(x, lp["norm_x"], cfg.norm_eps),
                              ck.to(x.dtype), cv.to(x.dtype))
        x = x + mlp.apply(lp["ffn"], cfg,
                          cm.rmsnorm(x, lp["norm2"], cfg.norm_eps))
        if cache is not None:
            new_kv.append(kv)
            if fill_cross:
                ck = ck.to(cache.cross_k[i].dtype)
                cv = cv.to(cache.cross_v[i].dtype)
            new_ck.append(ck)
            new_cv.append(cv)
    if last_only:
        x = x[:, -1:]
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = par.vocab_logits(x, params["embed"].T, cfg)
    new_cache = (None if cache is None
                 else EncDecCache(new_kv, new_ck, new_cv))
    return logits, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)
