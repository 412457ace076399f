"""Zamba2-style hybrid: a Mamba2 trunk plus one *shared* attention block
applied every ``shared_attn_every`` layers with per-invocation LoRA deltas
(port of ``repro/models/hybrid.py``).

The shared block reads concat(hidden, initial embedding) (2 * d_model),
projects back to d_model, and its weights are stored once: each of the
``n_groups`` invocations adds its own low-rank (LoRA) delta to the q/k/v
projections. ``n_layers`` counts the Mamba layers and must divide by
``shared_attn_every``.

Layout: ``params["mamba"]`` is a list of groups, each a list of layer
dicts; ``params["lora"]`` keeps the reference's stacked (n_groups, ...)
factors. The reference scans a homogeneous trunk (two nested
``lax.scan``s) and loops a heterogeneous one (``_loop_groups``, a mixed
recipe); here one Python loop runs either. A cache is a ``HybridCache``:
per group one attention cache (``KVCache`` or ``PagedKVCache``), per layer
one ``ssm.SSMCache``, which stays slot-resident when the attention is paged.

Under a model axis (``models/parallel``) the embedding and the head read
the rank's vocabulary rows and columns, the shared block the rank's heads
(as ``attention`` splits them: the LoRA B factors' model split is the
same column split as the q/k/v weights they are added to, so each
group's densify A @ B gives the rank's columns) and each Mamba2 mixer the
rank's heads (``ssm``); ``param_modes`` says how each leaf is read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common as cm, ssm
from repro_torch.models import parallel as par


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.shared_attn_every
    assert per > 0 and cfg.n_layers % per == 0, (cfg.n_layers, per)
    return cfg.n_layers // per, per


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device=None) -> dict:
    dtype = cm.DTYPES[cfg.dtype]
    n_groups, per = _groups(cfg)
    D, H, KV, hd, r = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.shared_attn_lora_rank)
    kw = dict(dtype=dtype, device=device)
    params: dict[str, Any] = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, D, **kw),
        "final_norm": torch.ones((D,), **kw),
        "lm_head": cm.dense_init(gen, D, cfg.padded_vocab, **kw),
        "mamba": [[{"norm": torch.ones((D,), **kw),
                    "mixer": ssm.init(gen, cfg, **kw)}
                   for _ in range(per)] for _ in range(n_groups)],
        # the shared attention block over concat(h, emb0) = 2D input
        "shared": {"norm": torch.ones((2 * D,), **kw),
                   "attn": attention.init(gen, cfg, d_in=2 * D, **kw)},
        # per-invocation LoRA on q/k/v; B starts at zero, as the reference's
        "lora": {
            name: {"A": (torch.randn((n_groups, 2 * D, r), generator=gen,
                                     device=device) * 0.02).to(dtype),
                   "B": torch.zeros((n_groups, r, dim), **kw)}
            for name, dim in (("q", H * hd), ("k", KV * hd), ("v", KV * hd))
        },
    }
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs on the port's tree: the trunk a list
    of groups of layer dicts (the reference's two stacked axes dropped),
    the LoRA factors stacked (n_groups, ...) as in the reference."""
    n_groups, per = _groups(cfg)
    P = cm.P
    return {
        "embed": P("model", "data"), "final_norm": P(None),
        "lm_head": P("data", "model"),
        "mamba": [[{"norm": P(None), "mixer": ssm.specs(cfg)}
                   for _ in range(per)] for _ in range(n_groups)],
        "shared": {"norm": P(None), "attn": attention.specs(cfg)},
        "lora": {name: {"A": P(None, "data", None), "B": P(None, None, "model")}
                 for name in ("q", "k", "v")},
    }


def param_modes(cfg: ModelConfig, axis) -> dict:
    """``param_specs``' tree of how a step on ``axis`` reads each leaf:
    the embedding's rows and the head's columns split as the vocabulary
    is, the shared block as ``attention.split_modes`` reads its heads, each
    mixer as ``ssm.split_modes``; of the LoRA factors B as its weight (q's
    columns of the rank's heads, k's and v's as wk and wv are read) and A
    whole, its gradient a part on each rank of a head split (FULL_SUM)."""
    n_groups, per = _groups(cfg)
    vocab = par.SPLIT if axis.vocab(cfg) is not None else par.FULL
    attn = attention.split_modes(cfg, axis)
    heads = axis.heads(cfg) is not None
    mixer = ssm.split_modes(cfg, axis)
    lora = {name: {"A": par.FULL_SUM if heads else par.FULL, "B": attn[w]}
            for name, w in (("q", "wq"), ("k", "wk"), ("v", "wv"))}
    return {"embed": vocab, "final_norm": par.FULL, "lm_head": vocab,
            "mamba": [[{"norm": par.FULL, "mixer": mixer}
                       for _ in range(per)] for _ in range(n_groups)],
            "shared": {"norm": par.FULL, "attn": attn}, "lora": lora}


class HybridCache(NamedTuple):
    mamba: Any  # [group][layer] ssm.SSMCache
    attn: Any   # [group] KVCache or PagedKVCache, or None (no cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, paged=None, device=None) -> HybridCache:
    """The Mamba state is O(1) a slot and stays slot-resident; only the
    shared block's K/V (one stack a group) pages when serving."""
    n_groups, per = _groups(cfg)

    def attn_cache():
        if paged is not None:
            return attention.init_paged_cache(cfg, batch, max_len, paged,
                                              dtype, device=device)
        return attention.init_cache(cfg, batch, max_len, dtype,
                                    device=device)

    return HybridCache(
        mamba=[[ssm.init_cache(cfg, batch, device=device)
                for _ in range(per)] for _ in range(n_groups)],
        attn=[attn_cache() for _ in range(n_groups)])


def cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> HybridCache:
    """The reference's cache specs on the port's tree (its stacked group
    and layer axes, leading Nones, dropped): the Mamba state's batch over
    ``("pod", "data")``, its heads (h) and conv channels over ``model``;
    the shared block's K/V heads over ``model``, batch over ``("pod",
    "data")``, or with ``seq_shard`` over ``pod`` with the sequence over
    ``data``."""
    n_groups, per = _groups(cfg)
    dp = ("pod", "data")
    m = ssm.SSMCache(h=cm.P(dp, "model", None, None),
                     conv=cm.P(dp, None, "model"))
    seq_axis = "data" if seq_shard else None
    batch_axes = "pod" if seq_shard else dp
    kv = cm.P(batch_axes, seq_axis, "model", None)
    return HybridCache(mamba=[[m for _ in range(per)]
                              for _ in range(n_groups)],
                       attn=[attention.KVCache(kv, kv)
                             for _ in range(n_groups)])


def lora_group(lora, g: int) -> dict:
    """Group ``g``'s slice of the stacked "lora" tree."""
    return {name: {k: v[g] for k, v in f.items()} for name, f in lora.items()}


def lora_attn_params(p, lora_g, cfg: ModelConfig):
    """Shared-attention params with one group's LoRA delta folded in.

    ``lora_g`` is the per-group slice of the "lora" tree. The base weights
    stay shared (and may arrive dequantized from VQ); the low-rank A @ B
    delta is added densely per invocation."""
    attn_p = dict(p["attn"])
    for name, wname in (("q", "wq"), ("k", "wk"), ("v", "wv")):
        attn_p[wname] = attn_p[wname] + lora_g[name]["A"] @ lora_g[name]["B"]
    return attn_p


def shared_attn_input(p, cfg: ModelConfig, h, emb0):
    """The normalized concat(hidden, initial-embedding) stream entering the
    shared block's q/k/v: the Hessian tap of its projections."""
    return cm.rmsnorm(torch.cat([h, emb0], dim=-1), p["norm"], cfg.norm_eps)


def _shared_attn(p, lora_g, cfg: ModelConfig, h, emb0, *, pos, kv_cache,
                 paged_impl="gather"):
    """One invocation of the shared block with this group's LoRA delta."""
    xin = shared_attn_input(p, cfg, h, emb0)
    attn_p = lora_attn_params(p, lora_g, cfg)
    return attention.apply(attn_p, cfg, xin, pos=pos, cache=kv_cache,
                           paged_impl=paged_impl)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, pos=0,
            cache: HybridCache | None = None, paged_impl: str = "gather",
            last_only: bool = False, remat=False):
    """Returns (logits f32, new_cache, aux 0). The shared block must be
    dense when it runs (the LoRA deltas are added onto its q/k/v), so VQ
    leaves of the top tree, fused ones included, are densified here on
    every call, as the reference does; the trunk's ``FusedVQLinear``
    leaves stay on the ``vq_dequant_matmul`` kernel and its ``VQLinear``
    leaves are densified layer by layer (the gather form).

    ``remat`` (truthy) checkpoints each group, the shared block's
    invocation with its LoRA densify and the group's Mamba layers, as the
    reference's ``jax.checkpoint`` of its group body does; it matters only
    where autograd records a cache-free forward
    (``torch.utils.checkpoint``, non-reentrant)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import vq_linear as vql_mod

    dtype = cm.DTYPES[cfg.dtype]
    top = {k: v for k, v in params.items() if k != "mamba"}
    params = {**params, **vql_mod.dequant_tree(top, dtype,
                                               densify_fused=True)}
    x = par.embed(params["embed"], tokens, cfg)
    emb0 = x  # the initial embedding, re-fed to every shared invocation
    remat = remat if cache is None and torch.is_grad_enabled() else False

    def one_group(h, g, group_p):
        ha, kv = _shared_attn(
            params["shared"], lora_group(params["lora"], g), cfg, h, emb0,
            pos=pos, kv_cache=None if cache is None else cache.attn[g],
            paged_impl=paged_impl)
        h = h + ha
        new_layers = []
        for j, lp in enumerate(group_p):
            lp = vql_mod.dequant_tree(lp, dtype)
            y, c = ssm.apply(lp["mixer"], cfg,
                             cm.rmsnorm(h, lp["norm"], cfg.norm_eps),
                             None if cache is None else cache.mamba[g][j])
            h = h + y
            new_layers.append(c)
        return h, new_layers, kv

    new_m, new_kv = [], []
    for g, group_p in enumerate(params["mamba"]):
        if remat:
            x = checkpoint(lambda h, _g=g, _p=group_p: one_group(h, _g, _p)[0],
                           x, use_reentrant=False)
            continue
        x, new_layers, kv = one_group(x, g, group_p)
        new_m.append(new_layers)
        new_kv.append(kv)
    if last_only:
        x = x[:, -1:]
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = par.vocab_logits(x, params["lm_head"], cfg)
    new_cache = None if cache is None else HybridCache(new_m, new_kv)
    return logits, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)
