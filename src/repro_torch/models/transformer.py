"""Decoder-only LM assembly: dense GQA, MoE and xLSTM block stacks (port of
``repro/models/transformer.py``).

The reference stores homogeneous stacks with a leading layer axis and scans
them; here ``params["layers"]`` is a list of per-layer dicts run by a Python
loop, and a cache is a list with one entry per layer (not a slice of a
stacked leaf): a ``KVCache`` or ``PagedKVCache`` for an attention block, an
``xlstm.MLSTMCache`` / ``SLSTMCache`` for a recurrent one, which stays
slot-resident even when a ``PagedLayout`` is passed. ``_block_apply``
densifies ``VQLinear`` leaves through ``vq_linear.dequant_tree`` (the
gather form), while ``FusedVQLinear`` leaves reach ``common.matmul`` /
``common.expert_matmul`` (the fused kernel). A MoE block's FFN is
``models/moe`` (expert stacks with a leading E); its load-balancing loss is
summed over the layers into ``forward``'s aux. The vlm family runs this
stack with patch embeddings prepended (``extra_embeds``). Of the families,
``PORTED`` run here or, the hybrid and audio, in ``models/hybrid`` and
``models/encdec``; any other family raises. Under a model axis
(``models/parallel``) the embedding and the head read the rank's
vocabulary rows and columns, so ``forward``'s logits are its columns.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common as cm, mlp, moe, xlstm
from repro_torch.models import parallel as par

PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
PENDING: tuple[str, ...] = ()


def block_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.family == "ssm" and cfg.name.startswith("xlstm"):
        return "slstm" if i in tuple(cfg.slstm_layers) else "mlstm"
    return "moe" if cfg.family == "moe" else "dense"


def homogeneous(cfg: ModelConfig) -> bool:
    """Whether the reference stacks (and scans) the layers: every block of
    one kind, dense or moe."""
    kinds = {block_kind(cfg, i) for i in range(cfg.n_layers)}
    return len(kinds) == 1 and next(iter(kinds)) in ("dense", "moe")


def _block_init(gen, cfg: ModelConfig, kind: str, dtype, device):
    if kind in ("mlstm", "slstm"):
        init = xlstm.mlstm_init if kind == "mlstm" else xlstm.slstm_init
        return {"norm1": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "core": init(gen, cfg, dtype, device=device)}
    ffn = moe.init if kind == "moe" else mlp.init
    return {
        "norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": attention.init(gen, cfg, dtype, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ffn": ffn(gen, cfg, dtype, device=device),
    }


def _block_apply(p, cfg: ModelConfig, kind: str, x, *, pos=0, cache=None,
                 paged_impl="gather", save_attn: bool = False):
    """One pre-norm residual block; VQLinear leaves are densified first.
    Returns (x, new_cache, aux_loss). ``save_attn`` (``remat="save_attn"``,
    cache-free, dense or moe): the head (norm1, q/k/v, RoPE) and the tail
    (residual, norm2, FFN) are checkpointed around the attention and
    ``wo``, whose residuals autograd keeps, so a backward re-runs the head
    and the tail but not the attention."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import vq_linear as vql_mod

    p = vql_mod.dequant_tree(p, cm.DTYPES[cfg.dtype])  # no-op if not VQ
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mlstm":
        h, new_c = xlstm.mlstm_apply(
            p["core"], cfg, cm.rmsnorm(x, p["norm1"], cfg.norm_eps), cache)
        return x + h, new_c, aux
    if kind == "slstm":
        xin = cm.rmsnorm(x, p["norm1"], cfg.norm_eps)
        h, new_c = xlstm.slstm_apply(p["core"], cfg, xin, cache)
        x = x + h
        x = x + xlstm.slstm_ffn(
            p["core"], cfg, cm.rmsnorm(x, p["core"]["ffn_norm"], cfg.norm_eps))
        return x, new_c, aux

    def tail(x, h):
        x = x + h
        h2 = cm.rmsnorm(x, p["norm2"], cfg.norm_eps)
        if kind == "moe":
            f, aux = moe.apply(p["ffn"], cfg, h2)
        else:
            f, aux = mlp.apply(p["ffn"], cfg, h2), torch.zeros(
                (), dtype=torch.float32, device=x.device)
        return x + f, aux

    if save_attn:
        q, k, v = checkpoint(
            lambda x: attention.project(p["attn"], cfg, cm.rmsnorm(
                x, p["norm1"], cfg.norm_eps), pos=pos), x,
            use_reentrant=False)
        h = attention.attend(p["attn"], cfg, q, k, v, x.dtype)
        x, aux = checkpoint(tail, x, h, use_reentrant=False)
        return x, None, aux
    h, new_kv = attention.apply(
        p["attn"], cfg, cm.rmsnorm(x, p["norm1"], cfg.norm_eps), pos=pos,
        cache=cache, paged_impl=paged_impl)
    x, aux = tail(x, h)
    return x, new_kv, aux


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, paged, device):
    # recurrent state is O(1) per slot: it stays slot-resident even when
    # the attention leaves are paged
    if kind == "mlstm":
        return xlstm.mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.slstm_cache(cfg, batch, device)
    if paged is not None:
        return attention.init_paged_cache(cfg, batch, max_len, paged, dtype,
                                          device=device)
    return attention.init_cache(cfg, batch, max_len, dtype, device=device)


def _check_family(cfg: ModelConfig):
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not a family of the port; ported: "
            f"{', '.join(PORTED)}")


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device=None) -> dict:
    _check_family(cfg)
    dtype = cm.DTYPES[cfg.dtype]
    params: dict[str, Any] = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                               device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                          dtype=dtype, device=device)
    params["layers"] = [_block_init(gen, cfg, block_kind(cfg, i), dtype,
                                    device) for i in range(cfg.n_layers)]
    return params


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    P = cm.P
    if kind == "mlstm":
        return {"norm1": P(None), "core": xlstm.mlstm_specs(cfg)}
    if kind == "slstm":
        return {"norm1": P(None), "core": xlstm.slstm_specs(cfg)}
    return {"norm1": P(None), "attn": attention.specs(cfg), "norm2": P(None),
            "ffn": moe.specs(cfg) if kind == "moe" else mlp.specs(cfg)}


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs on the port's tree: one dict a layer
    in ``layers`` (the reference's stacked layer axis, a leading None,
    dropped), the embedding's vocabulary rows and the head's columns over
    the model axis."""
    _check_family(cfg)
    specs: dict[str, Any] = {"embed": cm.P("model", "data"),
                             "final_norm": cm.P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = cm.P("data", "model")
    specs["layers"] = [_block_specs(cfg, block_kind(cfg, i))
                       for i in range(cfg.n_layers)]
    return specs


def param_modes(cfg: ModelConfig, axis) -> dict:
    """``param_specs``' tree of how a step on ``axis``
    (``parallel.ModelAxis``) reads each leaf (``parallel.SPLIT``,
    ``FULL`` or ``FULL_SUM``), each layer's from its own module; the
    embedding and the head split as ``embed_tokens`` / ``unembed`` split
    them."""
    _check_family(cfg)
    vocab = par.SPLIT if axis.vocab(cfg) is not None else par.FULL
    modes: dict[str, Any] = {"embed": vocab, "final_norm": par.FULL}
    if not cfg.tie_embeddings:
        modes["lm_head"] = vocab
    layers = []
    for i in range(cfg.n_layers):
        kind = block_kind(cfg, i)
        if kind in ("mlstm", "slstm"):
            core = (xlstm.mlstm_split_modes if kind == "mlstm"
                    else xlstm.slstm_split_modes)
            layers.append({"norm1": par.FULL, "core": core(cfg, axis)})
            continue
        ffn = moe if kind == "moe" else mlp
        layers.append({"norm1": par.FULL,
                       "attn": attention.split_modes(cfg, axis),
                       "norm2": par.FULL, "ffn": ffn.split_modes(cfg, axis)})
    modes["layers"] = layers
    return modes


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, paged=None, device=None) -> list:
    """One cache per layer. ``paged``: an attention.PagedLayout — each
    attention layer gets its own block pools and page table (serving); None
    keeps the dense (B, max_len) layout. Recurrent layers hold their f32
    state either way."""
    _check_family(cfg)
    return [_block_cache(cfg, block_kind(cfg, i), batch, max_len, dtype,
                         paged, device) for i in range(cfg.n_layers)]


def cache_specs(cfg: ModelConfig) -> list:
    """The reference's cache specs on the port's tree (one entry a layer;
    the reference's stacked layer axis, a leading None, dropped): K/V
    batch over ``("pod", "data")`` and heads over ``model``, a recurrent
    block's state batch over ``("pod", "data")``. The dry run
    (``launch/dryrun.cache_shardings``) picks a placement from the shape
    cell, as the reference's does."""
    dp = ("pod", "data")
    kv = cm.P(dp, None, "model", None)
    out = []
    for i in range(cfg.n_layers):
        kind = block_kind(cfg, i)
        if kind in ("dense", "moe"):
            out.append(attention.KVCache(kv, kv))
        else:
            one = (xlstm.MLSTMCache if kind == "mlstm" else xlstm.SLSTMCache)
            out.append(one(*(cm.P(dp) for _ in one._fields)))
    return out


def embed_tokens(params, cfg: ModelConfig, tokens, extra_embeds=None):
    x = par.embed(params["embed"], tokens, cfg)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    """f32 logits; under a vocabulary split, this rank's columns."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return par.vocab_logits(x, w, cfg)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, pos=0,
            cache=None, extra_embeds=None, paged_impl: str = "gather",
            last_only: bool = False, remat=False):
    """Returns (logits, new_cache, aux_loss); logits are f32, aux_loss the
    MoE layers' summed load-balancing loss (0 for the others).
    ``extra_embeds`` (B, n, D) are prepended to the token embeddings (the
    vlm's patches), so the logits cover n + S positions. ``pos`` is a
    scalar start position or, over paged caches, a per-slot (B,) vector. ``paged_impl`` picks the paged decode
    read ("gather" | "fused", see attention._paged_apply). VQ leaves run in
    the form they arrive in (VQLinear: gather, FusedVQLinear: fused; see
    vq_linear.retag, which callers such as the engine apply once).
    ``last_only`` keeps only the last position's logits.

    ``remat`` (the reference's: ``True``, ``False`` or ``"save_attn"``)
    matters only where autograd records a cache-free forward: ``True``
    checkpoints each block (``torch.utils.checkpoint``, non-reentrant), so
    the backward re-runs it; ``"save_attn"`` checkpoints a dense or moe
    block around its attention (``_block_apply(save_attn=True)``), so the
    backward does not re-run attention. A stack the reference keeps as a
    list of layers (the xLSTM) takes a plain per-layer checkpoint for any
    truthy ``remat``, as the reference's layer loop does. The default is
    ``False`` here (eager evaluation keeps nothing for a backward); the
    train step passes its own."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import vq_linear as vql_mod

    top = {k: v for k, v in params.items() if k != "layers"}
    params = {**params, **vql_mod.dequant_tree(top, cm.DTYPES[cfg.dtype])}
    x = embed_tokens(params, cfg, tokens, extra_embeds)
    new_cache = None if cache is None else []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat if cache is None and torch.is_grad_enabled() else False
    for i, layer_p in enumerate(params["layers"]):
        kind = block_kind(cfg, i)
        if remat == "save_attn" and homogeneous(cfg):
            x, _, a = _block_apply(layer_p, cfg, kind, x, pos=pos,
                                   save_attn=True)
        elif remat:
            x, _, a = checkpoint(
                lambda h, _p=layer_p, _k=kind: _block_apply(
                    _p, cfg, _k, h, pos=pos), x, use_reentrant=False)
        else:
            x, new_c, a = _block_apply(
                layer_p, cfg, kind, x, pos=pos,
                cache=None if cache is None else cache[i],
                paged_impl=paged_impl)
            if cache is not None:
                new_cache.append(new_c)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), new_cache, aux
