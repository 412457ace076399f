"""Decoder-only LM assembly, dense kind (port of ``repro/models/transformer.py``).

The reference stores homogeneous stacks with a leading layer axis and scans
them; here ``params["layers"]`` is a list of per-layer dicts run by a Python
loop. ``_block_apply`` densifies ``VQLinear`` leaves through
``vq_linear.dequant_tree`` (the gather form), while ``FusedVQLinear`` leaves
reach ``common.matmul`` (the fused kernel). MoE and xLSTM blocks are not
ported yet (ROADMAP.md queue 1, "The other five families").
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common as cm, mlp
from repro_torch.pending import not_ported


init_cache = not_ported("transformer.init_cache", "Paged serving engine")


def _block_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": attention.init(gen, cfg, dtype, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ffn": mlp.init(gen, cfg, dtype, device=device),
    }


def _block_apply(p, cfg: ModelConfig, x, *, pos=0):
    """One pre-norm residual block; VQLinear leaves are densified first."""
    from repro_torch.core import vq_linear as vql_mod

    p = vql_mod.dequant_tree(p, cm.DTYPES[cfg.dtype])  # no-op if not VQ
    x = x + attention.apply(p["attn"], cfg,
                            cm.rmsnorm(x, p["norm1"], cfg.norm_eps), pos=pos)
    h2 = cm.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp.apply(p["ffn"], cfg, h2)


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device=None) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1, "
            "'The other five families')")
    dtype = cm.DTYPES[cfg.dtype]
    params: dict[str, Any] = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                               device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                          dtype=dtype, device=device)
    params["layers"] = [_block_init(gen, cfg, dtype, device)
                        for _ in range(cfg.n_layers)]
    return params


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens]  # gather


def unembed(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return cm.matmul(x, w).to(torch.float32)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, pos=0):
    """Returns (logits, new_cache, aux_loss) as the reference does; logits
    are f32, there is no cache yet and the dense kind has no aux loss."""
    from repro_torch.core import vq_linear as vql_mod

    top = {k: v for k, v in params.items() if k != "layers"}
    params = {**params, **vql_mod.dequant_tree(top, cm.DTYPES[cfg.dtype])}
    x = embed_tokens(params, cfg, tokens)
    for layer_p in params["layers"]:
        x = _block_apply(layer_p, cfg, x, pos=pos)
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, cfg, x), None, aux
