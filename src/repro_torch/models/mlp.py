"""Dense MLP blocks (gated SwiGLU/GeGLU, relu^2, gelu); port of
``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D, F = cfg.d_model, cfg.d_ff
    p = {
        "w_in": cm.dense_init(gen, D, F, dtype=dtype, device=device),
        "w_out": cm.dense_init(gen, F, D, dtype=dtype, device=device),
    }
    if cm.is_gated(cfg.activation):
        p["w_gate"] = cm.dense_init(gen, D, F, dtype=dtype, device=device)
    return p


def pre_out(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Hidden activations entering ``w_out`` — the Hessian tap for the down
    projection (core/adapters/*)."""
    act = cm.act_fn(cfg.activation)
    h = cm.matmul(x, p["w_in"])
    if cm.is_gated(cfg.activation):
        h = act(cm.matmul(x, p["w_gate"])) * h
    else:
        h = act(h)
    return h


def apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return cm.matmul(pre_out(p, cfg, x), p["w_out"]).to(x.dtype)
