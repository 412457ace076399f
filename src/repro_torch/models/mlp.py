"""Dense MLP blocks (gated SwiGLU/GeGLU, relu^2, gelu); port of
``repro/models/mlp.py``. Under a model axis that splits d_ff
(``models/parallel``) a rank runs its hidden units and the output is
summed over the axis."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import parallel as par


def init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D, F = cfg.d_model, cfg.d_ff
    p = {
        "w_in": cm.dense_init(gen, D, F, dtype=dtype, device=device),
        "w_out": cm.dense_init(gen, F, D, dtype=dtype, device=device),
    }
    if cm.is_gated(cfg.activation):
        p["w_gate"] = cm.dense_init(gen, D, F, dtype=dtype, device=device)
    return p


def specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs: hidden units over the model axis."""
    s = {"w_in": cm.P("data", "model"), "w_out": cm.P("model", "data")}
    if cm.is_gated(cfg.activation):
        s["w_gate"] = cm.P("data", "model")
    return s


def split_modes(cfg: ModelConfig, axis) -> dict:
    """How a step on ``axis`` (``parallel.ModelAxis``) reads each leaf of
    ``specs``: the rank's hidden units (SPLIT) when ``apply`` splits d_ff,
    else whole (FULL)."""
    mode = par.SPLIT if axis.ffn(cfg) else par.FULL
    return {k: mode for k in specs(cfg)}


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
    group = par.ffn_group(cfg)
    if group is None:
        return cm.matmul(pre_out(p, cfg, x), p["w_out"]).to(x.dtype)
    y = cm.matmul(pre_out(p, cfg, par.enter(x, group)), p["w_out"])
    return par.reduce(y, group).to(x.dtype)
