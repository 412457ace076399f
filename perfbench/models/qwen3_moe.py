"""Qwen3-MoE (``Qwen3MoeForCausalLM``): a pre-norm GQA decoder with a
per-head RMSNorm on q and k, and in every layer a sparse MLP of
``num_experts`` SwiGLU experts, ``num_experts_per_tok`` a token, routed by
an f32 softmax over a linear router.

``weights`` makes every leaf from the seed on the device in the
configuration's ``torch_dtype``, dense as a checkpoint holds it (the
router in float32, as the program keeps it): this configuration is the
input of a quantizer, not a packed model. ``port_config`` and
``port_params`` hand the same tensors to the program;
``perfbench/reference/qwen3_moe.py`` is the plain forward that judges it.
"""
from __future__ import annotations

import math

import torch

from perfbench import inputs
from perfbench.reference.qwen3_moe import dims  # noqa: F401


def target_shapes(cfg: dict) -> dict:
    """{target: (experts, r out, c in)} of one layer's quantized matrices
    (experts 1 for a plain matrix), in GPTVQ's (out, in) orientation."""
    n = dims(cfg)
    D, H, KV, hd, F, E = (n["D"], n["H"], n["KV"], n["hd"], n["F"],
                          n["E"])
    return {"attn.wq": (1, H * hd, D), "attn.wk": (1, KV * hd, D),
            "attn.wv": (1, KV * hd, D), "attn.wo": (1, D, H * hd),
            "ffn.w_in": (E, F, D), "ffn.w_out": (E, D, F),
            "ffn.w_gate": (E, F, D)}


def target_weights(cfg: dict) -> dict:
    """{target: weights} of one layer."""
    return {t: e * r * c for t, (e, r, c) in target_shapes(cfg).items()}


@torch.no_grad()
def weights(cfg: dict, seed: int, device) -> dict:
    """{name: tensor}: ``embed`` (V, D), ``lm_head`` (D, V), ``final_norm``
    and per layer ``layers.<i>.``{``norm1``, ``norm2``, ``attn.wq`` (D,
    H hd), ``attn.wk``, ``attn.wv`` (D, KV hd), ``attn.wo`` (H hd, D),
    ``attn.q_norm``, ``attn.k_norm`` (hd), ``ffn.router`` (D, E) f32,
    ``ffn.w_in``, ``ffn.w_gate`` (E, D, F), ``ffn.w_out`` (E, F, D)}, each
    matrix in the (in, out) orientation the program's kernels take. One
    normal draw for all of them; a weight's std is 1/sqrt(fan-in), norms
    1 +- 0.1, the router's std 0.02."""
    n = dims(cfg)
    D, H, KV, hd, F, E, V, L = (n["D"], n["H"], n["KV"], n["hd"], n["F"],
                                n["E"], n["V"], n["L"])
    leaves = [("embed", (V, D), 0.02, 0.0),
              ("lm_head", (D, V), 1 / math.sqrt(D), 0.0),
              ("final_norm", (D,), 0.1, 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        leaves += [
            (p + "norm1", (D,), 0.1, 1.0), (p + "norm2", (D,), 0.1, 1.0),
            (p + "attn.wq", (D, H * hd), 1 / math.sqrt(D), 0.0),
            (p + "attn.wk", (D, KV * hd), 1 / math.sqrt(D), 0.0),
            (p + "attn.wv", (D, KV * hd), 1 / math.sqrt(D), 0.0),
            (p + "attn.wo", (H * hd, D), 1 / math.sqrt(H * hd), 0.0),
            (p + "attn.q_norm", (hd,), 0.1, 1.0),
            (p + "attn.k_norm", (hd,), 0.1, 1.0),
            (p + "ffn.router", (D, E), 0.02, 0.0),
            (p + "ffn.w_in", (E, D, F), 1 / math.sqrt(D), 0.0),
            (p + "ffn.w_gate", (E, D, F), 1 / math.sqrt(D), 0.0),
            (p + "ffn.w_out", (E, F, D), 1 / math.sqrt(F), 0.0)]
    out = inputs.dense(leaves, inputs.gen(device, seed, 0), device,
                       inputs.DTYPES[cfg["torch_dtype"]])
    for i in range(L):
        k = f"layers.{i}.ffn.router"
        out[k] = out[k].to(torch.float32)
    return out


def port_config(cfg: dict):
    """The program's ``ModelConfig`` for these sizes."""
    from repro_torch.configs.base import ModelConfig

    n = dims(cfg)
    return ModelConfig(
        name=cfg.get("model_type", "model"), family="moe",
        n_layers=n["L"], d_model=n["D"], n_heads=n["H"], n_kv_heads=n["KV"],
        head_dim=n["hd"], d_ff=n["F"], vocab_size=n["V"],
        vocab_pad_multiple=1, n_experts=n["E"], n_experts_active=n["K"],
        moe_capacity_factor=float(cfg["assumed"]["moe_capacity_factor"]),
        activation="swiglu", qk_norm=True, qkv_bias=False,
        tie_embeddings=False, rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        max_seq_len=int(cfg["max_position_embeddings"]),
        dtype=cfg["torch_dtype"])


def port_params(cfg: dict, raw: dict) -> dict:
    """The program's parameter tree over the made tensors."""
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        layers.append({
            "norm1": raw[p + "norm1"], "norm2": raw[p + "norm2"],
            "attn": {w: raw[p + "attn." + w]
                     for w in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")},
            "ffn": {w: raw[p + "ffn." + w]
                    for w in ("router", "w_in", "w_gate", "w_out")}})
    return {"embed": raw["embed"], "final_norm": raw["final_norm"],
            "lm_head": raw["lm_head"], "layers": layers}
