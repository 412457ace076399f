"""Qwen2 (``Qwen2ForCausalLM``): a dense pre-norm GQA decoder with a bias on
q, k and v, SwiGLU MLPs and an untied head, served GPTVQ-packed.

``weights`` makes every leaf from the seed on the device: the dense ones
(embedding, head, norms, biases) in the configuration's ``torch_dtype``,
each of the seven matrices of a layer packed at the configuration's
``quantization`` settings (random codes, int8 codebooks and scales).
``port_config`` and ``port_params`` hand the same tensors to the program;
``perfbench/reference/qwen2.py`` is the plain forward that judges it.
"""
from __future__ import annotations

import math

import torch

from perfbench import inputs
from perfbench.reference.qwen2 import dims  # noqa: F401 (the metrics' sizes)

TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_in",
           "ffn.w_gate", "ffn.w_out")


def matrix_shapes(cfg: dict) -> dict:
    """{target: (r out, c in)} of one layer's packed matrices."""
    n = dims(cfg)
    D, H, KV, hd, F = n["D"], n["H"], n["KV"], n["hd"], n["F"]
    return {"attn.wq": (H * hd, D), "attn.wk": (KV * hd, D),
            "attn.wv": (KV * hd, D), "attn.wo": (D, H * hd),
            "ffn.w_in": (F, D), "ffn.w_gate": (F, D), "ffn.w_out": (D, F)}


def matmul_params(cfg: dict) -> int:
    """Weights of every matrix a token meets in the layers."""
    return cfg["num_hidden_layers"] * sum(
        r * c for r, c in matrix_shapes(cfg).values())


@torch.no_grad()
def weights(cfg: dict, seed: int, device) -> dict:
    """{name: tensor} for the dense leaves and {name: packed matrix} for
    each ``layers.<i>.<target>`` (``inputs.packed``). Weight values have
    the scale of a trained model's (about 1/sqrt(fan-in)), so activations
    neither vanish nor grow through the layers."""
    n = dims(cfg)
    D, H, KV, hd, V, L = n["D"], n["H"], n["KV"], n["hd"], n["V"], n["L"]
    g = inputs.gen(device, seed, 0)
    leaves = [("embed", (V, D), 0.02, 0.0),
              ("lm_head", (D, V), 1 / math.sqrt(D), 0.0),
              ("final_norm", (D,), 0.1, 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        leaves += [(p + "norm1", (D,), 0.1, 1.0), (p + "norm2", (D,), 0.1, 1.0),
                   (p + "attn.bq", (H * hd,), 0.1, 0.0),
                   (p + "attn.bk", (KV * hd,), 0.1, 0.0),
                   (p + "attn.bv", (KV * hd,), 0.1, 0.0)]
    out = inputs.dense(leaves, g, device, inputs.DTYPES[cfg["torch_dtype"]])
    shapes = matrix_shapes(cfg)
    out.update(inputs.packed(
        [(f"layers.{i}.{t}", inputs.packed_layout(cfg["quantization"], r, c))
         for i in range(L) for t, (r, c) in shapes.items()], g, device))
    return out


def port_config(cfg: dict):
    """The program's ``ModelConfig`` for these sizes."""
    from repro_torch.configs.base import ModelConfig

    n = dims(cfg)
    return ModelConfig(
        name=cfg.get("model_type", "model"), family="dense",
        n_layers=n["L"], d_model=n["D"], n_heads=n["H"], n_kv_heads=n["KV"],
        head_dim=n["hd"], d_ff=n["F"], vocab_size=n["V"],
        vocab_pad_multiple=1, activation="swiglu", qkv_bias=True,
        tie_embeddings=False, rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        max_seq_len=int(cfg["max_position_embeddings"]),
        dtype=cfg["torch_dtype"])


def port_params(cfg: dict, raw: dict) -> dict:
    """The program's parameter tree over the made tensors: each packed
    matrix a ``VQLinear`` (blockwise normalization off), the rest as made."""
    from repro_torch.core.vq_linear import VQLinear

    def packed(m):
        n_cg = m["c"] // m["group_cols"]
        dev = m["words"].device
        return VQLinear(
            words=m["words"], codebooks=m["codebooks"],
            cb_scale=m["cb_scale"],
            scale_sint=torch.zeros((n_cg, m["r"], 1), dtype=torch.int8,
                                   device=dev),
            scale_a=torch.zeros((n_cg,), device=dev),
            scale_z=torch.zeros((n_cg,), device=dev),
            r=m["r"], c=m["c"], d=m["d"], k=m["k"],
            group_cols=m["group_cols"], rows_per_band=m["rows_per_band"],
            scale_block=0, rule=cfg["quantization"]["setting"])

    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        layers.append({
            "norm1": raw[p + "norm1"], "norm2": raw[p + "norm2"],
            "attn": {**{w: packed(raw[p + "attn." + w])
                        for w in ("wq", "wk", "wv", "wo")},
                     **{b: raw[p + "attn." + b] for b in ("bq", "bk", "bv")}},
            "ffn": {w: packed(raw[p + "ffn." + w])
                    for w in ("w_in", "w_gate", "w_out")}})
    return {"embed": raw["embed"], "final_norm": raw["final_norm"],
            "lm_head": raw["lm_head"], "layers": layers}
