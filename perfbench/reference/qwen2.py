"""Plain forward of a dense pre-norm decoder LM (Qwen2's architecture), in
PyTorch alone: no kernel, no cache, no batching policy of the program.

It follows Qwen2's published description (arXiv:2407.10671 and the
``Qwen2ForCausalLM`` modeling code): token embedding; per layer an RMSNorm,
grouped-query attention with a bias on q, k and v, rotary embeddings of
the half-split ("rotate half") form at ``rope_theta``, a causal softmax at
1/sqrt(head_dim), the output projection and the residual; then an RMSNorm,
the SwiGLU MLP (down(silu(gate(x)) * up(x))) and the residual; a final
RMSNorm and the untied output head. Query head h reads key/value head
h // (heads / kv_heads).

Weights come as the benchmark made them (``perfbench/models/qwen2.py``): the
dense leaves as bf16 tensors, each packed matrix as its words, int8
codebooks and scales, decoded here by ``reference/vq.py``. Everything is
computed in float32 with TF32 off, unless ``precision="fp8"``: then every
product's operands (the projections', q.k's, p.v's and the head's) are
rounded to float8 e4m3 with one scale a tensor, the control that a
program computing below its stated precision would look like.
"""
from __future__ import annotations

import torch

from perfbench.reference import vq
from perfbench.reference.ops import Ops, attention, full_f32, rms, rope


def dims(cfg: dict) -> dict:
    """The sizes the forward reads: head_dim as the file states it, else
    as ``assumed``, else hidden_size / num_attention_heads."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = (cfg.get("head_dim") or cfg.get("assumed", {}).get("head_dim")
          or D // H)
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"], "hd": hd,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def _matrix(raw: dict, name: str, device) -> torch.Tensor:
    m = raw[name]
    return vq.dequantize(m["words"].to(device), m["codebooks"].to(device),
                         m["cb_scale"].to(device), r=m["r"], c=m["c"],
                         d=m["d"], k=m["k"], group_cols=m["group_cols"],
                         rows_per_band=m["rows_per_band"])


@torch.no_grad()
def logits_at(cfg: dict, raw: dict, sequences: list, positions: list, *,
              precision: str = "f32") -> list:
    """For each token sequence (1-D int64 tensor) the float32 logits (n, V)
    at its ``positions`` (1-D int64 tensor of n indices): the next-token
    distribution after sequence[: p + 1]. Runs layer by layer (one layer's
    decoded weights in memory at a time), sequence by sequence."""
    dev = raw["embed"].device
    with full_f32():
        ops = Ops(precision)
        n = dims(cfg)
        H, KV, hd = n["H"], n["KV"], n["hd"]
        eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
        xs = [raw["embed"][s.to(dev)].to(torch.float32) for s in sequences]
        for layer in range(cfg["num_hidden_layers"]):
            pre = f"layers.{layer}."
            W = {n: _matrix(raw, pre + n, dev)
                 for n in ("attn.wq", "attn.wk", "attn.wv", "attn.wo")}
            for i, x in enumerate(xs):
                S = x.shape[0]
                pos = torch.arange(S, device=dev)
                h = rms(x, raw[pre + "norm1"], eps)
                q = ops.linear(h, W["attn.wq"]) + raw[pre + "attn.bq"].float()
                k = ops.linear(h, W["attn.wk"]) + raw[pre + "attn.bk"].float()
                v = ops.linear(h, W["attn.wv"]) + raw[pre + "attn.bv"].float()
                q = rope(q.reshape(S, H, hd), pos, theta)
                k = rope(k.reshape(S, KV, hd), pos, theta)
                o = attention(q, k, v.reshape(S, KV, hd), ops)
                xs[i] = x + ops.linear(o.reshape(S, H * hd), W["attn.wo"])
            del W
            W = {n: _matrix(raw, pre + n, dev)
                 for n in ("ffn.w_in", "ffn.w_gate", "ffn.w_out")}
            for i, x in enumerate(xs):
                h = rms(x, raw[pre + "norm2"], eps)
                u = torch.nn.functional.silu(ops.linear(h, W["ffn.w_gate"])) \
                    * ops.linear(h, W["ffn.w_in"])
                xs[i] = x + ops.linear(u, W["ffn.w_out"])
            del W
        head = raw["lm_head"].to(torch.float32)             # (D, V)
        out = []
        for x, p in zip(xs, positions):
            h = rms(x[p.to(dev)], raw["final_norm"], eps)
            out.append(ops.linear(h, head.T))
        return out
