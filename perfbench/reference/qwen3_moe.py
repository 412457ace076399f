"""Plain blocks of a Qwen3-MoE decoder (``Qwen3MoeForCausalLM``), in
PyTorch alone, for judging a quantizer: the input Hessians of a block's
matrices on calibration activations, and the block's forward that carries
the activations on to the next block.

A block (Qwen3's modeling code and the program's, which agree here): x1 =
RMSNorm(x); q, k, v = x1 Wq, x1 Wk, x1 Wv (no bias), a per-head RMSNorm on
q and on k, rotate-half RoPE at ``rope_theta`` from position 0, causal
GQA at 1/sqrt(head_dim), o Wo and the residual; x2 = RMSNorm(x + o Wo);
the router's f32 softmax over x2 R picks ``num_experts_per_tok`` experts,
their probabilities renormalised to sum to one; each expert is
silu(x2 Wg) * (x2 Wi) Wo'. The Hessians route every token; the forward
drops, as the program does (``assumed.moe_capacity_factor``), a (token,
expert) pair past the expert's capacity in its sequence: capacity
int(S K / E * factor) rounded up to 8, pairs taken in (token, k) order.

A Hessian is the mean of x x^T over the tokens a matrix sees (for an
expert: the tokens routed to it). Every product runs in float32 with TF32
off, or with ``Ops("fp8")`` its operands rounded to float8 e4m3, the
control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.ops import Ops, attention, rms, rope


def dims(cfg: dict) -> dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or D // H,
            "F": cfg["moe_intermediate_size"], "E": cfg["num_experts"],
            "K": cfg["num_experts_per_tok"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def capacity(S: int, cfg: dict) -> int:
    n = dims(cfg)
    c = int(S * n["K"] / n["E"] * cfg["assumed"]["moe_capacity_factor"])
    return max(8, -(-c // 8) * 8)


def embed(raw: dict, ids: torch.Tensor) -> torch.Tensor:
    """(N, S) ids -> (N, S, D) float32."""
    return raw["embed"][ids].to(torch.float32)


def _attend(cfg, W: dict, raw: dict, pre: str, x, ops: Ops):
    """(x1, o, x + o Wo) of x (N, S, D), a sequence at a time."""
    n = dims(cfg)
    H, KV, hd = n["H"], n["KV"], n["hd"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    N, S, D = x.shape
    pos = torch.arange(S, device=x.device)
    x1 = rms(x, raw[pre + "norm1"], eps)
    o = torch.empty((N, S, H * hd), dtype=torch.float32, device=x.device)
    for i in range(N):
        h = x1[i]
        q = ops.linear(h, W["attn.wq"]).reshape(S, H, hd)
        k = ops.linear(h, W["attn.wk"]).reshape(S, KV, hd)
        v = ops.linear(h, W["attn.wv"]).reshape(S, KV, hd)
        q = rope(rms(q, raw[pre + "attn.q_norm"], eps), pos, theta)
        k = rope(rms(k, raw[pre + "attn.k_norm"], eps), pos, theta)
        o[i] = attention(q, k, v, ops).reshape(S, H * hd)
    xa = x + ops.linear(o, W["attn.wo"])
    return x1, o, xa


def _route(cfg, raw: dict, pre: str, x2, ops: Ops):
    """(expert ids (T, K), renormalised gates (T, K)) of tokens x2 (T, D)."""
    K = dims(cfg)["K"]
    probs = torch.softmax(ops.linear(x2, raw[pre + "ffn.router"].float().T),
                          dim=-1)
    gate, ids = torch.topk(probs, K, dim=-1)
    return ids, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)


def dense_mats(raw: dict, layer: int) -> dict:
    """A layer's matrices as the checkpoint holds them, float32, each in
    GPTVQ's (out, in) orientation: {"attn.wq": (r, c), ...,
    "ffn.w_in": (E, r, c), ...}."""
    pre = f"layers.{layer}."
    out = {}
    for t in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
        out[t] = raw[pre + t].to(torch.float32).T
    for t in ("ffn.w_in", "ffn.w_gate", "ffn.w_out"):
        out[t] = raw[pre + t].to(torch.float32).transpose(1, 2)
    return out


def _sq(x, ops: Ops):
    xc = ops.cast(x)
    return xc.T @ xc


@torch.no_grad()
def hessians(cfg: dict, raw: dict, layer: int, x: torch.Tensor,
             experts: list, ops: Ops) -> dict:
    """The mean input Hessians of the layer's matrices on x (N, S, D),
    through its dense weights: "attn_in" (q, k, v), "attn_out_in" (o),
    and for each listed expert "experts_in.<e>" (its w_in and w_gate) and
    "experts_out.<e>" (its w_out)."""
    pre = f"layers.{layer}."
    W = dense_mats(raw, layer)
    N, S, D = x.shape
    x1, o, xa = _attend(cfg, W, raw, pre, x, ops)
    out = {"attn_in": _sq(x1.reshape(-1, D), ops) / (N * S),
           "attn_out_in": _sq(o.reshape(N * S, -1), ops) / (N * S)}
    del o
    x2 = rms(xa, raw[pre + "norm2"], cfg["rms_norm_eps"]).reshape(-1, D)
    ids, _ = _route(cfg, raw, pre, x2, ops)
    for e in experts:
        sel = x2[(ids == e).any(-1)]
        h = F.silu(ops.linear(sel, W["ffn.w_gate"][e])) \
            * ops.linear(sel, W["ffn.w_in"][e])
        n = max(sel.shape[0], 1)
        out[f"experts_in.{e}"] = _sq(sel, ops) / n
        out[f"experts_out.{e}"] = _sq(h, ops) / n
    return out


@torch.no_grad()
def advance(cfg: dict, raw: dict, layer: int, x: torch.Tensor, W: dict,
            ops: Ops) -> torch.Tensor:
    """x (N, S, D) through the layer with the matrices ``W`` ((out, in),
    as ``dense_mats`` gives them, or the quantizer's decoded), the
    capacity rule applied a sequence at a time."""
    n = dims(cfg)
    E, K = n["E"], n["K"]
    pre = f"layers.{layer}."
    N, S, D = x.shape
    _, _, xa = _attend(cfg, W, raw, pre, x, ops)
    x2 = rms(xa, raw[pre + "norm2"], cfg["rms_norm_eps"]).reshape(-1, D)
    ids, gate = _route(cfg, raw, pre, x2, ops)              # (T, K)
    C = capacity(S, cfg)
    # a pair's slot: how many earlier pairs of its sequence chose its expert
    slot = torch.empty_like(ids)
    for i in range(N):
        e = ids[i * S:(i + 1) * S].reshape(-1)
        oh = F.one_hot(e, E).to(torch.int32)
        slot[i * S:(i + 1) * S] = ((torch.cumsum(oh, 0) - oh) * oh).sum(
            -1).reshape(S, K)
    w = gate * (slot < C)
    y = torch.zeros_like(x2)
    for e in range(E):
        tok, kk = torch.nonzero((ids == e) & (slot < C), as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x2[tok]
        u = F.silu(ops.linear(h, W["ffn.w_gate"][e])) \
            * ops.linear(h, W["ffn.w_in"][e])
        y.index_add_(0, tok, ops.linear(u, W["ffn.w_out"][e])
                     * w[tok, kk][:, None])
    return xa + y.reshape(N, S, D)
