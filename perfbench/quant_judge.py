"""How ``correct`` is decided for a quantizer: the plain reference
(``perfbench/reference/<arch>.py``) recomputes, from the seed's weights
and calibration ids, the input Hessians of every block the program
finished, carrying the activations from block to block through the
program's own packed matrices (decoded by ``reference/vq.py``), as the
program's pipeline does. It reads three numbers:

* ``hessian_gap_max``: over the sampled taps, the program's Hessian's
  distance from the reference's, ||Hp - Hr||_F / ||Hr||_F (the capture,
  and through later blocks' inputs the advance);
* ``leaf_error_max``: over the sampled matrices, the Hessian-weighted
  error of the program's packed matrix under the reference's Hessian,
  tr(dW Hr dW^T) / tr(W Hr W^T) (the codes, codebooks and scales);
* ``layout_mismatches``: packed matrices whose layout is not the
  setting's (code and codebook bits, groups, bands): the bits a weight.

A block's taps: "attn_in", "attn_out_in" and, for experts drawn from the
seed, "experts_in.<e>", "experts_out.<e>". Nothing here imports the
program: its packed matrices arrive as plain tensors.
"""
from __future__ import annotations

import random

import torch

from perfbench import inputs, reference
from perfbench.reference import vq
from perfbench.reference.ops import Ops, full_f32

ATTN_TAP = {"attn.wq": "attn_in", "attn.wk": "attn_in",
            "attn.wv": "attn_in", "attn.wo": "attn_out_in"}
EXPERT_TAP = {"ffn.w_in": "experts_in", "ffn.w_gate": "experts_in",
              "ffn.w_out": "experts_out"}


def sample_experts(n_experts: int, n: int, seed: int, block: int) -> list:
    """The experts whose Hessians and matrices are checked in a block."""
    return sorted(random.Random(seed * 1009 + block).sample(
        range(n_experts), n))


def decode(leaf: dict, e: int | None = None) -> torch.Tensor:
    """A packed matrix (expert ``e`` of a stack) as f32 (r, c)."""
    pick = (lambda t: t) if e is None else (lambda t: t[e])
    return vq.dequantize(pick(leaf["words"]), pick(leaf["codebooks"]),
                         pick(leaf["cb_scale"]), r=leaf["r"], c=leaf["c"],
                         d=leaf["d"], k=leaf["k"],
                         group_cols=leaf["group_cols"],
                         rows_per_band=leaf["rows_per_band"])


def layout_ok(quant: dict, leaf: dict, experts: int) -> bool:
    lo = inputs.packed_layout(quant, leaf["r"], leaf["c"])
    lead = (experts,) if experts > 1 else ()
    return (leaf["scale_block"] == 0
            and leaf["codebooks"].dtype == torch.int8
            and leaf["words"].dtype == torch.int32
            and all(leaf[k] == lo[k] for k in ("d", "k", "group_cols",
                                               "rows_per_band"))
            and leaf["words"].numel() == lo["n_words"] * experts
            and tuple(leaf["codebooks"].shape)
            == (*lead, *lo["cb_shape"], lo["k"], lo["d"]))


def _gap(Hp, Hr) -> float:
    return float((Hp.to(Hr.device) - Hr).norm() / Hr.norm().clamp(min=1e-30))


def _leaf_error(W, Wq, H) -> float:
    dW = W - Wq
    return float((dW * (dW @ H)).sum() / (W * (W @ H)).sum())


def _block_mats(arch_ref, raw, layer, leaves: dict) -> dict:
    """The layer's matrices as the program packed them, decoded (out, in)."""
    W = arch_ref.dense_mats(raw, layer)
    for t, leaf in leaves.items():
        if W[t].dim() == 3:
            W[t] = torch.stack([decode(leaf, e) for e in range(W[t].shape[0])])
        else:
            W[t] = decode(leaf)
    return W


@torch.no_grad()
def judge(cfg: dict, raw: dict, ids: torch.Tensor, blocks: list,
          experts: int, seed: int) -> dict:
    """``blocks``: per finished block in order, {"leaves": {target: packed
    matrix as plain tensors and sizes}, "hessians": {tap: the program's
    mean Hessian}}. Returns the three numbers and the worst tap and
    matrix."""
    ref = reference.get(cfg)
    ops = Ops("f32")
    gaps, errs, bad = {}, {}, 0
    with full_f32():
        x = ref.embed(raw, ids)
        for b, blk in enumerate(blocks):
            n_exp = ref.dims(cfg)["E"]
            picked = sample_experts(n_exp, experts, seed, b)
            Hr = ref.hessians(cfg, raw, b, x, picked, ops)
            for tap, Hp in blk["hessians"].items():
                gaps[f"{b}.{tap}"] = _gap(Hp, Hr[tap])
            dense = ref.dense_mats(raw, b)
            for t, leaf in blk["leaves"].items():
                stack = dense[t].dim() == 3
                bad += not layout_ok(cfg["quantization"], leaf,
                                     dense[t].shape[0] if stack else 1)
                if not stack:
                    errs[f"{b}.{t}"] = _leaf_error(dense[t], decode(leaf),
                                                   Hr[ATTN_TAP[t]])
                    continue
                for e in picked:
                    errs[f"{b}.{t}.{e}"] = _leaf_error(
                        dense[t][e], decode(leaf, e),
                        Hr[f"{EXPERT_TAP[t]}.{e}"])
            del dense, Hr
            if b + 1 < len(blocks):
                x = ref.advance(cfg, raw, b, x,
                                _block_mats(ref, raw, b, blk["leaves"]), ops)
    worst_gap = max(gaps, key=gaps.get) if gaps else None
    worst_err = max(errs, key=errs.get) if errs else None
    return {"hessian_gap_max": gaps[worst_gap] if gaps else None,
            "leaf_error_max": errs[worst_err] if errs else None,
            "layout_mismatches": bad, "worst_tap": worst_gap,
            "worst_matrix": worst_err, "taps": len(gaps),
            "matrices": len(errs)}


@torch.no_grad()
def control_gaps(cfg: dict, raw: dict, ids: torch.Tensor, blocks: list,
                 experts: int, seed: int) -> list:
    """The control: the reference computed with float8 e4m3 operands put
    in the program's place. Each sampled tap's Hessian gap of the control
    against the float32 reference, the activations of each carried
    through the program's packed matrices by its own precision."""
    ref = reference.get(cfg)
    f32, low = Ops("f32"), Ops("fp8")
    out = []
    with full_f32():
        x = ref.embed(raw, ids)
        xl = x.clone()
        for b, blk in enumerate(blocks):
            picked = sample_experts(ref.dims(cfg)["E"], experts, seed, b)
            Hr = ref.hessians(cfg, raw, b, x, picked, f32)
            Hl = ref.hessians(cfg, raw, b, xl, picked, low)
            out += [_gap(Hl[t], Hr[t]) for t in blk["hessians"]]
            del Hr, Hl
            if b + 1 < len(blocks):
                W = _block_mats(ref, raw, b, blk["leaves"])
                x = ref.advance(cfg, raw, b, x, W, f32)
                xl = ref.advance(cfg, raw, b, xl, W, low)
    return out
