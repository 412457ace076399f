"""Adapter for the transformer family: dense GQA stacks, MoE stacks and the
VLM text backbone (port of ``repro/core/adapters/transformer.py``). The
vision tower is a stub: GPTVQ quantizes the text stack, calibrated on text
tokens; patches enter only through the forward.

Block anatomy (pre-norm residual):

  x ─ norm1 ─ attn(wq wk wv │ wo) ─+─ norm2 ─ ffn(w_in w_gate │ w_out) ─+

Taps: "attn_in" feeds the q/k/v projections, "attn_out_in" (the pre-``wo``
attention output) feeds the output projection, "ffn_in" feeds the up/gate
projections and "ffn_out_in" (the activated hidden state) the down
projection. MoE blocks replace the dense FFN taps with per-expert Hessian
stacks accumulated from each expert's *routed* tokens ("experts_in",
"experts_out"; models/moe.expert_hessians).
"""
from __future__ import annotations

import torch

from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.adapters import base
from repro_torch.core.adapters.base import WeightSpec
from repro_torch.models import attention, common as cm, mlp, moe, transformer


class _DenseBlock(base.BlockAdapter):
    def __init__(self, adapter: "TransformerAdapter", index: int):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.index = index
        self.name = f"layer{index}"
        self.prefix = f"layers.{index}"
        self.kind = transformer.block_kind(self.cfg, index)
        self._p = adapter.layer(index)
        self._new = None

    def params(self):
        return self._p

    def targets(self):
        specs = [WeightSpec(f"attn.{w}", ("attn", w), "attn_in", "attn")
                 for w in ("wq", "wk", "wv")]
        specs.append(WeightSpec("attn.wo", ("attn", "wo"), "attn_out_in",
                                "attn"))
        names = ["w_in", "w_out"] + (["w_gate"] if cm.is_gated(
            self.cfg.activation) else [])
        if self.kind == "dense":
            tap = {"w_in": "ffn_in", "w_gate": "ffn_in",
                   "w_out": "ffn_out_in"}
            specs += [WeightSpec(f"ffn.{w}", ("ffn", w), tap[w], "mlp")
                      for w in names]
        else:  # moe: expert stacks with routed-token Hessians
            tap = {"w_in": "experts_in", "w_gate": "experts_in",
                   "w_out": "experts_out"}
            specs += [WeightSpec(f"ffn.{w}", ("ffn", w), tap[w], "mlp",
                                 per_expert=True) for w in names]
        return tuple(specs)

    def capture(self, x, taps, groups):
        cfg, lp = self.cfg, self.params()
        x1 = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if "attn" in groups:
            taps = base.acc_tap(taps, "attn_in", x1)
            o = attention.pre_out(lp["attn"], cfg, x1, pos=0)
            taps = base.acc_tap(taps, "attn_out_in", o)
            a = cm.matmul(o, lp["attn"]["wo"]).to(x.dtype)
        else:
            a = attention.apply(lp["attn"], cfg, x1, pos=0)[0]
        xa = x + a
        x2 = cm.rmsnorm(xa, lp["norm2"], cfg.norm_eps)
        if "mlp" in groups:
            if self.kind == "dense":
                taps = base.acc_tap(taps, "ffn_in", x2)
                taps = base.acc_tap(taps, "ffn_out_in",
                                    mlp.pre_out(lp["ffn"], cfg, x2))
            else:
                eh_in, eh_out = moe.expert_hessians(
                    lp["ffn"], cfg, x2,
                    diag_only=base.diag_capture_active())
                taps = base.acc_expert_tap(taps, "experts_in", eh_in)
                taps = base.acc_expert_tap(taps, "experts_out", eh_out)
        return taps

    def install(self, new_params):
        self._new = new_params
        self.adapter.installed[self.index] = new_params

    def advance(self, x):
        dense_lp = vql_mod.dequant_tree(self._new, torch.float32)
        return transformer._block_apply(dense_lp, self.cfg, self.kind, x,
                                        pos=0)[0]


class TransformerAdapter(base.ModelAdapter):
    """Families "dense", "moe" and "vlm": a list of block dicts under
    params["layers"] with transformer.embed_tokens in front."""

    def __init__(self, model, params):
        super().__init__(model, params)
        self._layers = params["layers"]
        self.installed: dict[int, dict] = {}

    def layer(self, i: int):
        return dict(self._layers[i])

    def calib_state(self, tokens, chunk_index: int = 0):
        return transformer.embed_tokens(self.params, self.cfg, tokens)

    def blocks(self):
        return [_DenseBlock(self, i) for i in range(self.cfg.n_layers)]

    def finalize(self):
        return dict(self.params, layers=[self.installed[i]
                                         for i in range(self.cfg.n_layers)])
