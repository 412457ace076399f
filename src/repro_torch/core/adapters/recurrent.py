"""Adapter for the "ssm" family: the xLSTM stack of mLSTM and sLSTM blocks
(port of ``repro/core/adapters/recurrent.py``).

Quantizable anatomy (models/xlstm.py):

  mLSTM block: up / up_gate read the normed block input ("in" tap); the
  q/k/v/o head projections read the up-projected stream u ("u" tap); down
  reads the gated core output ("down_in" tap). The tiny f32 gate
  projections w_i/w_f ((d_inner, n_heads)) stay dense: they are
  numerically sensitive exponential-gate inputs and a negligible fraction
  of the payload.

  sLSTM block: the four input projections w_z/w_i/w_f/w_o read the normed
  block input; the block-diagonal per-head recurrent matrices r_* are
  declared ``keep_dense`` targets (their inputs are the lagged hidden
  states inside the recurrence, so no static tap exists without unrolling
  it), so the recipe layer reports the exclusion in
  ``QuantizeReport.per_target`` instead of skipping it silently. The
  post-core gated FFN quantizes like any dense MLP.

All mixer projections carry group "attn" (they are the sequence-mixing
path); the sLSTM FFN carries group "mlp". ``advance`` runs the block on
f32-dequantized weights, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.adapters import base
from repro_torch.core.adapters.base import WeightSpec
from repro_torch.models import common as cm, transformer, xlstm

_GATE_DENSE_REASON = (
    "fp32 exponential-gate inputs: numerically sensitive and a "
    "negligible fraction of the payload")
_R_DENSE_REASON = (
    "recurrent r_* inputs are lagged hidden states inside the scan — "
    "no static Hessian tap exists without unrolling the recurrence")


class _XLSTMBlock(base.BlockAdapter):
    kind = ""

    def __init__(self, adapter: "XLSTMAdapter", index: int):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.index = index
        self.name = f"layer{index}[{self.kind}]"
        self.prefix = f"layers.{index}"
        self._p = adapter.layer(index)
        self._new = None

    def params(self):
        return self._p

    def install(self, new_params):
        self._new = new_params
        self.adapter.installed[self.index] = new_params

    def advance(self, x):
        dense_lp = vql_mod.dequant_tree(self._new, torch.float32)
        return transformer._block_apply(dense_lp, self.cfg, self.kind, x,
                                        pos=0)[0]


class _MLSTMBlock(_XLSTMBlock):
    kind = "mlstm"
    TARGETS = tuple(
        [WeightSpec(f"core.{w}", ("core", w), "in", "attn")
         for w in ("up", "up_gate")]
        + [WeightSpec(f"core.{w}", ("core", w), "u", "attn")
           for w in ("wq", "wk", "wv", "w_o")]
        + [WeightSpec("core.down", ("core", "down"), "down_in", "attn")]
        + [WeightSpec(f"core.{w}", ("core", w), None, "attn",
                      keep_dense=_GATE_DENSE_REASON)
           for w in ("w_i", "w_f")]
    )

    def targets(self):
        return self.TARGETS

    def capture(self, x, taps, groups):
        if "attn" not in groups:
            return taps
        cfg, lp = self.cfg, self._p
        x1 = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        taps = base.acc_tap(taps, "in", x1)
        u, h, _ = xlstm.mlstm_pre_down(lp["core"], cfg, x1)
        taps = base.acc_tap(taps, "u", u)
        return base.acc_tap(taps, "down_in", h)


class _SLSTMBlock(_XLSTMBlock):
    kind = "slstm"
    TARGETS = tuple(
        [WeightSpec(f"core.{w}", ("core", w), "in", "attn")
         for w in ("w_z", "w_i", "w_f", "w_o")]
        # block-diagonal per-head recurrent matrices: declared (not
        # silently skipped) so the recipe layer reports them dense
        + [WeightSpec(f"core.{w}", ("core", w), None, "attn",
                      keep_dense=_R_DENSE_REASON)
           for w in ("r_z", "r_i", "r_f", "r_o")]
        + [WeightSpec(f"core.ffn.{w}", ("core", "ffn", w), "ffn_in", "mlp")
           for w in ("w_in", "w_gate")]
        + [WeightSpec("core.ffn.w_out", ("core", "ffn", "w_out"),
                      "ffn_out_in", "mlp")]
    )

    def targets(self):
        return self.TARGETS

    def capture(self, x, taps, groups):
        cfg, lp = self.cfg, self._p
        x1 = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if "attn" in groups:
            taps = base.acc_tap(taps, "in", x1)
        if "mlp" in groups:
            h, _ = xlstm.slstm_apply(lp["core"], cfg, x1, None)
            x2 = cm.rmsnorm(x + h, lp["core"]["ffn_norm"], cfg.norm_eps)
            taps = base.acc_tap(taps, "ffn_in", x2)
            taps = base.acc_tap(taps, "ffn_out_in",
                                xlstm.slstm_ffn_pre_out(lp["core"], cfg, x2))
        return taps


class XLSTMAdapter(base.ModelAdapter):
    """Family "ssm": the heterogeneous mLSTM/sLSTM list under
    params["layers"], with transformer.embed_tokens in front."""

    def __init__(self, model, params):
        super().__init__(model, params)
        self._layers = params["layers"]
        self.installed: dict[int, dict] = {}

    def layer(self, i: int):
        return dict(self._layers[i])

    def calib_state(self, tokens, chunk_index: int = 0):
        return transformer.embed_tokens(self.params, self.cfg, tokens)

    def blocks(self):
        return [(_SLSTMBlock if transformer.block_kind(self.cfg, i) == "slstm"
                 else _MLSTMBlock)(self, i) for i in range(self.cfg.n_layers)]

    def finalize(self):
        return dict(self.params, layers=[self.installed[i]
                                         for i in range(self.cfg.n_layers)])
