"""Adapter for the "hybrid" family: a Zamba2-style Mamba2 trunk with one
*shared* attention block invoked every ``shared_attn_every`` layers, plus
per-invocation LoRA deltas on q/k/v (port of
``repro/core/adapters/hybrid.py``).

Block sequence: the shared attention block first (one set of weights used
at every group boundary), then the Mamba layers in trunk order. The shared
block's Hessians accumulate over *all* of its invocations by replaying the
unquantized trunk: its q/k/v/o statistics come from every group's
concat(hidden, initial embedding) stream, not just the first. Because it is
quantized before any Mamba layer, every later capture and advance sees the
quantized shared weights at group entries (downstream sees upstream error).

Mamba mixers quantize ``in_proj`` (tap: the normed block input) and
``out_proj`` (tap: the gated scan output, ``models/ssm.pre_out``). The conv
and scan parameters (conv_w, A_log, dt_bias, D_skip, norm_scale) and the
LoRA A/B factors stay dense. The calibration state is a dict {"x": hidden,
"emb0": embedding}: every shared invocation re-reads the initial embedding.
"""
from __future__ import annotations

import torch

from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.adapters import base
from repro_torch.core.adapters.base import WeightSpec
from repro_torch.models import attention, common as cm, hybrid, ssm


def _shared_pre_out(shared_p, lora_g, cfg, h, emb0):
    """One shared-block invocation up to wo; returns (xin, o, y)."""
    xin = hybrid.shared_attn_input(shared_p, cfg, h, emb0)
    attn_p = hybrid.lora_attn_params(shared_p, lora_g, cfg)
    o = attention.pre_out(attn_p, cfg, xin, pos=0)
    return xin, o, cm.matmul(o, attn_p["wo"]).to(h.dtype)


class _SharedAttnBlock(base.BlockAdapter):
    TARGETS = tuple(
        [WeightSpec(f"attn.{w}", ("attn", w), "xin", "attn")
         for w in ("wq", "wk", "wv")]
        + [WeightSpec("attn.wo", ("attn", "wo"), "attn_out_in", "attn")])

    def __init__(self, adapter: "HybridAdapter"):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.name = "shared_attn"
        self.prefix = "shared"

    def params(self):
        return dict(self.adapter.params["shared"])

    def targets(self):
        return self.TARGETS

    def capture(self, state, taps, groups):
        """Replay the unquantized trunk, accumulating the shared block's
        input and pre-out Hessians at every invocation."""
        if "attn" not in groups:
            return taps
        cfg, ad = self.cfg, self.adapter
        h, emb0 = state["x"], state["emb0"]
        for g in range(ad.n_groups):
            xin, o, y = _shared_pre_out(ad.params["shared"],
                                        hybrid.lora_group(ad.params["lora"],
                                                          g), cfg, h, emb0)
            taps = base.acc_tap(taps, "xin", xin)
            taps = base.acc_tap(taps, "attn_out_in", o)
            h = h + y
            for j in range(ad.per):
                lp = ad.mamba_layer(g, j)
                y_m, _ = ssm.apply(lp["mixer"], cfg,
                                   cm.rmsnorm(h, lp["norm"], cfg.norm_eps))
                h = h + y_m
        return taps

    def install(self, new_params):
        self.adapter.new_shared = new_params
        self.adapter._shared_dense = None  # invalidate the dequant cache

    def advance(self, state):
        return state  # the stream is still at the embedding


class _MambaBlock(base.BlockAdapter):
    TARGETS = (
        WeightSpec("mixer.in_proj", ("mixer", "in_proj"), "in", "attn"),
        WeightSpec("mixer.out_proj", ("mixer", "out_proj"), "out_in",
                   "attn"),
    )

    def __init__(self, adapter: "HybridAdapter", g: int, j: int):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.g, self.j = g, j
        self.name = f"mamba{g}.{j}" + (" (+shared entry)" if j == 0 else "")
        self.prefix = f"mamba.{g}.{j}"
        self._p = adapter.mamba_layer(g, j)
        self._new = None
        # group-entry hidden streams computed in capture(), reused by
        # advance() on the same state objects (quantize_model holds the state
        # list across both loops): half the shared-block forwards
        self._entered: dict[int, torch.Tensor] = {}

    def params(self):
        return self._p

    def targets(self):
        return self.TARGETS

    def _enter(self, state):
        """The hidden stream at this layer's input (the already quantized
        shared block applied at a group entry)."""
        h, emb0 = state["x"], state["emb0"]
        if self.j == 0:
            _, _, y = _shared_pre_out(
                self.adapter.shared_dense(),
                hybrid.lora_group(self.adapter.params["lora"], self.g),
                self.cfg, h, emb0)
            h = h + y
        return h

    def capture(self, state, taps, groups):
        if "attn" not in groups:
            return taps
        cfg = self.cfg
        h = self._enter(state)
        self._entered[id(state)] = h
        x1 = cm.rmsnorm(h, self._p["norm"], cfg.norm_eps)
        taps = base.acc_tap(taps, "in", x1)
        y_pre, _ = ssm.pre_out(self._p["mixer"], cfg, x1)
        return base.acc_tap(taps, "out_in", y_pre)

    def install(self, new_params):
        self._new = new_params
        self.adapter.new_mamba[(self.g, self.j)] = new_params

    def advance(self, state):
        cfg = self.cfg
        h = self._entered.pop(id(state), None)
        if h is None:  # capture skipped (group disabled)
            h = self._enter(state)
        lp = vql_mod.dequant_tree(self._new, torch.float32)
        y, _ = ssm.apply(lp["mixer"], cfg,
                         cm.rmsnorm(h, lp["norm"], cfg.norm_eps))
        return {"x": h + y, "emb0": state["emb0"]}


class HybridAdapter(base.ModelAdapter):
    """Family "hybrid": the shared attention block and the (n_groups, per)
    Mamba trunk. The shared block quantizes first (Hessians over all
    invocations), then the trunk in order."""

    def __init__(self, model, params):
        super().__init__(model, params)
        self.n_groups, self.per = hybrid._groups(self.cfg)
        self.new_shared = None
        self.new_mamba: dict[tuple, dict] = {}
        self._shared_dense = None

    def mamba_layer(self, g: int, j: int):
        return dict(self.params["mamba"][g][j])

    def current_shared(self):
        return (self.new_shared if self.new_shared is not None
                else self.params["shared"])

    def shared_dense(self):
        """The dequantized shared block in f32, cached: it is immutable once
        the shared block has installed its quantized params, and every
        group-entry capture and advance reuses it."""
        if self._shared_dense is None:
            self._shared_dense = vql_mod.dequant_tree(self.current_shared(),
                                                      torch.float32)
        return self._shared_dense

    def calib_state(self, tokens, chunk_index: int = 0):
        x = self.params["embed"][tokens]
        return {"x": x, "emb0": x}

    def blocks(self):
        return [_SharedAttnBlock(self)] + [
            _MambaBlock(self, g, j)
            for g in range(self.n_groups) for j in range(self.per)]

    def finalize(self):
        """The quantized tree, its trunk a list of groups of layer dicts as
        the port's forward takes it. A trunk whose layers differ only in
        their leaves' rule provenance gets the reference's unified "mixed"
        rule, so it stays stackable (checkpoint/checkpointer writes it
        stacked, as the reference); a heterogeneous one (a mixed recipe)
        keeps each leaf's own rule."""
        flat = [self.new_mamba[(g, j)] for g in range(self.n_groups)
                for j in range(self.per)]
        if not base.blocks_stackable(flat):
            flat = base.unify_rules(flat)
        mamba = [flat[g * self.per:(g + 1) * self.per]
                 for g in range(self.n_groups)]
        return dict(self.params, shared=self.current_shared(), mamba=mamba)
