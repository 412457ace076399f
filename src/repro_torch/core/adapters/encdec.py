"""Adapter for the "audio" family: a Whisper-style encoder-decoder (port of
``repro/core/adapters/encdec.py``).

Block sequence: the encoder blocks in order (calibrated on the
frame-embedding stream), one transition pseudo-block (the final encoder
norm forms the cross-attention memory, and the decoder tokens are
embedded), then the decoder blocks. A decoder block adds the
cross-attention's Hessians: its query projection reads the normed decoder
stream ("cross_q_in"), its wk/wv read the *encoder memory* ("memory"),
quantized-encoder error included. Biases and positional embeddings stay
dense.

The conv/mel frontend is a stub upstream (models/encdec.py): calibration
frames are synthesized per chunk from a seeded ``torch.Generator`` (its
stream is not ``jax.random``'s, as the synthetic corpora's is not). The
calibration state is {"enc": x, "tokens": t} on the encoder side and
{"dec": x, "memory": m} after the transition.
"""
from __future__ import annotations

import torch

from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.adapters import base
from repro_torch.core.adapters.base import WeightSpec
from repro_torch.models import attention, common as cm, encdec, mlp

_FRAMES_SEED = 20  # deterministic stub-frontend calibration frames


def synth_frames(cfg, batch: int, chunk_index: int = 0, device=None):
    """Deterministic placeholder frame embeddings (conv frontend stub),
    (batch, encoder_seq, d_model) f32 at std 0.1, one stream a chunk."""
    gen = torch.Generator(device=device).manual_seed(
        _FRAMES_SEED * 1_000_003 + chunk_index)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=device) * 0.1


def _ffn_specs(cfg):
    names = ["w_in", "w_out"] + (
        ["w_gate"] if cm.is_gated(cfg.activation) else [])
    tap = {"w_in": "ffn_in", "w_gate": "ffn_in", "w_out": "ffn_out_in"}
    return [WeightSpec(f"ffn.{w}", ("ffn", w), tap[w], "mlp") for w in names]


def _acc_ffn(taps, lp, cfg, x2):
    taps = base.acc_tap(taps, "ffn_in", x2)
    return base.acc_tap(taps, "ffn_out_in", mlp.pre_out(lp["ffn"], cfg, x2))


class _EncBlock(base.BlockAdapter):
    def __init__(self, adapter: "EncDecAdapter", index: int):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.index = index
        self.name = f"enc{index}"
        self.prefix = f"enc.{index}"
        self._p = dict(adapter.params["enc_layers"][index])
        self._new = None

    def params(self):
        return self._p

    def targets(self):
        return tuple(
            [WeightSpec(f"attn.{w}", ("attn", w), "attn_in", "attn")
             for w in ("wq", "wk", "wv")]
            + [WeightSpec("attn.wo", ("attn", "wo"), "attn_out_in", "attn")]
            + _ffn_specs(self.cfg))

    def capture(self, state, taps, groups):
        cfg, lp = self.cfg, self._p
        x = state["enc"]
        x1 = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if "attn" in groups:
            taps = base.acc_tap(taps, "attn_in", x1)
            o = attention.pre_out(lp["attn"], cfg, x1, causal=False,
                                  use_rope=False)
            taps = base.acc_tap(taps, "attn_out_in", o)
            a = cm.matmul(o, lp["attn"]["wo"]).to(x.dtype)
        else:
            a, _ = attention.apply(lp["attn"], cfg, x1, causal=False,
                                   use_rope=False)
        if "mlp" in groups:
            taps = _acc_ffn(taps, lp, cfg,
                            cm.rmsnorm(x + a, lp["norm2"], cfg.norm_eps))
        return taps

    def install(self, new_params):
        self._new = new_params
        self.adapter.new_enc[self.index] = new_params

    def advance(self, state):
        lp = vql_mod.dequant_tree(self._new, torch.float32)
        return dict(state, enc=encdec.enc_block_apply(lp, self.cfg,
                                                      state["enc"]))


class _Transition(base.BlockAdapter):
    """Encoder -> decoder hand-off: the final encoder norm forms the
    memory, the decoder token stream is embedded. No quantizable
    weights."""

    def __init__(self, adapter: "EncDecAdapter"):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.name = "enc→dec"
        self.prefix = "enc_dec"

    def params(self):
        return {}

    def targets(self):
        return ()

    def capture(self, state, taps, groups):
        return taps

    def install(self, new_params):
        pass

    def advance(self, state):
        cfg, params = self.cfg, self.adapter.params
        memory = cm.rmsnorm(state["enc"], params["enc_norm"], cfg.norm_eps)
        tokens = state["tokens"]
        x = params["embed"][tokens]
        pos_ids = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + params["pos_dec"][pos_ids][None].to(x.dtype)
        return {"dec": x, "memory": memory}


class _DecBlock(base.BlockAdapter):
    def __init__(self, adapter: "EncDecAdapter", index: int):
        self.adapter = adapter
        self.cfg = adapter.cfg
        self.index = index
        self.name = f"dec{index}"
        self.prefix = f"dec.{index}"
        self._p = dict(adapter.params["dec_layers"][index])
        self._new = None

    def params(self):
        return self._p

    def targets(self):
        return tuple(
            [WeightSpec(f"self_attn.{w}", ("self_attn", w), "self_in",
                        "attn") for w in ("wq", "wk", "wv")]
            + [WeightSpec("self_attn.wo", ("self_attn", "wo"),
                          "self_out_in", "attn")]
            + [WeightSpec("cross_attn.wq", ("cross_attn", "wq"),
                          "cross_q_in", "attn")]
            + [WeightSpec(f"cross_attn.{w}", ("cross_attn", w), "memory",
                          "attn") for w in ("wk", "wv")]
            + [WeightSpec("cross_attn.wo", ("cross_attn", "wo"),
                          "cross_out_in", "attn")]
            + _ffn_specs(self.cfg))

    def capture(self, state, taps, groups):
        cfg, lp = self.cfg, self._p
        h, memory = state["dec"], state["memory"]
        x1 = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
        if "attn" in groups:
            taps = base.acc_tap(taps, "self_in", x1)
            o = attention.pre_out(lp["self_attn"], cfg, x1, use_rope=False)
            taps = base.acc_tap(taps, "self_out_in", o)
            a = cm.matmul(o, lp["self_attn"]["wo"]).to(h.dtype)
        else:
            a, _ = attention.apply(lp["self_attn"], cfg, x1, use_rope=False)
        h = h + a
        xq = cm.rmsnorm(h, lp["norm_x"], cfg.norm_eps)
        if "attn" in groups:
            taps = base.acc_tap(taps, "cross_q_in", xq)
            taps = base.acc_tap(taps, "memory", memory)
            oc = attention.cross_pre_out(lp["cross_attn"], cfg, xq, memory)
            taps = base.acc_tap(taps, "cross_out_in", oc)
            c = cm.matmul(oc, lp["cross_attn"]["wo"]).to(h.dtype)
        else:
            c = attention.cross_apply(lp["cross_attn"], cfg, xq, memory)
        if "mlp" in groups:
            taps = _acc_ffn(taps, lp, cfg,
                            cm.rmsnorm(h + c, lp["norm2"], cfg.norm_eps))
        return taps

    def install(self, new_params):
        self._new = new_params
        self.adapter.new_dec[self.index] = new_params

    def advance(self, state):
        lp = vql_mod.dequant_tree(self._new, torch.float32)
        return dict(state, dec=encdec.dec_block_apply(
            lp, self.cfg, state["dec"], state["memory"]))


class EncDecAdapter(base.ModelAdapter):
    """Family "audio": params["enc_layers"] + params["dec_layers"], lists of
    layer dicts; the cross K/V read the encoder memory."""

    def __init__(self, model, params):
        super().__init__(model, params)
        self.new_enc: dict[int, dict] = {}
        self.new_dec: dict[int, dict] = {}

    def calib_state(self, tokens, chunk_index: int = 0):
        frames = synth_frames(self.cfg, tokens.shape[0], chunk_index,
                              device=tokens.device)
        return {"enc": encdec.embed_frames(self.params, self.cfg, frames),
                "tokens": tokens}

    def blocks(self):
        cfg = self.cfg
        out: list[base.BlockAdapter] = [
            _EncBlock(self, i) for i in range(cfg.n_encoder_layers)]
        out.append(_Transition(self))
        out += [_DecBlock(self, i) for i in range(cfg.n_layers)]
        return out

    def finalize(self):
        """The quantized tree, both stacks lists of layer dicts. A stack
        whose layers differ only in their leaves' rule provenance gets the
        reference's unified "mixed" rule, so it stays stackable
        (checkpoint/checkpointer writes it stacked, as the reference); a
        heterogeneous one (a mixed recipe) keeps each leaf's own rule."""
        def stack(new, n):
            layers = [new[i] for i in range(n)]
            if not base.blocks_stackable(layers):
                layers = base.unify_rules(layers)
            return layers

        cfg = self.cfg
        return dict(self.params,
                    enc_layers=stack(self.new_enc, cfg.n_encoder_layers),
                    dec_layers=stack(self.new_dec, cfg.n_layers))
