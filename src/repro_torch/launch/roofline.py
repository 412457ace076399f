"""Roofline terms of a dry-run cell on H100 terms (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh) cell, in seconds, per card:

  compute    = FLOPs / peak bf16 FLOP/s
  memory     = HBM bytes / HBM B/s
  collective = max(model-axis bytes / NVLink B/s,
                   data-axis bytes / network B/s)

with ``launch/mesh.HARDWARE``'s data-sheet figures (989 TFLOP/s bf16, 3.35
TB/s HBM, 450 GB/s NVLink and 50 GB/s network a direction a card). The
model axis is one node's 8 NVLink cards and data (and pod) run between
nodes, so the two links carry their collectives side by side and the
bound is the slower of the two; the reference has one v5e ICI figure,
``coll / (3 * ici_bw)``.

``analytic_cell`` is the reference's cost model formula for formula: the
same FLOPs, HBM bytes and collective bytes at the same ``(chips, dp,
tp)``; it also returns the collective bytes split by axis (the model
axis's TP all-reduces and logits reduce, the data axis's f32 gradient
all-reduce), which sum to the reference's ``coll_bytes``. It drives the
report's tables, as in the reference. ``analyze`` puts the dry run's
traced counts on the same terms as a cross-check (the reference's
``roofline_hlo_raw``). The reference's HLO-text parsers
(``collective_bytes``, ``while_trip_counts``) have no counterpart: the
port counts collectives where it issues them (``obs/work``), by the
reference's convention (a collective's output bytes).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import HARDWARE


def collective_seconds(model_bytes: float, data_bytes: float) -> float:
    """The model axis's bytes over NVLink and the data axis's over the
    network, the two links side by side."""
    return max(model_bytes / HARDWARE["nvlink_bw"],
               data_bytes / HARDWARE["net_bw"])


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    dominant: str
    useful_flops_ratio: float

    def as_dict(self):
        return self.__dict__.copy()


def analyze(cost: dict, coll: dict, *, chips: int, model_flops: float,
            loop_scale: float = 1.0) -> Roofline:
    """cost: {"flops", "bytes accessed"} of one card's step; coll: its
    collective bytes by axis ({"model", "data"}, and "total")."""
    flops = float(cost.get("flops", 0.0)) * loop_scale
    raw_bytes = float(cost.get("bytes accessed", 0.0)) * loop_scale
    cbytes = float(coll.get("total", 0)) * loop_scale
    compute_s = flops / HARDWARE["peak_flops_bf16"]
    memory_s = raw_bytes / HARDWARE["hbm_bw"]
    collective_s = collective_seconds(
        float(coll.get("model", 0)) * loop_scale,
        float(coll.get("data", 0)) * loop_scale)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    per_chip_model_flops = model_flops / chips
    ratio = per_chip_model_flops / flops if flops else 0.0
    return Roofline(compute_s, memory_s, collective_s, flops, raw_bytes,
                    cbytes, per_chip_model_flops, dominant, ratio)


def model_flops_train(n_params_active: float, tokens: float) -> float:
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, batch: float) -> float:
    return 2.0 * n_params_active * batch


# ---------------------------------------------------------------------------
# Analytic cost model — exact from config shapes; drives the report's tables
# ---------------------------------------------------------------------------

def analytic_cell(cfg, shape, *, chips: int, dp: int, tp: int,
                  n_total: int, n_active: int, microbatches: int = 1,
                  vq_bytes_per_param: float | None = None,
                  weight_payload_bytes: float | None = None,
                  kv_bytes: float = 2.0) -> dict:
    """Per-card per-step FLOPs / HBM bytes / collective bytes (the
    reference's terms; derivation notes inline). ``vq_bytes_per_param``
    replaces the dense bf16 weight payload for VQ serving cells."""
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    L = cfg.n_layers + cfg.n_encoder_layers
    D = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Bdp = max(1, B // dp)  # rows per data shard
    w_bytes = (vq_bytes_per_param if vq_bytes_per_param is not None else 2.0)
    P_bytes = (weight_payload_bytes if weight_payload_bytes is not None
               else n_total * w_bytes)
    attn_free = cfg.attention_free

    if kind == "train":
        T = B * S
        flops = 6.0 * n_active * T * 1.33 / chips           # +remat refwd
        if not attn_free:
            # fwd 4*B*S^2*H*hd per layer (QK^T + PV), causal /2; bwd 2x; +remat
            flops += 16.0 * B * S * S * H * hd * L / 2 / chips
        # params: streamed per microbatch (FSDP all-gather) + grad/opt traffic
        bytes_ = (microbatches * n_total * 2 + 36.0 * n_total) / chips
        # activations: ~12 R/W of (B,S,D) bf16 per layer incl. recompute
        bytes_ += 12.0 * Bdp * S * D * L * 2 / tp  # act work split over TP
        # collectives: the data axis's grad ring all-reduce (f32); the
        # model axis's 2 TP all-reduces a layer (the MoE's expert combine
        # is one sum of the (Bdp, S, D) output a layer, the same cost)
        coll_data = 8.0 * n_total * 4 / chips
        coll_model = 4.0 * L * Bdp * S * D * 2 * microbatches / microbatches
    elif kind == "prefill":
        T = B * S
        flops = 2.0 * n_active * T / chips
        if not attn_free:
            flops += 4.0 * B * S * S * H * hd * L / 2 / chips
        bytes_ = P_bytes / chips
        bytes_ += 10.0 * Bdp * S * D * L * 2 / tp
        bytes_ += 2.0 * Bdp * S * KV * hd * 2 * L / tp  # KV cache write
        coll_data = 0.0
        coll_model = 4.0 * L * Bdp * S * D * 2  # MoE combine folded in
    else:  # decode: one token for every sequence in the batch
        flops = 2.0 * n_active * B / chips
        if not attn_free:
            flops += 4.0 * B * H * hd * S * L / chips       # attend to cache
        bytes_ = P_bytes / chips                            # weights, once
        if not attn_free:
            bytes_ += 2.0 * B * S * KV * hd * kv_bytes * L / chips  # KV read
        if cfg.family in ("ssm", "hybrid"):
            d_inner = cfg.ssm_expand * D
            bytes_ += 2.0 * B * d_inner * cfg.ssm_state * 4 * L / chips
        coll_data = 0.0
        coll_model = 4.0 * L * Bdp * 1 * D * 2              # TP all-reduces
        coll_model += 2.0 * Bdp * cfg.padded_vocab * 4 / tp  # logits reduce
    coll = coll_data + coll_model

    compute_s = flops / HARDWARE["peak_flops_bf16"]
    memory_s = bytes_ / HARDWARE["hbm_bw"]
    collective_s = collective_seconds(coll_model, coll_data)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful_s = (model_flops_train(n_active, B * S) / chips
                if kind == "train" else
                (2.0 * n_active * (B * S if kind == "prefill" else B) / chips)
                ) / HARDWARE["peak_flops_bf16"]
    bound = max(terms.values())
    return {
        "flops": flops, "hbm_bytes": bytes_, "coll_bytes": coll,
        "coll_model_bytes": coll_model, "coll_data_bytes": coll_data,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "step_lower_bound_s": bound,
        "useful_compute_s": useful_s,
        "roofline_fraction": useful_s / bound if bound > 0 else 0.0,
    }
