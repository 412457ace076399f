"""Bits-per-value accounting (GPTVQ §3.2 'Total bits per value'); port of
``repro/core/bpv.py``, pure Python.

bpv = index_bits/weight + codebook_bits/weight + scale_bits/weight
    = log2(k)/d        + k*d*b_c/l             + b_s/N_s

with k = 2^(d*b) centroids, group size l weights per codebook, codebook
entries stored at b_c bits, and blockwise normalization scales at b_s bits
per N_s weights (0 if normalization is off).

The paper picks l to hit the uniform-baseline overheads (0.125/0.25 bpv).
Those nominal figures assume the tensor is large enough to amortize its
codebooks; ``effective_bpv`` accounts for the group plan a concrete
(r, c) matrix actually gets, which is what the recipe layer
(core/recipe.py — PAPER_SETTINGS are also exposed there as single-rule
recipe presets) and the budget allocator reason about.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# accounting rate for weights a recipe leaves (or stores) dense: the
# serving reference dtype is bf16 regardless of the fp32 smoke configs
DENSE_BITS = 16.0


@dataclass(frozen=True)
class VQConfig:
    """Static hyper-parameters of one GPTVQ run (per weight tensor)."""

    d: int = 2                      # VQ dimensionality
    bits_per_dim: float = 2.0       # b: index bits per weight dimension
    group_size: int = 2048          # l: weights per codebook
    group_cols: int = 256           # max columns a group spans (paper: 256)
    codebook_bits: int = 8          # b_c (8 = int8 codebooks; 16 = fp16)
    scale_block: int = 0            # N_s (0 = blockwise normalization off)
    scale_bits: int = 4             # b_s
    em_iters: int = 50              # EM iterations for codebook init
    em_seed: str = "mahalanobis"    # or "kmeans++"
    block_size: int = 128           # GPTQ lazy-update block B
    codebook_update_iters: int = 25 # GD steps on ||WX - QX||^2 (0 = off)
    codebook_update_lr: float = 1e-3
    svd_rank_frac: float = 0.0      # >0: SVD codebook compression (1D only)
    percdamp: float = 0.01
    exact_span_solve: bool = True   # exact joint d-column compensation
    cd_passes: int = 2              # coordinate-descent passes (solver="cd")

    @property
    def k(self) -> int:
        k = 2 ** (self.d * self.bits_per_dim)
        assert abs(k - round(k)) < 1e-9, "log2(k) must be integer"
        return int(round(k))

    @property
    def index_bits_per_value(self) -> float:
        return math.log2(self.k) / self.d

    @property
    def codebook_bits_per_value(self) -> float:
        eff_k = self.k if self.svd_rank_frac <= 0 else self.k * self.svd_rank_frac
        return eff_k * self.d * self.codebook_bits / self.group_size

    @property
    def scale_bits_per_value(self) -> float:
        if self.scale_block <= 0:
            return 0.0
        return self.scale_bits / self.scale_block

    @property
    def bits_per_value(self) -> float:
        return (
            self.index_bits_per_value
            + self.codebook_bits_per_value
            + self.scale_bits_per_value
        )


def group_size_for_overhead(
    d: int, bits_per_dim: float, target_overhead: float, codebook_bits: int = 8,
    scale_block: int = 0, scale_bits: int = 4,
) -> int:
    """Smallest power-of-two group size whose codebook+scale overhead is
    <= target (paper §4.1: e.g. 2D/2b/int8 @ 0.125 bpv -> l = 2048)."""
    k = int(round(2 ** (d * bits_per_dim)))
    scale_oh = scale_bits / scale_block if scale_block > 0 else 0.0
    budget = target_overhead - scale_oh
    assert budget > 0, "scale overhead alone exceeds the target"
    l = k * d * codebook_bits / budget
    return 2 ** math.ceil(math.log2(l))


def effective_bpv(cfg: VQConfig, r: int, c: int) -> float:
    """Achieved bits-per-value of ``cfg`` on a concrete (r, c) matrix.

    Small tensors cannot amortize a codebook over the full nominal group
    size: the group plan caps a group at the matrix extent, so the
    codebook overhead term uses the group actually used (cols * band
    rows) rather than ``cfg.group_size``. Equals ``cfg.bits_per_value``
    whenever the matrix is large enough for the nominal plan.
    """
    from repro_torch.core.gptvq import plan_groups  # deferred: gptvq imports us

    cg, rg = plan_groups(r, c, cfg)
    # same per-codebook storage as the nominal figure, amortized over the
    # group actually planned instead of cfg.group_size
    codebook = cfg.codebook_bits_per_value * cfg.group_size / (cg * rg)
    return cfg.index_bits_per_value + codebook + cfg.scale_bits_per_value


def int_quant_bpv(bits: int, group_size: int, c: int) -> float:
    """Achieved bpv of uniform integer quantization on ``c`` input columns:
    index bits + one fp16 scale per (row, group). Groups fall back to the
    largest divisor of c, mirroring quant.compute_qparams."""
    gs = c if group_size in (-1, None) else min(group_size, c)
    while c % gs != 0:
        gs -= 1
    return bits + DENSE_BITS / gs


def weighted_bpv(items) -> float:
    """Model-wide bits-per-value: ``items`` is an iterable of
    (numel, bpv) pairs; returns the numel-weighted mean."""
    total_bits = total_w = 0.0
    for numel, bpv in items:
        total_bits += numel * bpv
        total_w += numel
    return total_bits / max(total_w, 1.0)


# Paper's main configurations, matched to uniform W2@g128 / W2@g64 / W3@g128
# overheads (Table 2).  Keys: (d, bits_per_dim, total bpv).
PAPER_SETTINGS = {
    "2.125bpv_1d": VQConfig(d=1, bits_per_dim=2, group_size=256, codebook_bits=8),
    "2.125bpv_2d": VQConfig(d=2, bits_per_dim=2, group_size=2048, codebook_bits=8),
    "2.25bpv_1d": VQConfig(d=1, bits_per_dim=2, group_size=128, codebook_bits=8),
    "2.25bpv_2d": VQConfig(d=2, bits_per_dim=2, group_size=1024, codebook_bits=8),
    "2.25bpv_4d": VQConfig(d=4, bits_per_dim=2, group_size=32768, codebook_bits=8),
    "3.125bpv_1d": VQConfig(d=1, bits_per_dim=3, group_size=512, codebook_bits=8),
    "3.125bpv_2d": VQConfig(d=2, bits_per_dim=3, group_size=8192, codebook_bits=8),
    "4.125bpv_1d": VQConfig(d=1, bits_per_dim=4, group_size=1024, codebook_bits=8),
    "4.125bpv_2d": VQConfig(d=2, bits_per_dim=4, group_size=32768, codebook_bits=8),
}
