"""Plain decode of a GPTVQ-packed matrix: a frozen copy of the formula,
independent of the program (GPTVQ, Algorithm 1's storage; the port's
``VQLinear`` layout).

A matrix W (r out, c in) is cut into column groups of ``group_cols``
columns and row bands of ``rows_per_band`` rows. Each (group, band) owns a
codebook of k centroids of d values, stored as int8 with one f32 scale.
Each row's c / d codes (log2(k) bits each) are packed row-major into
32-bit words, ``32 // container_bits`` codes a word, the lowest lane in
the lowest bits. Entry (i, g * group_cols + s * d + t) of W is
``codebooks[g, i // rows_per_band, code[i, g * group_cols / d + s], t] *
cb_scale[g, i // rows_per_band]``. Blockwise normalization is off at the
settings this benchmark runs.
"""
from __future__ import annotations

import torch


def container_bits(code_bits: int) -> int:
    for b in (1, 2, 4, 8, 16, 32):
        if b >= code_bits:
            return b
    raise ValueError(code_bits)


def plan_groups(r: int, c: int, d: int, group_size: int,
                group_cols: int) -> tuple[int, int]:
    """(columns a group, rows a band): the largest multiple of d dividing c
    up to min(group_cols, group_size), then the largest divisor of r up to
    group_size / columns."""
    def largest_divisor(n, target, step):
        best = step
        for cand in range(step, min(n, target) + 1, step):
            if n % cand == 0:
                best = cand
        return best

    cg = largest_divisor(c, min(group_cols, group_size), d)
    if c % cg or cg % d:
        raise ValueError(f"no group plan for c={c}, d={d}")
    return cg, largest_divisor(r, max(1, group_size // cg), 1)


def unpack_codes(words: torch.Tensor, code_bits: int, n: int) -> torch.Tensor:
    """The first ``n`` codes of the words (int32 holding uint32 patterns)."""
    bits = container_bits(code_bits)
    lanes = 32 // bits
    w = words.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(lanes, device=words.device, dtype=torch.int64) * bits
    return ((w[:, None] >> shifts) & ((1 << bits) - 1)).reshape(-1)[:n]


def dequantize(words, codebooks_i8, cb_scale, *, r: int, c: int, d: int,
               k: int, group_cols: int, rows_per_band: int,
               dtype=torch.float32) -> torch.Tensor:
    """W (r, c) in ``dtype`` (f32 exactly: an int8 value times an f32
    scale)."""
    code_bits = max(1, (k - 1).bit_length())
    n_cg, n_bands = c // group_cols, r // rows_per_band
    codes = unpack_codes(words, code_bits, r * (c // d)).reshape(
        n_bands, rows_per_band, n_cg, group_cols // d)
    cb = codebooks_i8.to(torch.float32) * cb_scale.to(torch.float32)[
        :, :, None, None]                              # (n_cg, n_bands, k, d)
    g = torch.arange(n_cg, device=cb.device)[None, None, :, None]
    b = torch.arange(n_bands, device=cb.device)[:, None, None, None]
    W = cb[g, b, codes]                  # (n_bands, rpb, n_cg, spans, d)
    return W.reshape(r, c).to(dtype)
