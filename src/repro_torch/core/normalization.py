"""Blockwise data normalization (GPTVQ §3.2); port of
``repro/core/normalization.py``.

Before codebook initialization, each sub-row block of ``Ns`` weights is
divided by its absmax scale. Scales are quantized to ``scale_bits`` (default
4) integers *in log2 domain*, with a per-column-group floating point offset
``z``:

    s_int = round((log2(s) - z) / a) ,  clipped to the integer grid
    s_hat = 2^(a * s_int + z)

The quantized-scale grid step ``a`` is shared over the weight group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BlockScales(NamedTuple):
    s_int: torch.Tensor  # (r, n_blocks) int32 codes
    a: torch.Tensor      # scalar grid step (per group)
    z: torch.Tensor      # scalar log2 offset (per group)
    block: int
    bits: int

    def dequant(self) -> torch.Tensor:
        """Per-block scales, shape (r, n_blocks)."""
        return torch.exp2(self.a * self.s_int.to(torch.float32) + self.z)

    def expand(self, c: int) -> torch.Tensor:
        """Per-element scales, shape (r, c)."""
        return torch.repeat_interleave(self.dequant(), self.block, dim=1)[:, :c]


def compute_block_scales(W: torch.Tensor, block: int = 32,
                         bits: int = 4) -> BlockScales:
    """Compute quantized log-domain absmax scales for sub-row blocks of W."""
    r, c = W.shape
    if c % block != 0:
        raise ValueError(f"{c} % {block} != 0")
    s = W.reshape(r, c // block, block).abs().amax(dim=-1)
    s = torch.where(s == 0, torch.ones_like(s), s)
    logs = torch.log2(s)
    lo, hi = logs.min(), logs.max()
    z = lo
    nlevels = 2**bits - 1
    a = torch.clamp((hi - lo) / max(nlevels, 1), min=1e-8)
    s_int = torch.clamp(torch.round((logs - z) / a), 0, nlevels).to(torch.int32)
    return BlockScales(s_int, a, z, block, bits)


def normalize(W: torch.Tensor, scales: BlockScales) -> torch.Tensor:
    """W ./ expanded scales (applied before codebook init / assignment)."""
    return W / scales.expand(W.shape[1])


def denormalize(Wn: torch.Tensor, scales: BlockScales) -> torch.Tensor:
    return Wn * scales.expand(Wn.shape[1])


def identity_scales(W: torch.Tensor, block: int = 32) -> BlockScales:
    """Unit scales (normalization disabled) with the same static structure."""
    r, c = W.shape
    zero = torch.zeros((), dtype=torch.float32, device=W.device)
    return BlockScales(
        torch.zeros((r, c // block), dtype=torch.int32, device=W.device),
        zero, zero.clone(), block, 4)
