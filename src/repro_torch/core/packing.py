"""Bit-packing of VQ index tensors (port of ``repro/core/packing.py``).

Codes of ``log2(k)`` bits are packed into 32-bit words, ``32 // bits`` codes
per word, lowest lane in the lowest bits. The reference stores the words as
uint32; torch supports few ops on uint32, so the port holds the same bit
patterns in int32 tensors. Unpacking widens to int64 and masks to the low
32 bits first, so the shift-then-mask is exact whatever the sign bit. The
CUDA kernels read the words as ``uint32_t``.
"""
from __future__ import annotations

import torch

_WORD_MASK = 0xFFFFFFFF


def container_bits(code_bits: int) -> int:
    """Smallest b in {1,2,4,8,16,32} with b >= code_bits."""
    for b in (1, 2, 4, 8, 16, 32):
        if b >= code_bits:
            return b
    raise ValueError(code_bits)


def pack(idx: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Pack integer codes (flat, multiple of per-word lanes) into int32 words
    holding the reference's uint32 bit patterns."""
    bits = container_bits(code_bits)
    lanes = 32 // bits
    flat = idx.reshape(-1)
    if flat.numel() % lanes != 0:
        raise ValueError(f"{flat.numel()} codes do not fill {lanes}-lane words")
    w = flat.reshape(-1, lanes).to(torch.int64)
    shifts = torch.arange(lanes, dtype=torch.int64, device=idx.device) * bits
    words = (w << shifts[None, :]).sum(dim=1)  # disjoint bit fields: sum == or
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(words: torch.Tensor, code_bits: int, n: int) -> torch.Tensor:
    """Unpack 32-bit words (any shape, read flat) back into ``n`` int32
    codes."""
    bits = container_bits(code_bits)
    lanes = 32 // bits
    w = words.reshape(-1).to(torch.int64) & _WORD_MASK
    shifts = torch.arange(lanes, dtype=torch.int64, device=words.device) * bits
    codes = (w[:, None] >> shifts) & (2**bits - 1)
    return codes.reshape(-1)[:n].to(torch.int32)
