"""Uniform scalar quantization primitives (RTN baseline + GPTQ); port of
``repro/core/quant.py``.

Conventions (GPTQ-style):
  * A weight matrix ``W`` has shape ``(r, c)`` = (out_features, in_features).
  * The layer computes ``y = x @ W.T`` for ``x`` of shape ``(..., c)``.
  * The layer Hessian is ``H = X X^T`` over inputs, shape ``(c, c)``.
  * Quantization groups run along the *input* (column) dimension.

All math is float32. ``gptq_quantize`` is a jitted XLA loop in the reference,
not a Pallas kernel; here it is a plain PyTorch column loop on W's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class UniformQParams(NamedTuple):
    """Per-group affine quantization parameters.

    ``scale``/``zero`` have shape (r, n_groups); group g covers columns
    [g*group_size, (g+1)*group_size).
    """

    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    symmetric: bool


def _minmax_scale_zero(w: torch.Tensor, bits: int, symmetric: bool):
    """Min/max affine params for the last axis of ``w``."""
    qmax = 2**bits - 1
    if symmetric:
        absmax = torch.amax(torch.abs(w), dim=-1)
        # symmetric signed grid: [-2^{b-1}, 2^{b-1}-1]
        scale = absmax / (2 ** (bits - 1) - 1 + 1e-12)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        return scale, torch.zeros_like(scale)
    lo = torch.clamp(torch.amin(w, dim=-1), max=0.0)
    hi = torch.clamp(torch.amax(w, dim=-1), min=0.0)
    scale = (hi - lo) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = torch.round(-lo / scale)
    return scale, zero


def _group_size(c: int, group_size) -> int:
    """The requested group size, else the largest divisor of c below it."""
    gs = c if group_size in (-1, None) else min(group_size, c)
    while c % gs != 0:
        gs -= 1
    return gs


def compute_qparams(W: torch.Tensor, bits: int, group_size: int = -1,
                    symmetric: bool = False) -> UniformQParams:
    """Compute per-(row, column-group) affine quantization parameters."""
    r, c = W.shape
    gs = _group_size(c, group_size)
    scale, zero = _minmax_scale_zero(W.reshape(r, c // gs, gs), bits,
                                     symmetric)
    return UniformQParams(scale, zero, bits, gs, symmetric)


def _int_codes(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               bits: int, symmetric: bool) -> torch.Tensor:
    if symmetric:
        return torch.clamp(torch.round(w / scale), -(2 ** (bits - 1)),
                           2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(w / scale) + zero, 0, 2**bits - 1)


def quantize_column(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    bits: int, symmetric: bool) -> torch.Tensor:
    """Fake-quantize a column (or any array broadcastable with scale/zero)."""
    q = _int_codes(w, scale, zero, bits, symmetric)
    return q * scale if symmetric else (q - zero) * scale


def rtn_quantize(W: torch.Tensor, bits: int, group_size: int = -1,
                 symmetric: bool = False) -> torch.Tensor:
    """Round-to-nearest baseline: fake-quantized copy of ``W``."""
    r, c = W.shape
    p = compute_qparams(W, bits, group_size, symmetric)
    wg = W.reshape(r, c // p.group_size, p.group_size)
    qg = quantize_column(wg, p.scale[..., None], p.zero[..., None], bits,
                         symmetric)
    return qg.reshape(r, c)


def rtn_int_weights(W: torch.Tensor, bits: int, group_size: int = -1,
                    symmetric: bool = False):
    """RTN returning integer codes + params (for packing / serving)."""
    r, c = W.shape
    p = compute_qparams(W, bits, group_size, symmetric)
    wg = W.reshape(r, c // p.group_size, p.group_size)
    q = _int_codes(wg, p.scale[..., None], p.zero[..., None], bits, symmetric)
    return q.reshape(r, c).to(torch.int32), p


def dequantize_int(q: torch.Tensor, p: UniformQParams) -> torch.Tensor:
    r, c = q.shape
    qg = q.reshape(r, c // p.group_size, p.group_size).to(torch.float32)
    if p.symmetric:
        return (qg * p.scale[..., None]).reshape(r, c)
    return ((qg - p.zero[..., None]) * p.scale[..., None]).reshape(r, c)


# ---------------------------------------------------------------------------
# GPTQ: column-sequential uniform quantization with Hessian error feedback.
# ---------------------------------------------------------------------------


def gptq_quantize(W: torch.Tensor, U: torch.Tensor, *, bits: int,
                  group_size: int = 128, block_size: int = 128,
                  symmetric: bool = False) -> torch.Tensor:
    """GPTQ (Frantar et al. 2022) with the Cholesky formulation.

    Args:
      W: (r, c) weights.
      U: upper-triangular Cholesky factor of ``H^{-1}`` (``H^{-1} = U^T U``),
         from :func:`repro_torch.core.hessian.inv_hessian_cholesky`.
      bits/group_size: quantization grid (group along columns).
      block_size: lazy-update block B; errors inside a block are propagated
        eagerly, the tail update is applied once per block.

    Group params are recomputed at every column from the current
    (error-compensated) weights of the column's group, as the reference
    does: from the block's working copy when a group fits in a block, else
    from W as it stood when the block began. Returns the fake-quantized
    weight matrix (float32).
    """
    r, c = W.shape
    gs = _group_size(c, group_size)
    B = min(block_size, c, gs if gs >= 16 else c)
    while c % B != 0 or not (gs % B == 0 or B % gs == 0):
        B -= 1
    W = W.to(torch.float32).clone()
    U = U.to(torch.float32)
    Q = torch.zeros_like(W)

    for start in range(0, c, B):
        Wb = W[:, start:start + B].clone()
        Ub = U[start:start + B, start:start + B]
        E = torch.zeros((r, B), dtype=W.dtype, device=W.device)
        for j in range(B):
            col = start + j
            w = Wb[:, j].clone()
            if gs <= B:
                g0 = (j // gs) * gs
                wgrp = Wb[:, g0:g0 + gs]
            else:
                gcol = (col // gs) * gs
                wgrp = W[:, gcol:gcol + gs]
            scale, zero = _minmax_scale_zero(wgrp, bits, symmetric)
            q = quantize_column(w, scale, zero, bits, symmetric)
            err = (w - q) / Ub[j, j]
            # propagate into the remaining columns of the block
            Wb[:, j + 1:] -= err[:, None] * Ub[j, j + 1:][None, :]
            Q[:, col] = q
            E[:, j] = err
        # lazy tail update: W[:, start+B:] -= E @ U[start:start+B, start+B:]
        if start + B < c:
            W[:, start + B:] -= E @ U[start:start + B, start + B:]
        # write back the processed block so group slices that span blocks
        # see compensated values
        W[:, start:start + B] = Wb
    return Q
