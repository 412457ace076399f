"""Codebook post-processing (GPTVQ §3.3); port of
``repro/core/codebook_compress.py``.

1. ``codebook_update``    — gradient descent on the convex layer objective
                            ||W X - Q(C) X||_F^2 = tr(E H E^T) w.r.t. the
                            codebook entries (assignments fixed).
2. ``quantize_codebooks`` — symmetric int8 min-max quantization, one scale
                            per codebook.

SVD codebook compression (1D VQ) is not ported yet (ROADMAP.md queue 1,
"Budgets and solvers").
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gptvq import VQResult, gather_codebooks
from repro_torch.pending import not_ported


def _adam_run(loss_fn, params: torch.Tensor, iters: int, lr) -> torch.Tensor:
    """The reference's hand-rolled Adam (bias-corrected moments, ``eps``
    added to sqrt(v_hat)) on torch autograd; not ``torch.optim.Adam``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = params.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for t in range(iters):
        with torch.enable_grad():  # callers may run under no_grad
            p.requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(p), p)
        p = p.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        tf = float(t + 1)
        mhat = m / (1 - b1**tf)
        vhat = v / (1 - b2**tf)
        p = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return p


def codebook_update(res: VQResult, W: torch.Tensor,
                    H: torch.Tensor) -> VQResult:
    """GD on ||WX - QX||^2 w.r.t. codebooks; assignments and scales fixed."""
    iters = res.cfg.codebook_update_iters
    if iters <= 0:
        return res
    Wf = W.to(torch.float32)
    Hf = H.to(torch.float32)
    # normalize the objective so a single lr works across layers
    denom = torch.clamp(torch.sum(Wf * (Wf @ Hf)), min=1e-12)
    # lr is relative to typical centroid magnitude (population std, as jnp)
    scale = torch.clamp(torch.std(res.arrays.codebooks, correction=0), min=1e-8)
    S = res.expanded_scales()

    def loss(C):
        Q = gather_codebooks(C, res.arrays.indices, res.group_cols,
                             res.rows_per_band, res.cfg.d) * S
        E = Wf - Q
        return torch.sum(E * (E @ Hf)) / denom

    C = _adam_run(loss, res.arrays.codebooks, iters,
                  res.cfg.codebook_update_lr * scale)
    arrays = res.arrays._replace(codebooks=C, Q=res.reconstruct(C))
    return dataclasses.replace(res, arrays=arrays)


def quantize_codebooks(res: VQResult) -> VQResult:
    """Symmetric min-max int8 (or cfg.codebook_bits) codebook quantization."""
    bits = res.cfg.codebook_bits
    if bits >= 16:
        return res
    C = res.arrays.codebooks  # (n_cg, n_bands, k, d)
    qmax = 2 ** (bits - 1) - 1
    absmax = C.abs().amax(dim=(2, 3), keepdim=True)
    s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax)
    Cq = torch.clamp(torch.round(C / s), -qmax - 1, qmax) * s
    arrays = res.arrays._replace(codebooks=Cq, Q=res.reconstruct(Cq))
    return dataclasses.replace(res, arrays=arrays,
                               codebook_scale=s[..., 0, 0])


svd_compress = not_ported("codebook_compress.svd_compress",
                          "Budgets and solvers")
