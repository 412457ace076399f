"""Codebook post-processing (GPTVQ §3.3); port of
``repro/core/codebook_compress.py``.

1. ``codebook_update``    — gradient descent on the convex layer objective
                            ||W X - Q(C) X||_F^2 = tr(E H E^T) w.r.t. the
                            codebook entries (assignments fixed).
2. ``quantize_codebooks`` — symmetric int8 min-max quantization, one scale
                            per codebook.
3. ``svd_compress``       — rank reduction of the (N_G, k) codebook tensor
                            for 1D VQ, with GD fine-tuning of the factors
                            U'' and V' on the same layer objective (not on
                            the pipeline, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.gptvq import VQResult, gather_codebooks


def _adam_run(loss_fn, params, iters: int, lr):
    """The reference's hand-rolled Adam (bias-corrected moments, ``eps``
    added to sqrt(v_hat)) on torch autograd; not ``torch.optim.Adam``.
    ``params`` is a tensor or a tuple of tensors, and ``loss_fn`` takes the
    same structure."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    single = isinstance(params, torch.Tensor)
    ps = [p.detach().clone() for p in ((params,) if single else params)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    for t in range(iters):
        with torch.enable_grad():  # callers may run under no_grad
            for p in ps:
                p.requires_grad_(True)
            loss = loss_fn(ps[0] if single else tuple(ps))
            gs = torch.autograd.grad(loss, ps)
        tf = float(t + 1)
        for i, g in enumerate(gs):
            p = ps[i].detach()
            m = b1 * ms[i] + (1 - b1) * g
            v = b2 * vs[i] + (1 - b2) * g * g
            mhat = m / (1 - b1**tf)
            vhat = v / (1 - b2**tf)
            ps[i] = p - lr * mhat / (torch.sqrt(vhat) + eps)
            ms[i], vs[i] = m, v
    return ps[0] if single else tuple(ps)


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


class SVDCodebooks(NamedTuple):
    """Rank-reduced codebook tensor C-hat = U'' V'^T (1D VQ)."""

    U: torch.Tensor      # (N_G, rho)   quantized at codebook_bits
    V: torch.Tensor      # (k, rho)     kept in fp (negligible overhead)
    perm: torch.Tensor   # (N_G, k) int64: per-codebook sort permutation applied


def svd_compress(res: VQResult, W: torch.Tensor, H: torch.Tensor,
                 rank_frac: float | None = None,
                 gd_iters: int = 25) -> tuple[VQResult, SVDCodebooks]:
    """Paper's SVD codebook compression (applied to 1D VQ only).

    Sorts centroids within each codebook (reassigning indices), stacks the
    (N_G, k) codebook matrix, takes a rank-rho SVD, fine-tunes the factors by
    GD on the layer objective, and quantizes only U''. The sort is stable,
    as ``jnp.argsort``.
    """
    if res.cfg.d != 1:
        raise ValueError("SVD codebook compression is a 1D-VQ feature")
    frac = res.cfg.svd_rank_frac if rank_frac is None else rank_frac
    C = res.arrays.codebooks  # (n_cg, n_bands, k, 1)
    n_cg, n_bands, k, _ = C.shape
    N_G = n_cg * n_bands
    flat = C.reshape(N_G, k)
    dev = flat.device

    # sort centroids per codebook, remap indices so gather stays valid
    order = torch.argsort(flat, dim=1, stable=True)  # old idx at new pos
    sorted_flat = torch.gather(flat, 1, order)
    rank_of_old = torch.argsort(order, dim=1, stable=True)

    rg, cg = res.rows_per_band, res.group_cols
    idx4 = res.arrays.indices.reshape(n_bands, rg, n_cg, cg).long()
    # C.reshape(N_G, k) flattens (n_cg, n_bands) row-major
    flat_id = (torch.arange(n_cg, device=dev)[None, None, :, None] * n_bands
               + torch.arange(n_bands, device=dev)[:, None, None, None])
    new_idx = rank_of_old[flat_id, idx4].reshape(res.r, res.c).to(torch.int32)

    rho = max(1, int(round(frac * k)))
    Um, s, Vt = torch.linalg.svd(sorted_flat, full_matrices=False)
    U2 = (Um * s[None, :])[:, :rho]          # (N_G, rho), Sigma folded in
    V2 = Vt.T[:, :rho]                       # (k, rho)

    Wf = W.to(torch.float32)
    Hf = H.to(torch.float32)
    denom = torch.clamp(torch.sum(Wf * (Wf @ Hf)), min=1e-12)

    def rebuild(U2, V2):
        return (U2 @ V2.T).reshape(n_cg, n_bands, k, 1)

    base = dataclasses.replace(
        res, arrays=res.arrays._replace(indices=new_idx), codebook_scale=None)

    def loss(params):
        E = Wf - base.reconstruct(rebuild(*params))
        return torch.sum(E * (E @ Hf)) / denom

    lr = 1e-3 * torch.clamp(torch.std(U2, correction=0), min=1e-8)
    U2, V2 = _adam_run(loss, (U2, V2), gd_iters, lr)

    # quantize only U'' (paper: V' overhead negligible)
    qmax = 2 ** (res.cfg.codebook_bits - 1) - 1
    absmax = torch.clamp(U2.abs().amax(dim=1, keepdim=True), min=1e-12)
    su = absmax / qmax
    U2q = torch.clamp(torch.round(U2 / su), -qmax - 1, qmax) * su

    Cq = rebuild(U2q, V2)
    out = dataclasses.replace(base, arrays=base.arrays._replace(
        codebooks=Cq, Q=base.reconstruct(Cq)))
    return out, SVDCodebooks(U=U2q, V=V2, perm=order)
