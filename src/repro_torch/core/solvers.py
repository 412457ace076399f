"""Pluggable inner solvers for the GPTVQ column sweep; port of
``repro/core/solvers.py``.

Three solvers share the sweep skeleton in gptvq.py (recipe field
``solver``, launcher flag ``--solver``):

``gptq`` (default)
    The paper's assignment rule: Hessian-weighted nearest centroid under
    the *diagonal* conditioned metric ``1/U_qq^2`` per column.

``babai``
    Nearest-plane reading of GPTQ (arXiv 2507.18553): for a d-span P the
    exact conditional metric is the full d x d matrix

        M = (U_PP^T U_PP)^{-1} = U_PP^{-1} U_PP^{-T}

    and assignment minimizes ``e M e^T`` per row; at d=1 it reduces to
    ``1/U_qq^2`` and matches ``gptq``. On CUDA it runs inside the
    ``vq_group_sweep`` kernel (its metric mode), as the reference runs it
    inside its ``_group_sweep``.

``cd``
    CDQuant-style greedy coordinate descent (arXiv 2406.17542) run as a
    refinement pass after the ``gptq`` sweep: with E = Q - W and
    G = E H, re-deciding span P of one row from centroid q to candidate
    q' changes the objective tr(E H E^T) by

        Δf = 2 δ G[row, P]^T + δ H_PP δ^T,   δ = q' - q

    Each pass visits every span once and switches only when Δf < 0, so the
    objective never rises. The reference's pass is a jitted XLA loop, not
    a Pallas kernel; here it is a plain PyTorch span loop.
"""
from __future__ import annotations

import torch

from repro_torch.core.bpv import VQConfig

VALID_SOLVERS = ("gptq", "babai", "cd")


def span_metric(U_PP: torch.Tensor) -> torch.Tensor:
    """Exact conditional span metric ``M = (U_PP^T U_PP)^{-1}``.

    ``U_PP`` is the upper-triangular d x d diagonal block of U (where
    ``H^{-1} = U^T U``), so ``U_PP^T U_PP`` is the span's conditioned
    inverse-Hessian block. A leading batch axis of spans is allowed.
    """
    d = U_PP.shape[-1]
    eye = torch.eye(d, dtype=U_PP.dtype, device=U_PP.device)
    Uinv = torch.linalg.solve_triangular(U_PP, eye.expand_as(U_PP),
                                         upper=True)
    return Uinv @ Uinv.transpose(-1, -2)


def assign_babai(xb: torch.Tensor, Sb: torch.Tensor, M: torch.Tensor,
                 Cg: torch.Tensor) -> torch.Tensor:
    """Full-metric nearest-centroid assignment for one d-span.

    xb: (n_bands, rg, d) normalized span values; Sb: (n_bands, rg, d)
    per-row normalization scales over the span; M: (d, d) span metric in
    *weight* space; Cg: (n_bands, k, d) band codebooks. The weight-space
    error of row i against centroid m is ``y = (x - c_m) * S``; its distance
    ``y M y^T``. Returns (n_bands, rg) int32 argmin ids (ties to the lowest).
    """
    y = (xb[:, :, None, :] - Cg[:, None, :, :]) * Sb[:, :, None, :]
    dist = torch.sum(y * (y @ M), dim=-1)
    return torch.argmin(dist, dim=-1).to(torch.int32)


@torch.no_grad()
def cd_refine(W: torch.Tensor, Q: torch.Tensor, indices: torch.Tensor,
              codebooks: torch.Tensor, S_full: torch.Tensor, H: torch.Tensor,
              *, cfg: VQConfig, group_cols: int, rows_per_band: int,
              passes: int):
    """Greedy coordinate-descent refinement of assigned indices.

    Revisits every d-span ``passes`` times; per span all rows are
    re-decided at once (rows are independent in tr(E H E^T)). Only strictly
    improving switches are taken, so the final objective is <= the
    input's. Codebooks and scales are fixed: only ``indices`` (and the
    matching ``Q``) change. Returns (Q, indices, n_changed).
    """
    r, c = W.shape
    d = cfg.d
    rg = rows_per_band
    n_bands = r // rg
    spans_pg = group_cols // d

    W = W.to(torch.float32)
    Q = Q.to(torch.float32).clone()
    H = H.to(torch.float32)
    idx_all = indices.to(torch.int32).clone()
    G = (Q - W) @ H
    changed = torch.zeros((), dtype=torch.int64, device=W.device)
    for _ in range(passes):
        for j in range(c // d):
            col = j * d
            Cg = codebooks[j // spans_pg]                  # (n_bands, k, d)
            Sb = S_full[:, col:col + d].reshape(n_bands, rg, d)
            q_cand = Cg[:, None, :, :] * Sb[:, :, None, :]  # (nb, rg, k, d)
            Q_span = Q[:, col:col + d]
            delta = q_cand - Q_span.reshape(n_bands, rg, 1, d)
            Gb = G[:, col:col + d].reshape(n_bands, rg, 1, d)
            H_PP = H[col:col + d, col:col + d]
            df = (2.0 * torch.sum(delta * Gb, dim=-1)
                  + torch.sum(delta * (delta @ H_PP), dim=-1))
            best = torch.argmin(df, dim=-1)                 # (nb, rg)
            best_df = torch.gather(df, 2, best[..., None])[..., 0]
            accept = best_df < 0.0
            step = torch.gather(
                delta, 2, best[..., None, None].expand(n_bands, rg, 1, d)
            )[:, :, 0, :]
            step = torch.where(accept[..., None], step,
                               torch.zeros_like(step)).reshape(r, d)
            Q[:, col:col + d] = Q_span + step
            G += step @ H[col:col + d, :]
            acc = accept.reshape(r)
            idx_all[:, j] = torch.where(acc, best.reshape(r).to(torch.int32),
                                        idx_all[:, j])
            changed += acc.sum()
    return Q, idx_all, int(changed)
