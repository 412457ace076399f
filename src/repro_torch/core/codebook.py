"""Codebook initialization and Hessian-weighted EM (GPTVQ §3.2); port of
``repro/core/codebook.py`` with a leading band axis.

Vectors are rows of ``X`` with shape (B, n, d), one band of n vectors per
leading index; each vector carries a diagonal weight vector ``Hw``
broadcastable to X (the per-coordinate Hessian importances, see
``hessian.cholesky_diag_weights``). Each band has its own codebook
(B, k, d). With ``Hw == 1`` the EM reduces exactly to k-Means. The reference
vmaps these functions over bands; here the band axis is written out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vq_assign import vq_assign
from repro_torch.pending import not_ported


def weighted_distances(X: torch.Tensor, Hw: torch.Tensor,
                       C: torch.Tensor) -> torch.Tensor:
    """(B, n, k) matrix of sum_p Hw[b,i,p] * (X[b,i,p] - C[b,m,p])^2 in the
    expanded form sum(Hw*X^2) - 2*(Hw*X)@C^T + Hw@(C^2)^T."""
    Hw = Hw.expand(X.shape)
    x2 = torch.sum(Hw * X * X, dim=-1, keepdim=True)
    cross = (Hw * X) @ C.transpose(-1, -2)
    c2 = Hw @ (C * C).transpose(-1, -2)
    return x2 - 2.0 * cross + c2


def assign(X: torch.Tensor, Hw: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """E-step / Eq. 4: Hessian-weighted nearest-centroid assignment,
    (B, n) int32. On CUDA this is the ``vq_assign`` kernel."""
    return vq_assign(X, Hw, C)


def m_step(X: torch.Tensor, Hw: torch.Tensor, idx: torch.Tensor,
           C_prev: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted centroid update (diagonal-Hessian case), per band:
    c_m = (sum_{i in I_m} Hw_i)^+ (sum_{i in I_m} Hw_i * x_i), elementwise.
    Empty clusters keep their previous centroid. One-hot batched matmuls, as
    the reference, keep the sums deterministic."""
    k = C_prev.shape[1]
    Hw = Hw.expand(X.shape)
    onehot = torch.nn.functional.one_hot(idx.long(), k).to(X.dtype)  # (B,n,k)
    num = onehot.transpose(1, 2) @ (Hw * X)  # (B, k, d)
    den = onehot.transpose(1, 2) @ Hw        # (B, k, d)
    new = num / torch.clamp(den, min=1e-12)
    return torch.where(den <= 1e-12, C_prev, new)


def em(X: torch.Tensor, Hw: torch.Tensor, C0: torch.Tensor,
       iters: int = 100) -> torch.Tensor:
    """Run ``iters`` E/M steps from seed centroids ``C0``; returns codebooks."""
    C = C0
    for _ in range(iters):
        C = m_step(X, Hw, assign(X, Hw, C), C)
    return C


def mahalanobis_init(X: torch.Tensor, k: int) -> torch.Tensor:
    """Paper's 'Mahalanobis' seeding, per band: sort points by Mahalanobis
    distance to the band mean (stable sort, as ``jnp.argsort``) and take k
    equally spaced points from the sorted list."""
    B, n, d = X.shape
    mu = X.mean(dim=1, keepdim=True)
    Xc = X - mu
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    cov = Xc.transpose(1, 2) @ Xc / n + 1e-6 * eye
    prec = torch.linalg.inv(cov)
    a = torch.einsum("bnd,bde,bne->bn", Xc, prec, Xc)
    order = torch.argsort(a, dim=1, stable=True)
    pick = torch.round(torch.linspace(0, n - 1, k, dtype=torch.float32,
                                      device=X.device))
    pick = torch.clamp(pick.long(), 0, n - 1)
    rows = order[:, pick]  # (B, k)
    return torch.gather(X, 1, rows[..., None].expand(B, k, d))


kmeanspp_init = not_ported("codebook.kmeanspp_init", "Budgets and solvers")


def init_codebook(X: torch.Tensor, Hw: torch.Tensor, *, k: int,
                  iters: int = 100, method: str = "mahalanobis",
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Seed + EM refine one codebook per band (Algorithm 1 l.11)."""
    if method == "mahalanobis":
        C0 = mahalanobis_init(X, k)
    elif method == "kmeans++":
        C0 = kmeanspp_init(X, Hw, k, generator)
    else:
        raise ValueError(f"unknown init method {method!r}")
    return em(X, Hw, C0, iters=iters)
