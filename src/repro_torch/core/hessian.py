"""Layer-Hessian utilities for GPTVQ (port of ``repro/core/hessian.py``).

The per-layer objective Hessian of ``||W X - Ŵ X||_F^2`` w.r.t. a row of W is
``H = X X^T`` (shape (c, c), c = in_features), shared across rows.
``accumulate`` keeps the full (c, c) running sum the column sweep needs; it
adds into the state's matrix in place (one (c, c) buffer per tap instead of
a new one per chunk). The diagonal-only and mesh-sharded variants of the
reference are not ported yet (ROADMAP.md queue 1, "Budgets and solvers"
and "Multi-device and training").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.pending import not_ported


class HessianState(NamedTuple):
    H: torch.Tensor  # (c, c) running sum of X X^T
    n: int           # number of accumulated tokens


def init_hessian(c: int, dtype=torch.float32, device=None) -> HessianState:
    return HessianState(torch.zeros((c, c), dtype=dtype, device=device), 0)


def accumulate(state: HessianState, x: torch.Tensor) -> HessianState:
    """Accumulate inputs ``x`` of shape (..., c) into the Hessian (in place)."""
    c = state.H.shape[0]
    xf = x.reshape(-1, c).to(state.H.dtype)
    state.H.addmm_(xf.T, xf)
    return HessianState(state.H, state.n + xf.shape[0])


def finalize(state: HessianState) -> torch.Tensor:
    """Mean Hessian (scale-invariant for the argmin, but keeps damping sane)."""
    return state.H / max(state.n, 1)


def inv_hessian_cholesky(H: torch.Tensor, percdamp: float = 0.01) -> torch.Tensor:
    """Return upper-triangular U with ``H^{-1} = U^T U`` (GPTQ formulation).

    Dead columns (zero diagonal) get unit diagonal so they quantize
    round-to-nearest with no error feedback. The damping is ``percdamp``
    times the mean *live* diagonal (sum over live columns / live count).
    """
    c = H.shape[0]
    H = H.clone()
    diag = H.diagonal()
    dead = diag == 0
    live = max(int((~dead).sum()), 1)
    damp = percdamp * torch.where(dead, 0.0, diag).sum() / live
    damp = torch.where(damp <= 0, torch.full_like(damp, 1e-8), damp)
    diag.add_(dead.to(H.dtype))
    diag.add_(damp)
    # H^{-1} via Cholesky solves (stable), then Cholesky of the inverse.
    L = torch.linalg.cholesky(H)
    eye = torch.eye(c, dtype=H.dtype, device=H.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Hinv = Linv.T @ Linv
    # unique lower factor of Hinv, transposed -> upper U with Hinv = U^T U
    return torch.linalg.cholesky(Hinv).T.contiguous()


def cholesky_diag_weights(U: torch.Tensor) -> torch.Tensor:
    """Per-column error importance ``1 / U[q,q]^2`` (GPTQ Eq. 2's weight of
    column q's error, used as the diagonal H-weights of assignment / EM)."""
    d = U.diagonal()
    return 1.0 / torch.clamp(d * d, min=1e-20)


init_diag_hessian = not_ported("hessian.init_diag_hessian", "Budgets and solvers")
accumulate_diag = not_ported("hessian.accumulate_diag", "Budgets and solvers")
finalize_diag = not_ported("hessian.finalize_diag", "Budgets and solvers")
accumulate_sharded = not_ported("hessian.accumulate_sharded",
                                "Multi-device and training")
