"""Layer-Hessian utilities for GPTVQ (port of ``repro/core/hessian.py``).

The per-layer objective Hessian of ``||W X - Ŵ X||_F^2`` w.r.t. a row of W is
``H = X X^T`` (shape (c, c), c = in_features), shared across rows.
``accumulate`` keeps the full (c, c) running sum the column sweep needs; it
adds into the state's matrix in place (one (c, c) buffer per tap instead of
a new one per chunk). ``DiagHessianState`` + ``accumulate_diag`` keep only
``sum_i x_i^2`` per column: the budget pre-pass reads ``diag(H)`` alone, so
it never materializes (c, c). ``accumulate_sharded`` is the data-parallel
form over a ``torch.distributed`` ``DeviceMesh`` axis: each rank forms the
partial sum of its block of calibration rows and one all-reduce merges
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs import work


class HessianState(NamedTuple):
    H: torch.Tensor  # (c, c) running sum of X X^T
    n: int           # number of accumulated tokens


class DiagHessianState(NamedTuple):
    """O(c) accumulator: only the diagonal ``sum_i x_i[q]^2`` per column."""

    diag: torch.Tensor  # (c,) running sum of x^2 per column
    n: int              # number of accumulated tokens


def init_hessian(c: int, dtype=torch.float32, device=None) -> HessianState:
    return HessianState(torch.zeros((c, c), dtype=dtype, device=device), 0)


def init_diag_hessian(c: int, dtype=torch.float32, device=None) -> DiagHessianState:
    return DiagHessianState(torch.zeros((c,), dtype=dtype, device=device), 0)


def accumulate(state: HessianState, x: torch.Tensor) -> HessianState:
    """Accumulate inputs ``x`` of shape (..., c) into the Hessian (in place)."""
    c = state.H.shape[0]
    xf = x.reshape(-1, c).to(state.H.dtype)
    state.H.addmm_(xf.T, xf)
    return HessianState(state.H, state.n + xf.shape[0])


def accumulate_diag(state: DiagHessianState, x: torch.Tensor) -> DiagHessianState:
    """Accumulate ``diag(X^T X)`` without ever forming (c, c)."""
    c = state.diag.shape[0]
    xf = x.reshape(-1, c).to(state.diag.dtype)
    return DiagHessianState(state.diag + torch.sum(xf * xf, dim=0),
                            state.n + xf.shape[0])


def finalize(state: HessianState) -> torch.Tensor:
    """Mean Hessian (scale-invariant for the argmin, but keeps damping sane)."""
    return state.H / max(state.n, 1)


def finalize_diag(state: DiagHessianState) -> torch.Tensor:
    """Mean Hessian diagonal, (c,)."""
    return state.diag / max(state.n, 1)


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


def _shard_rows(x: torch.Tensor, c: int, n_dev: int, index: int):
    """Flatten to (rows, c) f32, zero-pad the rows to a multiple of
    ``n_dev`` and return block ``index`` of ``n_dev`` contiguous ones and
    the true row count. Zero rows add nothing to ``X^T X``, so ``n`` stays
    exact."""
    xf = x.reshape(-1, c).to(torch.float32)
    rows = xf.shape[0]
    pad = (-rows) % n_dev
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, c))])
    per = xf.shape[0] // n_dev
    return xf[index * per:(index + 1) * per], rows


def accumulate_sharded(state, x: torch.Tensor, mesh, axis: str = "data"):
    """Data-parallel ``accumulate`` / ``accumulate_diag`` over ``mesh``'s
    ``axis`` (a ``torch.distributed`` ``DeviceMesh``). Every rank holds
    the whole ``x``, as the reference's in-process mesh does, and takes
    its own contiguous block of the (zero-padded) rows; it forms the
    block's ``X^T X`` (or its diagonal) in f32, rank 0 on top of the
    running sum and the others from zero, and one ``all_reduce`` (SUM)
    over the axis's group leaves the new sum on every rank. Takes a
    ``HessianState`` (updated in place, as ``accumulate``) or a
    ``DiagHessianState`` and returns the same kind. At one rank the
    arithmetic is ``accumulate``'s; across ranks the sum's order differs,
    so it matches the single-device sum to rounding."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
    index = mesh.get_local_rank(axis)
    if isinstance(state, DiagHessianState):
        xl, rows = _shard_rows(x, state.diag.shape[0], n_dev, index)
        part = torch.sum(xl * xl, dim=0)
        total = state.diag + part if index == 0 else part
        work.collective("all-reduce", group, work.nbytes(total))
        dist.all_reduce(total, group=group)
        return DiagHessianState(total, state.n + rows)
    xl, rows = _shard_rows(x, state.H.shape[0], n_dev, index)
    if index != 0:
        state.H.zero_()
    state.H.addmm_(xl.T, xl)
    work.collective("all-reduce", group, work.nbytes(state.H))
    dist.all_reduce(state.H, group=group)
    return HessianState(state.H, state.n + rows)
