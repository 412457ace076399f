"""GPTVQ Algorithm 1: Hessian-compensated vector quantization of a matrix
(port of ``repro/core/gptvq.py``, ``"gptq"`` solver).

Generalizes GPTQ's column-sequential sweep to d-dimensional VQ:

  * columns are processed left to right in spans of ``d``;
  * every ``group_cols`` columns a new *weight group* starts: blockwise
    normalization scales are computed and per-row-band codebooks are
    initialized with Hessian-weighted EM (codebook.py) from the *current*
    (error-compensated) weights — Algorithm 1 lines 9-11;
  * each d-span of each row is assigned to its band codebook with the
    Hessian-weighted distance (Eq. 4; the ``vq_assign`` kernel on CUDA);
  * the quantization error is propagated into the not-yet-quantized columns
    through the upper Cholesky factor U of H^{-1}.

For a span P quantized jointly with raw error E = W_P - Q_P, the update to
the remaining columns R is ``-(E U_PP^{-1}) U[P, R]`` (``exact_span_solve``;
a d x d triangular solve), else the per-column reading E_p / U[p,p].

The reference jits one group's init and sweep and runs the spans in a
``fori_loop``; here they are Python loops that update the working copy of W
in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import codebook as cb
from repro_torch.core import normalization as norm
from repro_torch.core.bpv import VQConfig
from repro_torch.core.hessian import cholesky_diag_weights


class VQArrays(NamedTuple):
    """Array outputs of the sweep (static layout in VQResult)."""

    Q: torch.Tensor          # (r, c) fake-quantized weights (float codebooks)
    indices: torch.Tensor    # (r, c // d) int32 centroid ids
    codebooks: torch.Tensor  # (n_cg, n_bands, k, d) float32, normalized space
    scale_sint: torch.Tensor # (n_cg, r, cg // Ns) int32 log-domain scale codes
    scale_a: torch.Tensor    # (n_cg,) log-grid step per group
    scale_z: torch.Tensor    # (n_cg,) log offset per group


@dataclasses.dataclass
class VQResult:
    """GPTVQ output for one weight matrix."""

    arrays: VQArrays
    cfg: VQConfig
    r: int
    c: int
    group_cols: int   # cg actually used (divides c)
    rows_per_band: int
    # post-processing state (filled by codebook_compress)
    codebook_scale: torch.Tensor | None = None  # (n_cg, n_bands) int8 cb scales

    @property
    def scale_block(self) -> int:
        return self.cfg.scale_block if self.cfg.scale_block > 0 else self.group_cols

    def expanded_scales(self) -> torch.Tensor:
        """Per-element normalization scales, (r, c)."""
        a = self.arrays
        if self.cfg.scale_block <= 0:
            return torch.ones((self.r, self.c), dtype=torch.float32,
                              device=a.Q.device)
        s = torch.exp2(a.scale_a[:, None, None] * a.scale_sint.to(torch.float32)
                       + a.scale_z[:, None, None])  # (n_cg, r, cg//Ns)
        s = torch.repeat_interleave(s, self.scale_block, dim=2)
        return s.transpose(0, 1).reshape(self.r, self.c)

    def reconstruct(self, codebooks: torch.Tensor | None = None) -> torch.Tensor:
        """Differentiable dequantization Q = S * codebooks[indices]."""
        C = self.arrays.codebooks if codebooks is None else codebooks
        Qn = gather_codebooks(C, self.arrays.indices, self.group_cols,
                              self.rows_per_band, self.cfg.d)
        return Qn * self.expanded_scales()


def gather_codebooks(codebooks: torch.Tensor, indices: torch.Tensor,
                     group_cols: int, rows_per_band: int,
                     d: int) -> torch.Tensor:
    """Reconstruct normalized weights from (n_cg, n_bands, k, d) codebooks."""
    n_cg, n_bands, _, _ = codebooks.shape
    r, _ = indices.shape
    spans_pg = group_cols // d
    idx4 = indices.reshape(n_bands, rows_per_band, n_cg, spans_pg).long()
    g_ix = torch.arange(n_cg, device=codebooks.device)[None, None, :, None]
    b_ix = torch.arange(n_bands, device=codebooks.device)[:, None, None, None]
    Qn = codebooks[g_ix, b_ix, idx4]  # (n_bands, rg, n_cg, spans_pg, d)
    return Qn.reshape(r, n_cg * group_cols)


def _pick_divisor(n: int, target: int, multiple_of: int = 1) -> int:
    """Largest divisor of n that is <= target and a multiple of
    ``multiple_of`` (falls back to multiple_of itself)."""
    best = multiple_of
    for cand in range(multiple_of, min(n, target) + 1, multiple_of):
        if n % cand == 0:
            best = cand
    return best


def plan_groups(r: int, c: int, cfg: VQConfig) -> tuple[int, int]:
    """Resolve (group_cols, rows_per_band) for a (r, c) matrix: a group holds
    cfg.group_size weights spanning at most cfg.group_cols columns."""
    cg = _pick_divisor(c, min(cfg.group_cols, cfg.group_size),
                       multiple_of=cfg.d)
    if c % cg != 0 or cg % cfg.d != 0:
        raise ValueError(f"no group plan for c={c}, d={cfg.d}")
    rg_target = max(1, cfg.group_size // cg)
    rg = _pick_divisor(r, rg_target)
    return cg, rg


def _group_init(Wg: torch.Tensor, wgt_g: torch.Tensor, *, cfg: VQConfig,
                group_cols: int, rows_per_band: int,
                generator: torch.Generator | None = None):
    """Group-entry work (Algorithm 1 lines 9-11): blockwise normalization
    scales + per-row-band Hessian-weighted EM codebook init from the
    current (error-compensated) weights."""
    r = Wg.shape[0]
    d, k = cfg.d, cfg.k
    cg, rg = group_cols, rows_per_band
    n_bands = r // rg
    spans_pg = cg // d
    Ns = cfg.scale_block if cfg.scale_block > 0 else cg
    dev = Wg.device

    Wg = Wg.to(torch.float32)
    if cfg.scale_block > 0:
        bs = norm.compute_block_scales(Wg, block=Ns, bits=cfg.scale_bits)
        Sg = bs.expand(cg)  # (r, cg)
        sint_g, a_g, z_g = bs.s_int, bs.a, bs.z
    else:
        Sg = torch.ones((r, cg), dtype=torch.float32, device=dev)
        sint_g = torch.zeros((r, cg // Ns), dtype=torch.int32, device=dev)
        a_g = torch.zeros((), dtype=torch.float32, device=dev)
        z_g = torch.zeros((), dtype=torch.float32, device=dev)

    Wn = Wg / Sg
    Xb = Wn.reshape(n_bands, rg * spans_pg, d)
    Hw1 = wgt_g.reshape(1, spans_pg, d).repeat(rg, 1, 1).reshape(rg * spans_pg, d)
    Cg = cb.init_codebook(Xb, Hw1, k=k, iters=cfg.em_iters,
                          method=cfg.em_seed,
                          generator=generator)  # (n_bands, k, d)
    return Sg, sint_g, a_g, z_g, Cg


def _group_sweep(W: torch.Tensor, U: torch.Tensor, Sg: torch.Tensor,
                 Cg: torch.Tensor, wgt_g: torch.Tensor, gstart: int, *,
                 cfg: VQConfig, group_cols: int, rows_per_band: int):
    """d-span sweep of one column group with error feedback through U, plus
    the lazy tail update beyond the group. Updates ``W`` (f32, owned by the
    caller) in place; returns (Qg, idxg)."""
    r, _ = W.shape
    d = cfg.d
    cg, rg = group_cols, rows_per_band
    n_bands = r // rg
    spans_pg = cg // d
    gend = gstart + cg

    Wg = W[:, gstart:gend].clone()
    Ug = U[gstart:gend, gstart:gend]
    Qg = torch.empty((r, cg), dtype=torch.float32, device=W.device)
    idxg = torch.empty((r, spans_pg), dtype=torch.int32, device=W.device)
    Eg = torch.empty((r, cg), dtype=torch.float32, device=W.device)
    hw_spans = wgt_g.reshape(spans_pg, 1, d).expand(spans_pg, rg, d).contiguous()

    for j in range(spans_pg):
        col = j * d
        x = Wg[:, col:col + d]
        S_span = Sg[:, col:col + d]
        xn = (x / S_span).contiguous().reshape(n_bands, rg, d)
        ab = cb.assign(xn, hw_spans[j], Cg)  # (n_bands, rg)
        qn = torch.gather(Cg, 1, ab.long()[..., None].expand(n_bands, rg, d))
        q = qn.reshape(r, d) * S_span

        E_raw = x - q
        U_PP = Ug[col:col + d, col:col + d]
        if cfg.exact_span_solve and d > 1:
            # Etilde = E_raw @ U_PP^{-1}
            Et = torch.linalg.solve_triangular(U_PP.T, E_raw.T, upper=False).T
        else:
            Et = E_raw / U_PP.diagonal()[None, :]

        if col + d < cg:  # remaining columns within this group
            Wg[:, col + d:] -= Et @ Ug[col:col + d, col + d:]
        Qg[:, col:col + d] = q
        idxg[:, j] = ab.reshape(r)
        Eg[:, col:col + d] = Et

    # ---- lazy tail update beyond the group ---------------------------------
    if gend < W.shape[1]:
        W[:, gend:] -= Eg @ U[gstart:gend, gend:]
    W[:, gstart:gend] = Wg
    return Qg, idxg


def _null_stage(name):
    return contextlib.nullcontext()


def gptvq_quantize_matrix(W: torch.Tensor, U: torch.Tensor, cfg: VQConfig,
                          generator: torch.Generator | None = None, *,
                          solver: str = "gptq", stage=None) -> VQResult:
    """Run Algorithm 1 on one weight matrix. ``U`` from inv_hessian_cholesky.

    Only the paper's ``"gptq"`` solver is ported. ``stage`` is an optional
    1-arg context-manager factory (the pipeline's stage timer) wrapped around
    each group's ``em_init`` and ``column_sweep``. ``generator`` feeds the
    kmeans++ seed (``cfg.em_seed``); the default Mahalanobis seed is
    deterministic and draws nothing."""
    if solver != "gptq":
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet (ROADMAP.md queue 1, "
            "'Budgets and solvers')")
    r, c = W.shape
    cg, rg = plan_groups(r, c, cfg)
    n_cg = c // cg
    stage = stage if stage is not None else _null_stage

    Wcur = W.to(torch.float32).clone()
    U = U.to(torch.float32)
    wgt_all = cholesky_diag_weights(U)  # (c,), 1/U_qq^2

    Qs, idxs, cbs, sints, a_list, z_list = [], [], [], [], [], []
    for g in range(n_cg):
        gstart = g * cg
        wgt_g = wgt_all[gstart:gstart + cg]
        with stage("em_init"):
            Sg, sint_g, a_g, z_g, Cg = _group_init(
                Wcur[:, gstart:gstart + cg], wgt_g, cfg=cfg, group_cols=cg,
                rows_per_band=rg, generator=generator)
        with stage("column_sweep"):
            Qg, idxg = _group_sweep(Wcur, U, Sg, Cg, wgt_g, gstart, cfg=cfg,
                                    group_cols=cg, rows_per_band=rg)
        Qs.append(Qg)
        idxs.append(idxg)
        cbs.append(Cg)
        sints.append(sint_g)
        a_list.append(a_g)
        z_list.append(z_g)

    arrays = VQArrays(
        Q=torch.cat(Qs, dim=1),
        indices=torch.cat(idxs, dim=1),
        codebooks=torch.stack(cbs, dim=0),
        scale_sint=torch.stack(sints, dim=0),
        scale_a=torch.stack(a_list, dim=0).reshape(n_cg),
        scale_z=torch.stack(z_list, dim=0).reshape(n_cg),
    )
    return VQResult(arrays=arrays, cfg=cfg, r=r, c=c, group_cols=cg,
                    rows_per_band=rg)


def layer_error(W: torch.Tensor, Q: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Hessian-weighted output reconstruction error tr(E H E^T) (Eq. 1)."""
    E = (W - Q).to(torch.float32)
    return torch.sum(E * (E @ H))
