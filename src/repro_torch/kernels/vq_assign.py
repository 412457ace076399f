"""Band-batched Hessian-weighted nearest-centroid assignment (GPTVQ Eq. 4),
and the quantizer's two loops around it, each one launch on the card.

Port of ``repro/kernels/vq_assign.py``. Three entry points share one argmin
in the CUDA source ``csrc/vq_assign.cu``:

* ``vq_assign``: one assignment of (B, n, d) points to per-band codebooks;
* ``vq_group_sweep``: one column group's d-span sweep with error feedback
  (the span loop of ``repro/core/gptvq.py::_group_sweep``), with the
  diagonal Eq. 4 metric or, given ``metric`` (``span_metrics``), the
  ``babai`` solver's full d x d span metric;
* ``vq_em``: ``iters`` Hessian-weighted E/M steps per band
  (``repro/core/codebook.py::em``).

Each launches its kernel for CUDA tensors and runs its plain PyTorch version
(``vq_assign_plain``, ``vq_group_sweep_plain``, ``vq_em_plain``) only for
CPU tensors; each counts its kernel launches in ``.launches``, and
``vq_group_sweep`` also by metric in ``.launches_by_impl`` (``"diag"`` /
``"babai"``). Fake tensors (the dry run, ``launch/dryrun``) launch nothing: the
variant is chosen as on the card, the kernel's outputs and scratch are
made, the work is recorded in ``obs/work`` and the launch counters stay
as they were; on CUDA tensors the same record is made while a count is
on.
"""
from __future__ import annotations

import array

import torch

from repro_torch.core.solvers import span_metric
from repro_torch.kernels import build
from repro_torch.obs import work

_THREADS = 128
_SMEM_LIMIT = 48 * 1024
# csrc/vq_assign.cu's kSmemBudget: the shared memory a sweep or EM CTA takes
_SMEM_BUDGET = 200 * 1024


def vq_assign_plain(x: torch.Tensor, hw: torch.Tensor,
                    codebooks: torch.Tensor) -> torch.Tensor:
    """Explicit (B, n, k, d) distances + argmin, as ``ref.vq_assign_ref``:
    x (B, n, d), hw broadcastable to x, codebooks (B, k, d) -> (B, n) int32.
    ``torch.argmin`` returns the first minimum, so ties go to the lowest
    index."""
    diff = x[:, :, None, :] - codebooks[:, None, :, :]
    hwb = hw.expand(x.shape)[:, :, None, :]
    dist = torch.sum(hwb * diff * diff, dim=-1)
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _launch_shape(B: int, n: int, k: int, d: int) -> tuple[int, int]:
    """(bands_per_cta, rows_per_cta) for a 128-thread CTA: one band per CTA
    for long bands, many bands per CTA for short ones (the span sweep's
    n = rows_per_band), capped so the staged codebooks fit 48 KB."""
    if n >= _THREADS:
        return 1, _THREADS
    rows = 1
    while rows < n:
        rows *= 2
    bands = min(_THREADS // rows, B, max(1, _SMEM_LIMIT // (k * d * 4)))
    return bands, rows


def vq_assign(x: torch.Tensor, hw: torch.Tensor,
              codebooks: torch.Tensor) -> torch.Tensor:
    """x (B, n, d) f32; hw (n, d) shared by all bands or (B, n, d) f32;
    codebooks (B, k, d) f32 -> (B, n) int32 argmin of the weighted squared
    distance, ties to the lowest index. Inputs are checked on every device,
    so CPU callers meet the kernel's contract too."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vq_assign: unsupported device {x.device}")
    if x.dim() != 3 or codebooks.dim() != 3:
        raise ValueError(f"vq_assign: x {tuple(x.shape)}, codebooks "
                         f"{tuple(codebooks.shape)} must be (B, n, d), (B, k, d)")
    B, n, d = x.shape
    k = codebooks.shape[1]
    if codebooks.shape != (B, k, d) or not 1 <= d <= 4:
        raise ValueError(f"vq_assign: codebooks {tuple(codebooks.shape)} vs "
                         f"x {tuple(x.shape)} (d <= 4)")
    if k * d * 4 > _SMEM_LIMIT:
        raise ValueError(f"vq_assign: codebook of {k}x{d} exceeds 48 KB")
    if hw.dim() == 3 and hw.shape[0] == 1:
        hw = hw[0]
    if tuple(hw.shape) == (n, d):
        hw_stride = 0
    elif tuple(hw.shape) == (B, n, d):
        hw_stride = n * d
    else:
        raise ValueError(f"vq_assign: hw {tuple(hw.shape)} must be (n, d) "
                         f"or (B, n, d) for x {tuple(x.shape)}")
    for name, t in (("x", x), ("hw", hw), ("codebooks", codebooks)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"vq_assign: {name} must be float32 on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"vq_assign: {name} must be contiguous")
    if x.device.type == "cpu":
        return vq_assign_plain(x, hw, codebooks)
    out = torch.empty((B, n), dtype=torch.int32, device=x.device)
    if B == 0 or n == 0:
        return out
    fake = work.is_fake(x)
    if fake or work.active() is not None:
        work.kernel("vq_assign", "assign",
                    work.vq_assign_work(B, n, k, d, hw.numel()))
    if fake:  # the dry run: the kernel's output, nothing run
        return out
    bands, rows = _launch_shape(B, n, k, d)
    fn = build.load("vq_assign").vq_assign_launch
    rc = fn(x.data_ptr(), hw.data_ptr(), codebooks.data_ptr(),
            out.data_ptr(), B, n, d, k, hw_stride, bands, rows, _THREADS,
            build.current_stream(x.device))
    build.check(rc, "vq_assign")
    vq_assign.launches += 1
    return out


vq_assign.launches = 0


def _check_f32(what: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{what}: {name} must be float32 on {dev}, not "
                             f"{t.dtype} on {t.device}")


# ---------------------------------------------------------------------------
# EM codebook fit
# ---------------------------------------------------------------------------

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


def vq_em_plain(X: torch.Tensor, Hw: torch.Tensor, C0: torch.Tensor,
                iters: int) -> torch.Tensor:
    """``iters`` E/M steps from seed centroids ``C0``, as
    ``repro.core.codebook.em``: the E-step ``vq_assign_plain``, the M-step
    ``m_step``."""
    C = C0
    for _ in range(iters):
        C = m_step(X, Hw, vq_assign_plain(X, Hw, C), C)
    return C


def _em_threads(B: int) -> int:
    """Threads a band: 8 warps when the bands fill the card's 132 SMs,
    32 for the few long bands of the KV codebook fit."""
    return 256 if B >= 264 else 1024


def vq_em(X: torch.Tensor, Hw: torch.Tensor, C0: torch.Tensor,
          iters: int) -> torch.Tensor:
    """``iters`` Hessian-weighted E/M steps per band: X (B, n, d) f32, Hw
    (n, d) shared by all bands or (B, n, d), C0 (B, k, d) seeds -> (B, k, d)
    codebooks. On CUDA one launch runs every step of every band (a CTA a
    band, the codebook in shared memory); its sums run in a fixed order, so
    the codebooks are the same bits from call to call. Inputs are checked on
    every device."""
    what = "vq_em"
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {X.device}")
    if X.dim() != 3 or C0.dim() != 3:
        raise ValueError(f"{what}: X {tuple(X.shape)}, C0 {tuple(C0.shape)} "
                         "must be (B, n, d), (B, k, d)")
    B, n, d = X.shape
    k = C0.shape[1]
    if C0.shape != (B, k, d) or not 1 <= d <= 4 or k < 1:
        raise ValueError(f"{what}: C0 {tuple(C0.shape)} vs X {tuple(X.shape)} "
                         "(1 <= d <= 4, k >= 1)")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{what}: iters must be an int >= 0, not {iters!r}")
    if Hw.dim() == 3 and Hw.shape[0] == 1:
        Hw = Hw[0]
    if tuple(Hw.shape) == (n, d):
        hw_stride = 0
    elif tuple(Hw.shape) == (B, n, d):
        hw_stride = n * d
    else:
        raise ValueError(f"{what}: Hw {tuple(Hw.shape)} must be (n, d) or "
                         f"(B, n, d) for X {tuple(X.shape)}")
    _check_f32(what, X.device, X=X, Hw=Hw, C0=C0)
    for name, t in (("X", X), ("Hw", Hw), ("C0", C0)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if 4 * k * d > _SMEM_BUDGET:
        raise ValueError(f"{what}: a {k}x{d} codebook exceeds the kernel's "
                         f"{_SMEM_BUDGET // 1024} KB of shared memory")
    if X.device.type == "cpu":
        return vq_em_plain(X, Hw, C0, iters)
    out = torch.empty_like(C0)
    if B == 0 or n == 0:
        return out.copy_(C0)
    # the indices stay in shared memory beside the codebook unless the band
    # is too long; then they go to this scratch
    idx = (torch.empty((B, n), dtype=torch.int32, device=X.device)
           if 4 * (k * d + n) > _SMEM_BUDGET else None)
    fake = work.is_fake(X)
    if fake or work.active() is not None:
        work.kernel("vq_em", "em",
                    work.vq_em_work(B, n, d, k, Hw.numel(), iters))
    if fake:  # the dry run: the kernel's outputs and scratch, nothing run
        return out
    args = array.array("q", (
        X.data_ptr(), Hw.data_ptr(), hw_stride, C0.data_ptr(),
        out.data_ptr(), 0 if idx is None else idx.data_ptr(), B, n, d, k,
        iters, _em_threads(B), build.current_stream(X.device)))
    rc = build.load("vq_assign").vq_em_launch(args.buffer_info()[0])
    build.check(rc, what)
    vq_em.launches += 1
    return out


vq_em.launches = 0


# ---------------------------------------------------------------------------
# GPTVQ column-group sweep
# ---------------------------------------------------------------------------

def span_metrics(Ug: torch.Tensor, d: int) -> torch.Tensor:
    """The ``babai`` metric of every d-span of a group, (cg / d, d, d):
    ``solvers.span_metric`` of each diagonal d x d block U_PP of the group's
    block of U, all in one batched triangular solve."""
    spans = Ug.shape[0] // d
    U_PP = Ug.reshape(spans, d, spans, d).diagonal(dim1=0, dim2=2)
    return span_metric(U_PP.permute(2, 0, 1)).contiguous()


def vq_group_sweep_plain(Wg: torch.Tensor, Ug: torch.Tensor, Sg: torch.Tensor,
                         Cg: torch.Tensor, wgt_g: torch.Tensor, *, d: int,
                         rows_per_band: int, exact_span_solve: bool,
                         metric: torch.Tensor | None = None):
    """The d-span sweep of one column group with error feedback through U,
    as ``repro.core.gptvq._group_sweep``'s span loop: updates ``Wg`` in
    place and returns (Qg, idxg, Eg). With ``metric`` (``span_metrics``)
    span j is assigned as ``solvers.assign_babai`` does, by y M_j y^T with
    y = (x / S - c) * S; otherwise by the diagonal Hessian weights."""
    r, cg = Wg.shape
    rg = rows_per_band
    n_bands = r // rg
    spans_pg = cg // d
    Qg = torch.empty((r, cg), dtype=torch.float32, device=Wg.device)
    idxg = torch.empty((r, spans_pg), dtype=torch.int32, device=Wg.device)
    Eg = torch.empty((r, cg), dtype=torch.float32, device=Wg.device)
    hw_spans = wgt_g.reshape(spans_pg, 1, d).expand(spans_pg, rg, d).contiguous()

    for j in range(spans_pg):
        col = j * d
        x = Wg[:, col:col + d]
        S_span = Sg[:, col:col + d]
        xn = (x / S_span).contiguous().reshape(n_bands, rg, d)
        if metric is None:
            ab = vq_assign_plain(xn, hw_spans[j], Cg)  # (n_bands, rg)
        else:
            y = ((xn[:, :, None, :] - Cg[:, None, :, :])
                 * S_span.reshape(n_bands, rg, 1, d))
            dist = torch.sum(y * (y @ metric[j]), dim=-1)
            ab = torch.argmin(dist, dim=-1).to(torch.int32)
        qn = torch.gather(Cg, 1, ab.long()[..., None].expand(n_bands, rg, d))
        q = qn.reshape(r, d) * S_span

        E_raw = x - q
        U_PP = Ug[col:col + d, col:col + d]
        if exact_span_solve and d > 1:
            # Etilde = E_raw @ U_PP^{-1}
            Et = torch.linalg.solve_triangular(U_PP.T, E_raw.T, upper=False).T
        else:
            Et = E_raw / U_PP.diagonal()[None, :]

        if col + d < cg:  # remaining columns within this group
            Wg[:, col + d:] -= Et @ Ug[col:col + d, col + d:]
        Qg[:, col:col + d] = q
        idxg[:, j] = ab.reshape(r)
        Eg[:, col:col + d] = Et
    return Qg, idxg, Eg


def _sweep_plan(r: int, cg: int) -> tuple[int, int]:
    """(rows a CTA, threads a CTA) of the sweep kernel: a thread a column up
    to 256 (the columns past it in a loop), and 16 rows a CTA, fewer where
    that leaves under two CTAs an SM."""
    threads = min(256, -(-cg // 32) * 32)
    rows = 16
    while rows > 4 and -(-r // rows) < 2 * 132:
        rows //= 2
    return rows, threads


def vq_group_sweep(Wg: torch.Tensor, Ug: torch.Tensor, Sg: torch.Tensor,
                   Cg: torch.Tensor, wgt_g: torch.Tensor, *, d: int,
                   rows_per_band: int, exact_span_solve: bool,
                   metric: torch.Tensor | None = None):
    """One column group's d-span sweep with error feedback (GPTVQ Algorithm
    1's inner loop), updating ``Wg`` in place.

    Wg (r, cg) f32, the group's current weights (rows may be strided, as a
    column slice of the whole matrix); Ug (cg, cg) the group's block of U
    (rows may be strided); Sg (r, cg) the normalization scales; Cg (r /
    rows_per_band, k, d) the bands' codebooks; wgt_g (cg,) the Hessian
    weights 1 / U_qq^2. Returns Qg (r, cg) = S * C[idx], idxg (r, cg / d)
    int32 and Eg (r, cg), the compensated errors the tail update reads.
    ``metric`` (cg / d, d, d) f32, from ``span_metrics``, switches the
    argmin to the ``babai`` solver's full span metric (the kernel's metric
    mode); None keeps the diagonal Eq. 4 weights.
    On CUDA one launch runs every span; the result is the same bits from
    call to call. Inputs are checked on every device."""
    what = "vq_group_sweep"
    if Wg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {Wg.device}")
    if Wg.dim() != 2 or not isinstance(d, int) or not 1 <= d <= 4:
        raise ValueError(f"{what}: Wg {tuple(Wg.shape)} must be (r, cg), "
                         f"1 <= d <= 4 (d={d!r})")
    r, cg = Wg.shape
    rg = rows_per_band
    if not isinstance(rg, int) or rg < 1 or r % rg or cg % d or cg == 0:
        raise ValueError(f"{what}: {r} rows in bands of {rg!r}, {cg} "
                         f"columns in spans of {d}")
    if (Ug.dim() != 2 or tuple(Ug.shape) != (cg, cg)
            or tuple(Sg.shape) != (r, cg) or Cg.dim() != 3
            or tuple(Cg.shape[::2]) != (r // rg, d) or Cg.shape[1] < 1
            or tuple(wgt_g.shape) != (cg,)):
        raise ValueError(
            f"{what}: Ug {tuple(Ug.shape)}, Sg {tuple(Sg.shape)}, Cg "
            f"{tuple(Cg.shape)}, wgt_g {tuple(wgt_g.shape)} do not fit Wg "
            f"{tuple(Wg.shape)} (d={d}, rows_per_band={rg})")
    _check_f32(what, Wg.device, Wg=Wg, Ug=Ug, Sg=Sg, Cg=Cg, wgt_g=wgt_g)
    for name, t in (("Wg", Wg), ("Ug", Ug), ("Sg", Sg)):
        if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{what}: {name} must have unit column stride "
                             "and disjoint rows")
    if metric is not None:
        if tuple(metric.shape) != (cg // d, d, d):
            raise ValueError(f"{what}: metric {tuple(metric.shape)} must be "
                             f"({cg // d}, {d}, {d})")
        _check_f32(what, Wg.device, metric=metric)
    for name, t in (("Cg", Cg), ("wgt_g", wgt_g), ("metric", metric)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if Wg.device.type == "cpu":
        return vq_group_sweep_plain(Wg, Ug, Sg, Cg, wgt_g, d=d,
                                    rows_per_band=rg,
                                    exact_span_solve=exact_span_solve,
                                    metric=metric)
    dev = Wg.device
    out = torch.empty((2 * r * cg,), dtype=torch.float32, device=dev)
    Qg, Eg = out[:r * cg].view(r, cg), out[r * cg:].view(r, cg)
    idxg = torch.empty((r, cg // d), dtype=torch.int32, device=dev)
    impl = "diag" if metric is None else "babai"
    fake = work.is_fake(Wg)
    if fake or work.active() is not None:
        work.kernel("vq_group_sweep", impl, work.vq_group_sweep_work(
            r, cg, d, Cg.shape[1], Cg.numel(),
            0 if metric is None else metric.numel()))
    if fake:  # the dry run: the kernel's outputs, nothing run
        return Qg, idxg, Eg
    rows, threads = _sweep_plan(r, cg)
    args = array.array("q", (
        Wg.data_ptr(), Wg.stride(0), Ug.data_ptr(), Ug.stride(0),
        Sg.data_ptr(), Sg.stride(0), Cg.data_ptr(), wgt_g.data_ptr(),
        Qg.data_ptr(), Eg.data_ptr(), idxg.data_ptr(), r, cg, d,
        Cg.shape[1], rg, int(bool(exact_span_solve)), rows, threads,
        0 if metric is None else metric.data_ptr(),
        build.current_stream(dev)))
    rc = build.load("vq_assign").vq_group_sweep_launch(args.buffer_info()[0])
    build.check(rc, what)
    vq_group_sweep.launches += 1
    vq_group_sweep.launches_by_impl[impl] = (
        vq_group_sweep.launches_by_impl.get(impl, 0) + 1)
    return Qg, idxg, Eg


vq_group_sweep.launches = 0
vq_group_sweep.launches_by_impl = {}
