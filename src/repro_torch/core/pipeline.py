"""Model-level GPTVQ pipeline: a family-agnostic sequential PTQ driver (port
of ``repro/core/pipeline.py``).

Walk the blocks in order; for each block, accumulate the input Hessian of
every target matmul from the *current* (already partially quantized)
activation stream, quantize the block's weights, then push the activations
through the quantized block before moving on — so downstream Hessians see
upstream quantization error. Block anatomy lives in the family's adapter
(core/adapters/); configuration is a ``QuantRecipe`` (core/recipe.py).

Weight convention: model kernels are (in, out); GPTVQ operates on (out, in)
so every matrix is transposed on entry and the packed VQLinear stores
(r=out, c=in).

With ``telemetry`` (an ``obs.Telemetry``) each stage also records a
``span.quant/<stage>`` histogram, and the event log gains one
``quant_stage`` row per (block, stage) call and one ``quant_target`` row
per quantized target, with the reference's schemas.

Configuration is a ``QuantRecipe`` (or the legacy ``(method, cfg)`` pair,
compiled by ``QuantRecipe.from_legacy``); its actions are GPTVQ (every
solver) and its ``kmeans`` / ``kmeans_data`` ablations, ``IntQuant`` (RTN or
GPTQ) and ``KeepDense``. ``budget_bpv`` turns on Hessian-budgeted mixed
precision: a pre-pass over the unquantized model collects per-target
diagonal Hessians (never a (c, c) one), and a greedy allocator picks each
target's setting so the model-wide weighted bpv stays on budget.

Expert stacks (``WeightSpec.per_expert``: an (E, in, out) leaf of a MoE
block) quantize expert by expert, each with its own routed-token Hessian
(``_quantize_expert_stack``), and pack into one stacked ``VQLinear``;
the budget pre-pass scores a stack by its experts' mean diagonal Hessian
and the allocator gives all E matrices one setting.

Distribution: with ``hessian_mesh=`` (a ``torch.distributed``
``DeviceMesh``) the Hessian capture (the budget pre-pass and pass 1) runs
data-parallel: every rank holds the whole calibration set, takes its
block of each tap's rows and one all-reduce a tap call merges the partial
sums (``hessian.accumulate_sharded``). The quantizer stays layer-local
and runs on every rank on the same merged Hessians.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Callable

import torch

from repro_torch.core import adapters
from repro_torch.core import hessian as hes
from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.bpv import VQConfig, weighted_bpv
from repro_torch.core.codebook_compress import codebook_update, quantize_codebooks
from repro_torch.core.gptvq import gptvq_quantize_matrix, layer_error
from repro_torch.core.quant import gptq_quantize, rtn_quantize
from repro_torch.core.recipe import (
    BudgetEntry,
    IntQuant,
    KeepDense,
    QuantRecipe,
    Quantize,
    RecipeError,
    Resolved,
    TargetInfo,
    allocate_budget,
)
from repro_torch.device import full_fp32_matmuls


@dataclasses.dataclass
class QuantizeReport:
    per_layer: list     # one row per block: {"layer", "block", target: err}
    total_seconds: float
    method: str             # legacy method, or "recipe[:<name>]"
    bits_per_value: float   # nominal cfg bpv (legacy uniform) / achieved
    # per canonical target: {"action", "rule", "bpv", "numel", "error", ...}
    per_target: dict = dataclasses.field(default_factory=dict)
    achieved_bpv: float = 0.0   # numel-weighted model-wide bpv, overhead incl.
    recipe: dict | None = None  # the resolved recipe, JSON-able
    # seconds per pipeline stage (budget_prepass, budget_allocate,
    # hessian_capture, em_init, column_sweep, cd_refine, codebook_update,
    # advance); each stage synchronizes the device on exit
    stage_seconds: dict = dataclasses.field(default_factory=dict)
    # anomalies (budget pre-pass targets whose Hessian tap never fired,
    # scored by weight variance instead)
    warnings: list = dataclasses.field(default_factory=list)

    def total_error(self) -> float:
        """Summed Hessian-weighted reconstruction error over all targets."""
        return float(sum(
            v for row in self.per_layer for k, v in row.items()
            if k not in ("layer", "block")))


def _null_stage(name):
    return contextlib.nullcontext()


def _eye(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(W.shape[1], dtype=torch.float32, device=W.device)


def _apply_action(W_io, H, action, generator=None, stage=_null_stage):
    """W_io: (in, out) kernel, H its input Hessian (None: identity).
    Returns (fake-quant (in, out), VQLinear | None), as the reference:
    only ``gptvq`` packs; ``IntQuant``, ``kmeans`` and ``kmeans_data``
    leave a dense fake-quant leaf. Every VQ method runs the ``vq_em`` and
    ``vq_group_sweep`` kernels on CUDA; they differ only in U."""
    W = W_io.T.to(torch.float32)  # (out, in)
    if isinstance(action, IntQuant):
        if action.method == "rtn":
            with stage("column_sweep"):
                q = rtn_quantize(W, action.bits, action.group_size)
            return q.T.to(W_io.dtype), None
        if action.method != "gptq":
            raise ValueError(f"unknown IntQuant method {action.method!r}")
        U = hes.inv_hessian_cholesky(H if H is not None else _eye(W))
        with stage("column_sweep"):
            Q = gptq_quantize(W, U, bits=action.bits,
                              group_size=action.group_size)
        return Q.T.to(W_io.dtype), None
    if not isinstance(action, Quantize):
        raise TypeError(f"no quantizer for action {action!r}")
    cfg = action.cfg
    if action.method == "kmeans":
        # Table-1 baseline: plain k-means clustering, no Hessian weighting,
        # no error feedback (identity H => EM == k-means, U == I)
        res = gptvq_quantize_matrix(W, _eye(W), cfg, generator, stage=stage)
        return res.arrays.Q.T.to(W_io.dtype), None
    U = hes.inv_hessian_cholesky(H if H is not None else _eye(W),
                                 cfg.percdamp)
    if action.method == "kmeans_data":
        # Table-1 middle row: Hessian-weighted EM/assignment but no GPTQ
        # error feedback: diagonal-only U
        res = gptvq_quantize_matrix(W, torch.diag(U.diagonal()), cfg,
                                    generator, stage=stage)
        return res.arrays.Q.T.to(W_io.dtype), None
    if action.method != "gptvq":
        raise ValueError(f"unknown Quantize method {action.method!r}")
    H_eff = H if H is not None else _eye(W)
    res = gptvq_quantize_matrix(W, U, cfg, generator, solver=action.solver,
                                H=H_eff if action.solver == "cd" else None,
                                stage=stage)
    with stage("codebook_update"):
        if H is not None:
            res = codebook_update(res, W, H)
        res = quantize_codebooks(res)
        packed = vql_mod.from_vq_result(res)
    return res.arrays.Q.T.to(W_io.dtype), packed


def _recon_error(W_io, q_io, H) -> float:
    """Hessian-weighted reconstruction error of one quantized matrix."""
    W = W_io.T.to(torch.float32)
    if H is None:
        H = _eye(W)
    return float(layer_error(W, q_io.T.to(torch.float32), H))


def _stack_packed(packs: list) -> vql_mod.VQLinear:
    """Per-expert VQLinear leaves -> one with a leading E on every array
    (the static fields are every expert's: one layout)."""
    arrays = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
              "scale_z")
    return dataclasses.replace(packs[0], **{
        f: torch.stack([getattr(p, f) for p in packs]) for f in arrays})


def _quantize_expert_stack(Ws, tap, action, generator, pack, rule: str,
                           stage=_null_stage):
    """Quantize an (E, in, out) expert stack, one routed-token Hessian per
    expert, the experts in order from one generator (the reference splits
    its key an expert). Returns (new leaf, summed reconstruction error)."""
    Hs, n = tap if tap is not None else (None, None)
    # n: raw routed-token counts summed over chunks; clamp exactly once here
    qs, packs = [], []
    err = 0.0
    for e in range(Ws.shape[0]):
        He = Hs[e] / torch.clamp(n[e], min=1.0) if Hs is not None else None
        q, packed = _apply_action(Ws[e], He, action, generator, stage)
        qs.append(q)
        if packed is not None:
            packed = dataclasses.replace(packed, rule=rule)
        packs.append(packed)
        err += _recon_error(Ws[e], q, He)
    if pack and packs[0] is not None:
        return _stack_packed(packs), err
    return torch.stack(qs), err


def _collect_targets(blocks) -> list[TargetInfo]:
    """Flatten every block's WeightSpecs into resolver TargetInfo rows."""
    out = []
    for blk in blocks:
        prefix = blk.prefix
        block_params = blk.params()
        for spec in blk.targets():
            W = adapters.tree_get(block_params, spec.path)
            c, r = W.shape[-2], W.shape[-1]
            default = (KeepDense(spec.keep_dense) if spec.keep_dense
                       is not None else None)
            out.append(TargetInfo(
                name=f"{prefix}.{spec.name}", group=spec.group, r=r, c=c,
                numel=W.numel(), default_action=default))
    return out


def _check_plan(blocks, plan) -> None:
    """Fail fast on actions the target's leaf cannot support."""
    for blk in blocks:
        block_params = blk.params()
        for spec in blk.targets():
            res = plan[f"{blk.prefix}.{spec.name}"]
            if isinstance(res.action, KeepDense):
                continue
            W = adapters.tree_get(block_params, spec.path)
            if W.dim() != (3 if spec.per_expert else 2):
                raise RecipeError(
                    f"target {blk.prefix}.{spec.name!r} has shape "
                    f"{tuple(W.shape)}; only 2-D kernels (or 3-D expert "
                    f"stacks) can quantize — use keep_dense (matched "
                    f"{res.rule})")


def _budget_prepass(adapter, chunks, plan, progress, mesh=None,
                    mesh_axis: str = "data"):
    """Collect per-target diagonal Hessians from the *unquantized* model.

    One forward sweep under ``adapters.diag_capture()``: every tap
    accumulates an O(c) ``DiagHessianState`` (a per-expert tap an (E, c)
    stack, scored by its experts' mean); the (c, c) Hessian is never
    materialized. Installs the original params and advances, on a fresh
    blocks() list so the real sweep starts clean. Returns (diag, missed):
    ``missed`` maps target names whose Hessian could not be collected to a
    reason string. With ``mesh``, the taps accumulate sharded over its
    ``mesh_axis``."""
    states = [adapter.calib_state(c, ci) for ci, c in enumerate(chunks)]
    diag: dict[str, torch.Tensor] = {}
    missed: dict[str, str] = {}
    with contextlib.ExitStack() as capture:
        capture.enter_context(adapters.diag_capture())
        if mesh is not None:
            capture.enter_context(adapters.hessian_mesh(mesh, mesh_axis))
        for blk in adapter.blocks():
            eligible = [
                spec for spec in blk.targets()
                if isinstance(plan[f"{blk.prefix}.{spec.name}"].action,
                              Quantize) and spec.tap is not None]
            groups = frozenset(spec.group for spec in eligible)
            taps: dict = {}
            if groups:
                for st in states:
                    taps = blk.capture(st, taps, groups)
            for spec in eligible:
                tap = taps.get(spec.tap)
                name = f"{blk.prefix}.{spec.name}"
                if tap is None:
                    missed[name] = f"tap {spec.tap!r} never fired"
                    continue
                if spec.per_expert:
                    Hd, n = tap  # (E, c) diagonal stack
                    diag[name] = (Hd / torch.clamp(n, min=1.0)[:, None]
                                  ).mean(0)
                else:
                    diag[name] = hes.finalize_diag(tap)
            blk.install(blk.params())
            states = [blk.advance(st) for st in states]
            if progress:
                progress(f"budget pre-pass: {blk.name}")
    return diag, missed


def _allocate(blocks, plan, diag, missed, budget_bpv, progress,
              scorer: str = "closed_form"):
    """Rewrite Quantize plan entries with the budget allocator's choice.

    Returns (plan, warnings): targets the pre-pass could not collect a
    Hessian for are scored by weight variance (identity weights) and
    reported in ``warnings``."""
    entries, fixed_bits, fixed_numel = [], 0.0, 0
    warn_rows: list[str] = []
    for blk in blocks:
        block_params = blk.params()
        for spec in blk.targets():
            name = f"{blk.prefix}.{spec.name}"
            res = plan[name]
            W = adapters.tree_get(block_params, spec.path)
            # an expert stack: its E matrices share one choice, scored on
            # the first
            replicas = W.shape[0] if spec.per_expert else 1
            Wq = (W[0] if spec.per_expert else W).T.to(torch.float32)
            numel = W.numel()
            if isinstance(res.action, Quantize):
                diag_h = diag.get(name)
                if diag_h is None:
                    why = missed.get(name, "no Hessian tap declared")
                    msg = (f"budget pre-pass: {why} for {name}; scoring "
                           f"by weight variance (identity Hessian)")
                    warn_rows.append(msg)
                    warnings.warn(msg, stacklevel=3)
                    diag_h = torch.ones((Wq.shape[-1],), dtype=torch.float32,
                                        device=Wq.device)
                entries.append(BudgetEntry(
                    name=name, W=Wq, diag_h=diag_h,
                    base_cfg=res.action.cfg, numel=numel,
                    replicas=replicas))
            else:
                r, c = Wq.shape[-2], Wq.shape[-1]
                fixed_bits += numel * res.action.bpv(r, c)
                fixed_numel += numel
    alloc = allocate_budget(entries, budget_bpv, fixed_bits=fixed_bits,
                            fixed_numel=fixed_numel, scorer=scorer,
                            progress=progress)
    for name, (setting, cfg) in alloc.items():
        old = plan[name]
        plan[name] = Resolved(
            Quantize(cfg, method=old.action.method,
                     solver=old.action.solver),
            rule=f"budget[{setting}]<-{old.rule}")
    return plan, warn_rows


def _target_entry(res: Resolved, spec, W) -> dict:
    """JSON-able per-target report row."""
    r, c = W.shape[-1], W.shape[-2]
    action = res.action
    entry: dict[str, Any] = {
        "rule": res.rule, "numel": int(W.numel()),
        "bpv": float(action.bpv(r, c)), "group": spec.group,
    }
    if isinstance(action, Quantize):
        entry.update(action="quantize", method=action.method,
                     d=action.cfg.d, bits_per_dim=action.cfg.bits_per_dim,
                     group_size=action.cfg.group_size)
    elif isinstance(action, IntQuant):
        entry.update(action="int_quant", method=action.method,
                     bits=action.bits, group_size=action.group_size)
    else:
        entry.update(action="keep_dense", reason=action.reason)
    return entry


@torch.no_grad()
def quantize_model(
    model,
    params,
    tokens: torch.Tensor,      # (n_seq, S) calibration tokens
    method: str = "gptvq",
    cfg: Any = None,           # VQConfig for gptvq; {"bits","group_size"} else
    *,
    recipe: QuantRecipe | None = None,  # declarative per-target rules
    budget_bpv: float | None = None,    # Hessian-budgeted mixed precision
    budget_scorer: str = "closed_form",  # or "refit" (validation oracle)
    hessian_mesh=None,         # a DeviceMesh: data-parallel capture
    hessian_mesh_axis: str = "data",
    pack: bool = False,        # True -> VQLinear leaves (serving format)
    chunk: int = 8,            # calibration sequences per forward chunk
    quantize_attn: bool = True,   # deprecated: use a recipe rule instead
    quantize_mlp: bool = True,    # deprecated: use a recipe rule instead
    seed: int = 0,
    progress: Callable[[str], None] | None = None,
    telemetry=None,
):
    """Quantize a model of a ported family. Returns (new_params, report).

    Resolves a per-target plan from the recipe (or from the legacy
    ``method`` / ``cfg`` pair via ``QuantRecipe.from_legacy``), optionally
    rewrites its Quantize entries with the budget allocator's choices
    (``budget_bpv``), then runs three passes per block through the family's
    adapter: (1) Hessian capture for the taps the plan needs, (2)
    per-target application of the resolved action, (3) advancing the
    activations through the quantized block. Runs on the device of
    ``params``. ``telemetry`` (an ``obs.Telemetry``) adds the stage spans
    and the ``quant_stage`` / ``quant_target`` events.

    With ``hessian_mesh`` set, Hessian accumulation (the budget pre-pass
    and pass 1) shards calibration rows across the mesh's
    ``hessian_mesh_axis`` ranks and merges the partial sums with one
    all-reduce a tap call; every rank then quantizes on the same merged
    Hessians."""
    legacy = recipe is None
    if not legacy and (method != "gptvq" or cfg is not None):
        raise ValueError(
            "pass either a recipe or the legacy (method, cfg) pair — "
            "explicit method/cfg would be silently ignored alongside "
            "recipe=")
    if legacy:
        if not (quantize_attn and quantize_mlp):
            warnings.warn(
                "quantize_attn/quantize_mlp are deprecated; pass a "
                "QuantRecipe with keep_dense rules instead",
                DeprecationWarning, stacklevel=2)
        if cfg is None:
            cfg = (VQConfig()
                   if method in ("gptvq", "kmeans", "kmeans_data")
                   else {"bits": 4, "group_size": 128})
        recipe = QuantRecipe.from_legacy(
            method, cfg, quantize_attn=quantize_attn,
            quantize_mlp=quantize_mlp)
    full_fp32_matmuls()  # params may come from anywhere: enforce it here too
    t0 = time.time()
    stage_seconds: dict[str, float] = {}
    sync = (torch.cuda.synchronize if tokens.device.type == "cuda"
            else lambda: None)

    @contextlib.contextmanager
    def _stage(name: str, block: str | None = None):
        ts = time.perf_counter()
        with contextlib.ExitStack() as spans:
            if telemetry is not None:
                # nested spans -> "span.quant/<stage>" flame-graph paths
                spans.enter_context(telemetry.spans.span("quant"))
                spans.enter_context(telemetry.spans.span(name))
            yield
            sync()  # inside the spans: they time the device work too
        dt = time.perf_counter() - ts
        stage_seconds[name] = stage_seconds.get(name, 0.0) + dt
        if telemetry is not None and block is not None:
            telemetry.events.emit("quant_stage", stage=name, block=block,
                                  seconds=dt)

    adapter = adapters.get_adapter(model, params)
    gen = torch.Generator(device=tokens.device).manual_seed(seed)

    n_seq = tokens.shape[0]
    chunks = [tokens[i:i + chunk] for i in range(0, n_seq, chunk)]

    blocks = adapter.blocks()
    plan = recipe.resolve(_collect_targets(blocks))
    _check_plan(blocks, plan)
    report_warnings: list[str] = []
    if budget_bpv is not None:
        with _stage("budget_prepass"):
            diag, missed = _budget_prepass(
                adapter, chunks, plan, progress, mesh=hessian_mesh,
                mesh_axis=hessian_mesh_axis)
        with _stage("budget_allocate"):
            plan, report_warnings = _allocate(
                blocks, plan, diag, missed, budget_bpv, progress,
                scorer=budget_scorer)

    states = [adapter.calib_state(c, ci) for ci, c in enumerate(chunks)]
    report_rows = []
    per_target: dict[str, dict] = {}
    for bi, blk in enumerate(blocks):
        prefix = blk.prefix
        specs = blk.targets()
        resolved = {spec.name: plan[f"{prefix}.{spec.name}"]
                    for spec in specs}
        blk_stage = lambda name: _stage(name, blk.name)  # noqa: B023

        # ---- pass 1: Hessian taps the plan needs --------------------------
        needed = frozenset(
            spec.group for spec in specs
            if resolved[spec.name].needs_hessian and spec.tap is not None)
        taps: dict = {}
        if needed:
            with _stage("hessian_capture", blk.name), \
                    contextlib.ExitStack() as capture:
                if hessian_mesh is not None:
                    capture.enter_context(adapters.hessian_mesh(
                        hessian_mesh, hessian_mesh_axis))
                for st in states:
                    taps = blk.capture(st, taps, needed)

        # ---- pass 2: apply each target's resolved action ------------------
        new_block = blk.params()
        row = {"layer": bi, "block": blk.name}
        for spec in specs:
            res = resolved[spec.name]
            name = f"{prefix}.{spec.name}"
            W = adapters.tree_get(new_block, spec.path)
            entry = _target_entry(res, spec, W)
            if isinstance(res.action, KeepDense):
                per_target[name] = entry
                continue
            tap = taps.get(spec.tap) if spec.tap is not None else None
            if res.needs_hessian and spec.tap is not None and tap is None:
                # an adapter bug: capture never accumulated what targets()
                # promised
                raise KeyError(
                    f"block {blk.name!r}: Hessian tap {spec.tap!r} for "
                    f"target {spec.name!r} was never captured")
            t_tgt = time.perf_counter()
            if spec.per_expert:
                leaf, err = _quantize_expert_stack(
                    W, tap, res.action, gen, pack, res.rule, blk_stage)
            else:
                H = hes.finalize(tap) if tap is not None else None
                q, packed = _apply_action(W, H, res.action, gen, blk_stage)
                if packed is not None:
                    packed = dataclasses.replace(packed, rule=res.rule)
                leaf = packed if (pack and packed is not None) else q
                err = _recon_error(W, q, H)
            if telemetry is not None:
                telemetry.events.emit(
                    "quant_target", name=name, action=entry["action"],
                    seconds=time.perf_counter() - t_tgt)
            new_block = adapters.tree_set(new_block, spec.path, leaf)
            row[spec.name] = err
            entry["error"] = err
            per_target[name] = entry
        blk.install(new_block)

        # ---- pass 3: advance activations through the quantized block ------
        with _stage("advance", blk.name):
            states = [blk.advance(st) for st in states]
        if progress:
            progress(f"block {bi + 1}/{len(blocks)} [{blk.name}] done")
        report_rows.append(row)

    new_params = adapter.finalize()
    achieved = weighted_bpv(
        (e["numel"], e["bpv"]) for e in per_target.values())
    if legacy and budget_bpv is None:
        # uniform legacy accounting: the nominal per-tensor formula
        bpv = cfg.bits_per_value if isinstance(cfg, VQConfig) else (
            cfg["bits"] + 16.0 / cfg["group_size"])
        label = method
    else:
        bpv = achieved
        label = f"recipe:{recipe.name}" if recipe.name else "recipe"
    return new_params, QuantizeReport(
        report_rows, time.time() - t0, label, bpv,
        per_target=per_target, achieved_bpv=achieved,
        recipe=recipe.to_json(), stage_seconds=stage_seconds,
        warnings=report_warnings)
