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

Not ported yet: budgeted mixed precision and the int/kmeans actions
(ROADMAP.md queue 1, "Budgets and solvers") and mesh-sharded Hessian
capture ("Multi-device and training"); those arguments raise when set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core import adapters
from repro_torch.core import hessian as hes
from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.bpv import weighted_bpv
from repro_torch.core.codebook_compress import codebook_update, quantize_codebooks
from repro_torch.core.gptvq import gptvq_quantize_matrix, layer_error
from repro_torch.core.recipe import (
    KeepDense,
    QuantRecipe,
    Quantize,
    Resolved,
    TargetInfo,
)
from repro_torch.device import full_fp32_matmuls


@dataclasses.dataclass
class QuantizeReport:
    per_layer: list     # one row per block: {"layer", "block", target: err}
    total_seconds: float
    # per canonical target: {"action", "rule", "bpv", "numel", "error", ...}
    per_target: dict
    achieved_bpv: float     # numel-weighted model-wide bpv, overhead incl.
    recipe: str             # the recipe's name
    # seconds per pipeline stage (hessian_capture, em_init, column_sweep,
    # codebook_update, advance); each stage synchronizes the device on exit
    stage_seconds: dict

    def total_error(self) -> float:
        """Summed Hessian-weighted reconstruction error over all targets."""
        return float(sum(
            v for row in self.per_layer for k, v in row.items()
            if k not in ("layer", "block")))


def _null_stage(name):
    return contextlib.nullcontext()


def _apply_action(W_io, H, action, generator=None, stage=_null_stage):
    """W_io: (in, out) kernel, H its input Hessian. Returns
    (fake-quant (in, out), VQLinear)."""
    if not isinstance(action, Quantize) or action.method != "gptvq":
        raise NotImplementedError(
            f"action {action!r} is not ported yet (ROADMAP.md queue 1, "
            "'Budgets and solvers')")
    W = W_io.T.to(torch.float32)  # (out, in)
    cfg = action.cfg
    U = hes.inv_hessian_cholesky(H, cfg.percdamp)
    res = gptvq_quantize_matrix(W, U, cfg, generator, solver=action.solver,
                                stage=stage)
    with stage("codebook_update"):
        res = quantize_codebooks(codebook_update(res, W, H))
        packed = vql_mod.from_vq_result(res)
    return res.arrays.Q.T.to(W_io.dtype), packed


def _recon_error(W_io, q_io, H) -> float:
    """Hessian-weighted reconstruction error of one quantized matrix."""
    return float(layer_error(W_io.T.to(torch.float32),
                             q_io.T.to(torch.float32), H))


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
    else:
        entry.update(action="keep_dense", reason=action.reason)
    return entry


@torch.no_grad()
def quantize_model(
    model,
    params,
    tokens: torch.Tensor,      # (n_seq, S) calibration tokens
    *,
    recipe: QuantRecipe | None = None,
    pack: bool = False,        # True -> VQLinear leaves (serving format)
    chunk: int = 8,            # calibration sequences per forward chunk
    seed: int = 0,
    progress: Callable[[str], None] | None = None,
    budget_bpv: float | None = None,
    hessian_mesh=None,
    telemetry=None,
):
    """Quantize a model of a ported family. Returns (new_params, report).

    Resolves a per-target plan from the recipe (default: uniform GPTVQ at
    ``VQConfig()``), then runs three passes per block through the family's
    adapter: (1) Hessian capture from the current calibration activations,
    (2) per-target application of the resolved action, (3) advancing the
    activations through the quantized block. Runs on the device of
    ``params``. ``telemetry`` (an ``obs.Telemetry``) adds the stage spans
    and the ``quant_stage`` / ``quant_target`` events."""
    for name, val in (("budget_bpv", budget_bpv),
                      ("hessian_mesh", hessian_mesh)):
        if val is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP.md queue 1: "
                "'Budgets and solvers', 'Multi-device and training')")
    recipe = recipe if recipe is not None else QuantRecipe()
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
            with _stage("hessian_capture", blk.name):
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
            tap = taps.get(spec.tap)
            if tap is None:
                # an adapter bug: capture never accumulated what targets()
                # promised (every ported action needs the Hessian)
                raise KeyError(
                    f"block {blk.name!r}: Hessian tap {spec.tap!r} for "
                    f"target {spec.name!r} was never captured")
            t_tgt = time.perf_counter()
            H = hes.finalize(tap)
            q, packed = _apply_action(W, H, res.action, gen, blk_stage)
            packed = dataclasses.replace(packed, rule=res.rule)
            leaf = packed if pack else q
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
    return new_params, QuantizeReport(
        report_rows, time.time() - t0, per_target=per_target,
        achieved_bpv=achieved, recipe=recipe.name,
        stage_seconds=stage_seconds)
