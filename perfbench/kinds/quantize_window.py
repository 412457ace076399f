"""A quantizer measured over a window: the program's GPTVQ pipeline
(``repro_torch.core.pipeline.quantize_model``) compresses a model block by
block, and the window counts the matrices it finishes.

A run: the dense weights (``perfbench/models/<arch>.py``) and the
calibration ids (``perfbench/inputs.py``) are made from the seed on the
device; warm-up quantizes a throwaway one-layer copy at the cell's widths
(every target shape, one calibration chunk); then the window opens as
``quantize_model`` starts (block 0's capture) and lasts ``seconds``. Each
finished target is stamped from the pipeline's ``quant_target`` telemetry
event, each stage from its ``quant_stage`` event (stages synchronise the
device). The pipeline is stopped, through its ``progress`` callback, at
the end of the block in progress when the window closes; with ``trace``
the next block runs on, and the profiler covers the target after the
mix's ``slice_after`` (the first expert stack, 128 experts' GPTVQ), then
the run stops.

The harness watches the pipeline through the adapter contract that the
pipeline drives (``repro_torch.core.adapters``: ``BlockAdapter.capture``
returns a block's Hessian taps, ``install`` receives its packed block):
it keeps each finished block's packed matrices and the Hessians of the
sampled taps. Then the program's state is freed and the plain reference
judges every finished block (``perfbench/quant_judge.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from perfbench import inputs, models, quant_judge, trace as tracing

now = time.perf_counter


class _Stop(Exception):
    """Raised from the pipeline's progress callback to end the run."""


@dataclasses.dataclass
class QuantRun:
    cfg: dict
    mix: dict
    setup_s: float
    t_open: float
    seconds: float
    targets: list               # (t, name, weights) of each finished target
    stages: list                # (t_end, stage, block, seconds)
    blocks: list                # the finished blocks the judge reads
    slice_targets: list         # the targets the profile covers (traced)
    trace: object
    memory_peak_bytes: int
    device_kind: str
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.seconds

    def in_window(self, t) -> bool:
        return self.t_open < t <= self.t_open + self.seconds

    def window_targets(self) -> list:
        return [x for x in self.targets if self.in_window(x[0])]

    def window_stages(self, stage: str) -> list:
        return [x for x in self.stages
                if x[1] == stage and self.in_window(x[0])]


def _leaf(v) -> dict:
    """A packed matrix (the program's ``VQLinear``) as plain tensors."""
    return {"words": v.words, "codebooks": v.codebooks,
            "cb_scale": v.cb_scale, "r": v.r, "c": v.c, "d": v.d, "k": v.k,
            "group_cols": v.group_cols, "rows_per_band": v.rows_per_band,
            "scale_block": v.scale_block}


class Watch:
    """Keeps what each finished block's capture and install hand over."""

    def __init__(self, targets: list, n_experts: int, n_sample: int,
                 seed: int):
        self.targets, self.seed = targets, seed
        self.n_experts, self.n_sample = n_experts, n_sample
        self.blocks: list = []

    def adapter(self, adapter):
        blocks = adapter.blocks

        def wrapped():
            out = blocks()
            for b in out:
                self._block(b)
            return out

        adapter.blocks = wrapped
        return adapter

    def _block(self, blk):
        from repro_torch.core import hessian as hes

        last = {}
        capture, install = blk.capture, blk.install

        def cap(state, taps, groups):
            last["taps"] = capture(state, taps, groups)
            return last["taps"]

        def inst(new):
            install(new)
            taps = last.pop("taps", {})
            picked = quant_judge.sample_experts(
                self.n_experts, self.n_sample, self.seed, len(self.blocks))
            H = {t: hes.finalize(taps[t]).clone()
                 for t in ("attn_in", "attn_out_in")}
            for tap in ("experts_in", "experts_out"):
                Hs, n = taps[tap]
                for e in picked:
                    H[f"{tap}.{e}"] = (Hs[e] / n[e].clamp(min=1.0)).clone()
            leaves = {}
            for t in self.targets:
                group, name = t.split(".")
                leaves[t] = _leaf(new[group][name])
            self.blocks.append({"leaves": leaves, "hessians": H})

        blk.capture, blk.install = cap, inst


def _recipe(quant: dict):
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.recipe import QuantRecipe

    return QuantRecipe.uniform(
        PAPER_SETTINGS[quant["setting"]], name=quant["setting"]
    ).with_quantize_overrides(
        em_iters=quant["em_iters"],
        codebook_update_iters=quant["codebook_update_iters"])


def _warm_up(cfg, arch, raw, ids, mix, recipe, device):
    """One throwaway layer at the cell's widths, ``warm_experts`` experts
    (every target shape), one calibration chunk."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.models.model_zoo import build

    E = mix["warm_experts"]
    pcfg = dataclasses.replace(arch.port_config(cfg), n_layers=1,
                               n_experts=E, n_experts_active=min(
                                   E, arch.dims(cfg)["K"]))
    params = arch.port_params(dict(cfg, num_hidden_layers=1), raw)
    ffn = params["layers"][0]["ffn"]
    params["layers"][0]["ffn"] = {
        "router": ffn["router"][:, :E].contiguous(),
        **{w: ffn[w][:E].contiguous() for w in ("w_in", "w_gate", "w_out")}}
    quantize_model(build(pcfg), params, ids[:mix["chunk"]], recipe=recipe,
                   pack=True, chunk=mix["chunk"], seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> QuantRun:
    from repro_torch.core import adapters
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.models.model_zoo import build
    from repro_torch.obs.telemetry import Telemetry

    cfg, mix = cell.config, cell.mix
    arch = models.get(cfg)
    quant = cfg["quantization"]
    marks = {"imports": now()}
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild

        kbuild.build_all()
    marks["build"] = now()
    raw = arch.weights(cfg, seed, device)
    ids = inputs.calibration(mix, cfg["vocab_size"], seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["inputs"] = now()
    recipe = _recipe(quant)
    _warm_up(cfg, arch, raw, ids, mix, recipe, device)
    marks["warm-up"] = now()
    model = build(arch.port_config(cfg))
    params = arch.port_params(cfg, raw)
    sizes = arch.target_weights(cfg)
    targets, stages = [], []
    tel = Telemetry(enabled=True)
    emit = tel.events.emit

    watch = Watch(quant["targets"], arch.dims(cfg)["E"],
                  mix["check_experts"], seed)
    state = {"armed": False, "cm": None, "holder": None, "slice": None}

    def on_event(event, **f):
        emit(event, **f)
        if event == "quant_stage":
            stages.append((now(), f["stage"], f["block"], f["seconds"]))
            return
        if event != "quant_target":
            return
        name = f["name"]
        targets.append((now(), name, sizes[name.split(".", 2)[2]]))
        if state["cm"] is not None:            # the profiled stack ended
            state["slice"].append(name)
            state["cm"].__exit__(None, None, None)
            raise _Stop
        if state["armed"] and name.endswith(mix["slice_after"]):
            state["slice"] = []
            state["cm"] = tracing.profiled()
            state["holder"] = state["cm"].__enter__()

    tel.events.emit = on_event
    gc.collect()

    def progress(msg: str):
        if not msg.startswith("block ") or now() - t_open < seconds:
            return
        if not trace:
            raise _Stop
        state["armed"] = True

    real_get = adapters.get_adapter
    adapters.get_adapter = lambda m, p: watch.adapter(real_get(m, p))
    t_open = now()
    try:
        quantize_model(model, params, ids, recipe=recipe, pack=True,
                       chunk=mix["chunk"], seed=seed % (2 ** 63),
                       progress=progress, telemetry=tel)
    except _Stop:
        pass
    finally:
        adapters.get_adapter = real_get
    t_end = now()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    holder = state["holder"]
    result = QuantRun(
        cfg=cfg, mix=mix, setup_s=t_open - t_start, t_open=t_open,
        seconds=seconds, targets=targets, stages=stages,
        blocks=watch.blocks, slice_targets=state["slice"] or [],
        trace=holder.summary if holder is not None else None,
        memory_peak_bytes=memory_peak,
        device_kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"))
    result.attempted = len(result.window_targets())
    del model, params, raw, ids, tel, watch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = now()
    checked = result.blocks
    if checked:
        raw = arch.weights(cfg, seed, device)
        ids = inputs.calibration(mix, cfg["vocab_size"], seed, device)
        verdict = quant_judge.judge(cfg, raw, ids, checked,
                                    mix["check_experts"], seed)
        del raw, ids
    else:
        verdict = {"hessian_gap_max": None, "leaf_error_max": None,
                   "layout_mismatches": None}
    prev = t_start
    result.notes = {"setup_s": {}}
    for k, t in marks.items():
        result.notes["setup_s"][k] = round(t - prev, 3)
        prev = t
    result.notes.update(
        window_s=seconds, run_s=round(t_end - t_open, 3),
        targets_in_window=result.attempted,
        blocks_finished=len(checked), slice_targets=result.slice_targets,
        block_ends_s=[round(t - t_open, 3) for t, st, *_ in stages
                      if st == "advance"],
        window_stage_s={st: round(sum(x[3] for x in result.window_stages(
            st)), 3) for st in sorted({x[1] for x in stages})},
        trace_bytes=holder.trace_bytes if holder is not None else 0,
        reference_s=round(now() - t_ref, 3),
        **{k: verdict.get(k) for k in ("worst_tap", "worst_matrix", "taps",
                                       "matrices")})
    lim = cell.limits
    result.checks = {
        "layout_mismatches": {"value": verdict["layout_mismatches"],
                              "limit": 0},
        "hessian_gap_max": {"value": verdict["hessian_gap_max"],
                            "limit": lim["hessian_gap_max"]},
        "leaf_error_max": {"value": verdict["leaf_error_max"],
                           "limit": lim["leaf_error_max"]}}
    result.correct = all(c["value"] is not None and c["value"] <= c["limit"]
                         for c in result.checks.values())
    return result


def _altered(blocks: list, how: str) -> list:
    """The finished blocks with every packed matrix changed: "codes" flips
    each 4-bit code's low bit (an answer altered where it is produced),
    "int4" rounds each codebook to 4 bits on its own scale (the step below
    the configuration's int8 codebooks)."""
    out = []
    for blk in blocks:
        leaves = {}
        for t, v in blk["leaves"].items():
            v = dict(v)
            if how == "codes":
                v["words"] = v["words"] ^ 0x11111111
            else:
                cb = v["codebooks"].to(torch.float32) * v["cb_scale"][
                    ..., None, None]
                amax = cb.abs().amax(dim=(-2, -1), keepdim=True)
                s = torch.where(amax == 0, torch.ones_like(amax), amax / 7)
                v["codebooks"] = (torch.clamp(torch.round(cb / s), -8, 7)
                                  * s / v["cb_scale"][..., None, None]
                                  ).round().clamp(-128, 127).to(torch.int8)
            leaves[t] = v
        out.append({"leaves": leaves, "hessians": blk["hessians"]})
    return out


def control(cell, run, seed: int, device) -> dict:
    """The control's readings on a finished run: each sampled tap's
    Hessian gap with the reference's operands in float8 e4m3, against the
    float32 reference (``quant_judge.control_gaps``); beside it the
    judge's numbers with the program's codebooks rounded to int4, and with
    its codes altered."""
    cfg, mix = cell.config, cell.mix
    raw = models.get(cfg).weights(cfg, seed, device)
    ids = inputs.calibration(mix, cfg["vocab_size"], seed, device)
    n = mix["check_experts"]
    gaps = quant_judge.control_gaps(cfg, raw, ids, run.blocks, n, seed)
    out = {"program_hessian_gap_max": run.checks["hessian_gap_max"]["value"],
           "program_leaf_error_max": run.checks["leaf_error_max"]["value"],
           "control_hessian_gap_max": max(gaps),
           "control_hessian_gap_min": min(gaps), "taps": len(gaps)}
    for how in ("int4", "codes"):
        v = quant_judge.judge(cfg, raw, ids, _altered(run.blocks, how), n,
                              seed)
        out[f"{how}_leaf_error_max"] = v["leaf_error_max"]
        out[f"{how}_hessian_gap_max"] = v["hessian_gap_max"]
    return out
