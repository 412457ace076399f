"""Quantization launcher (port of ``repro/launch/quantize.py``): run the GPTVQ
pipeline over a model, evaluate the packed model through the fused
VQ-dequant matmul, and save the packed checkpoint.

Runs on ``cuda`` unless ``--device cpu``, for every ported family
(``--arch`` llama2-7b, qwen3-moe-30b-a3b, phi-3-vision-4.2b (calibrated
and evaluated on text), xlstm-125m, zamba2-7b, whisper-small (calibrated
and evaluated with the stub frontend's synthesized frames,
``adapters.calib_extras``), ...). The fp perplexity is
taken on the dense model; the vq perplexity on the packed model after
``prepare_fused_tree``, so every quantized matmul goes through the
``vq_dequant_matmul`` kernel on the card (and, past 2048 tokens, attention
through the ``flash_attention`` kernel). ``--out`` receives the packed
params (``VQLinear`` leaves) in the reference's checkpoint layout with the
reference's metadata keys; ``--events-out`` the ``quant_stage`` /
``quant_target`` JSONL events; ``--metrics-out`` the ``span.quant/*``
metrics snapshot.

``--recipe`` takes a preset name (any PAPER_SETTINGS key, or
``mixed_demo``) or a JSON recipe file; ``--budget-bpv`` turns on
Hessian-budgeted mixed precision on top of it (``--budget-scorer``: the
closed form or the refit oracle); ``--solver`` sets the sweep's solver on
every quantize action. The checkpoint metadata carries the resolved
recipe and the per-target map.

  PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama2-7b \
      --smoke --device cpu --seq-len 4096 --sequences 2 --out /tmp/ck \
      --events-out /tmp/ck_events.jsonl
  PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama2-7b \
      --smoke --device cpu --budget-bpv 2.5 --solver babai --out /tmp/ck

``--hessian-mesh N`` captures the Hessians data-parallel over N ranks
(``pipeline.quantize_model(hessian_mesh=)``): run it under ``torchrun
--nproc-per-node N``, whose world must hold N ranks. The backend follows
``launch.mesh.world_backend``'s rule and is printed: NCCL when each rank
has a card of its own (rank r on ``cuda:r``), gloo when ranks share one
card or run on the CPU. Every rank quantizes; only rank 0 writes the
checkpoint, the events and the metrics.

  torchrun --nproc-per-node 2 -m repro_torch.launch.quantize \
      --arch llama2-7b --smoke --device cpu --hessian-mesh 2 --out /tmp/ck
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS, SMOKE
from repro_torch.core import adapters
from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import PRESET_RECIPES, QuantRecipe, get_recipe
from repro_torch.data.calibration import calibration_tokens, shard_for_worker
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo
from repro_torch.obs import Telemetry
from repro_torch.train.loss import perplexity


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")
    ap.add_argument("--setting", default="2.25bpv_2d",
                    choices=sorted(PAPER_SETTINGS))
    ap.add_argument("--recipe", default=None,
                    help="preset name (%s) or recipe JSON path; overrides "
                         "--setting" % ", ".join(sorted(PRESET_RECIPES)))
    ap.add_argument("--budget-bpv", type=float, default=None,
                    help="model-wide bits-per-value budget: per-target "
                         "settings are allocated by Hessian sensitivity")
    ap.add_argument("--budget-scorer", default="closed_form",
                    choices=("closed_form", "refit"),
                    help="budget pre-pass error proxy: the O(r*c) "
                         "rate-distortion closed form (default) or the "
                         "trimmed-EM refit (validation oracle)")
    ap.add_argument("--solver", default=None,
                    choices=("gptq", "babai", "cd"),
                    help="inner sweep solver on every quantize action: "
                         "gptq (paper default), babai (full conditional "
                         "span metric), cd (+coordinate-descent "
                         "refinement)")
    ap.add_argument("--hessian-mesh", type=int, default=0,
                    help="shard Hessian accumulation data-parallel over "
                         "this many ranks (under torchrun --nproc-per-node "
                         "N; 0 = one process)")
    ap.add_argument("--sequences", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--em-iters", type=int, default=None,
                    help="override em_iters on every quantize action "
                         "(default: 25 for --setting)")
    ap.add_argument("--update-iters", type=int, default=None,
                    help="override codebook_update_iters likewise "
                         "(default: 10 for --setting)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_vq_ckpt"),
                    help="packed checkpoint directory")
    ap.add_argument("--worker", type=int, default=0)
    ap.add_argument("--n-workers", type=int, default=1)
    ap.add_argument("--events-out", default=None,
                    help="write per-stage/per-target quant_* telemetry "
                         "events as JSONL here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the span.quant/* metrics snapshot as JSON "
                         "here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.hessian_mesh > 1:
        mesh, device = hessian_mesh(args.hessian_mesh, device)
    try:
        return run(args, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def hessian_mesh(n: int, device):
    """The launched world (``torchrun``, ``n`` ranks) as a ``(data,
    model)`` mesh of n x 1, and this rank's device."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(f"--hessian-mesh {n} runs under torchrun "
                         f"--nproc-per-node {n}; this world has {world} "
                         "rank(s)")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = mesh_lib.make_production_mesh(device_type=device.type)
    print(f"hessian mesh: rank {dist.get_rank()} of {n}, backend "
          f"{dist.get_backend()}, device {device}", flush=True)
    return mesh, device


def run(args, device, mesh):
    """Quantize, evaluate and save as ``args`` say; with ``mesh``, the
    Hessians are captured over its data axis and only rank 0 writes."""
    writer = mesh is None or mesh.get_rank() == 0

    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if args.smoke:
        cfg = cfg.scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=device)

    calib = calibration_tokens(cfg.vocab_size, n_sequences=args.sequences,
                               seq_len=args.seq_len, device=device)
    calib = shard_for_worker(calib, args.worker, args.n_workers)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=8,
                                 seq_len=args.seq_len, seed=777,
                                 device=device)

    em, up = args.em_iters, args.update_iters
    if args.recipe is not None:
        recipe = get_recipe(args.recipe)
    else:
        recipe = QuantRecipe.uniform(PAPER_SETTINGS[args.setting],
                                     name=args.setting)
        em = 25 if em is None else em
        up = 10 if up is None else up
    overrides = {k: v for k, v in (("em_iters", em),
                                   ("codebook_update_iters", up))
                 if v is not None}
    if overrides:
        recipe = recipe.with_quantize_overrides(**overrides)
    if args.solver is not None:
        recipe = recipe.with_solver(args.solver)
    budget = f" budget={args.budget_bpv}bpv" if args.budget_bpv else ""
    solver = f" solver={args.solver}" if args.solver else ""
    print(f"arch={cfg.name} recipe={recipe.name or 'custom'}{budget}"
          f"{solver} calib={tuple(calib.shape)} device={device}")

    extras = adapters.calib_extras(cfg, heldout)
    ppl_fp = perplexity(model, params, heldout, batch_extra=extras)
    telemetry = Telemetry(events_out=args.events_out if writer else None)
    t0 = time.time()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, budget_bpv=args.budget_bpv,
        budget_scorer=args.budget_scorer, hessian_mesh=mesh, pack=True,
        progress=(lambda msg: print(f"  {msg}", flush=True)) if writer
        else None, telemetry=telemetry)
    dt = time.time() - t0
    ppl_vq = perplexity(model, vql_mod.prepare_fused_tree(qparams), heldout,
                        batch_extra=extras)
    print(f"quantized in {dt:.1f}s | ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} "
          f"| recon err={rep.total_error():.4f} "
          f"| achieved {rep.achieved_bpv:.3f} bpv")
    if rep.stage_seconds:
        total = sum(rep.stage_seconds.values())
        parts = "  ".join(
            f"{k}={v:.1f}s ({100 * v / max(total, 1e-9):.0f}%)"
            for k, v in sorted(rep.stage_seconds.items(),
                               key=lambda kv: -kv[1]))
        print(f"  stages: {parts}")
    for w in rep.warnings:
        print(f"  WARNING: {w}")
    if args.metrics_out and writer:
        telemetry.write_metrics(args.metrics_out)
        print(f"  metrics snapshot -> {args.metrics_out}")
    telemetry.close()
    dense = [k for k, v in rep.per_target.items()
             if v["action"] == "keep_dense"]
    if dense:
        print(f"  kept dense ({len(dense)}): {', '.join(dense[:6])}"
              + (" ..." if len(dense) > 6 else ""))

    if not writer:
        return rep, ppl_fp, ppl_vq
    ck = Checkpointer(args.out, keep=1)
    ck.save(0, qparams, metadata={
        "arch": cfg.name, "recipe": rep.recipe,
        "achieved_bpv": rep.achieved_bpv, "per_target": rep.per_target,
        "budget_bpv": args.budget_bpv, "ppl_fp": float(ppl_fp),
        "ppl_vq": float(ppl_vq), "seconds": dt,
        "stage_seconds": rep.stage_seconds, "warnings": rep.warnings,
    })
    print(f"packed checkpoint written to {args.out}")
    return rep, ppl_fp, ppl_vq


if __name__ == "__main__":
    main()
