"""Quantization launcher (port of ``repro/launch/quantize.py``): run the GPTVQ
pipeline over a model, then evaluate the packed model through the fused
VQ-dequant matmul.

Runs on ``cuda`` unless ``--device cpu``. The fp perplexity is taken on the
dense model; the vq perplexity on the packed model after
``prepare_fused_tree``, so every quantized matmul goes through the
``vq_dequant_matmul`` kernel on the card.

  PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama2-7b \
      --smoke --device cpu

Not ported yet: ``--out`` (checkpoint writing; ROADMAP.md queue 1,
"checkpoint/checkpointer.py"), the budget, solver, mesh and telemetry flags.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS, SMOKE
from repro_torch.core import vq_linear as vql_mod
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import PRESET_RECIPES, QuantRecipe, get_recipe
from repro_torch.data.calibration import calibration_tokens, shard_for_worker
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
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
                    help="preset name (%s); overrides --setting"
                         % ", ".join(sorted(PRESET_RECIPES)))
    ap.add_argument("--sequences", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--em-iters", type=int, default=None,
                    help="override em_iters on every quantize action "
                         "(default: 25 for --setting)")
    ap.add_argument("--update-iters", type=int, default=None,
                    help="override codebook_update_iters likewise "
                         "(default: 10 for --setting)")
    ap.add_argument("--out", default=None,
                    help="checkpoint directory (not ported yet)")
    ap.add_argument("--worker", type=int, default=0)
    ap.add_argument("--n-workers", type=int, default=1)
    args = ap.parse_args(argv)
    if args.out is not None:
        raise NotImplementedError(
            "--out: checkpoint writing is not ported yet (ROADMAP.md queue 1, "
            "'checkpoint/checkpointer.py')")
    device = resolve_device(args.device)

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
    print(f"arch={cfg.name} recipe={recipe.name or 'custom'} "
          f"calib={tuple(calib.shape)} device={device}")

    ppl_fp = perplexity(model, params, heldout)
    t0 = time.time()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda msg: print(f"  {msg}", flush=True))
    dt = time.time() - t0
    ppl_vq = perplexity(model, vql_mod.prepare_fused_tree(qparams), heldout)
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
    dense = [k for k, v in rep.per_target.items()
             if v["action"] == "keep_dense"]
    if dense:
        print(f"  kept dense ({len(dense)}): {', '.join(dense[:6])}"
              + (" ..." if len(dense) > 6 else ""))
    return rep, ppl_fp, ppl_vq


if __name__ == "__main__":
    main()
