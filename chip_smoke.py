#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  1. device   — the card's name and power limit; no CUDA device is an error.
  2. build    — compile every kernel of the path (one nvcc per source, in
                parallel) into build/repro_torch/.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes, with its tolerance, its time, the
                plain version's time, one PyTorch library call's time and
                the least time the card could take (bound).
  4. small    — the whole path on the SKILL smoke config, on the card and
                on the CPU (plain versions), held against each other.
  5. main     — the port's main path at Llama-2-7B full width with depth cut
                to 2 layers (random weights from seed 0): calibration
                tokens, fp perplexity, GPTVQ quantize_model at 2.25bpv_2d
                (em_iters 25, update_iters 10, pack=True), then the packed
                model's perplexity through prepare_fused_tree (every
                quantized matmul in the vq_dequant_matmul kernel). Launch
                counts are zeroed just before and read just after. Then
                teacher-forced logits of the fused form against the
                dequant_tree (gather) form.
Then it prints the kernel JSON line, the card line and, last,
{"ok": true, "device": {...}}. Per-shape results go to
chiprun_out/chip_smoke.json. The profiler pass over the quantize path is
``python -m repro_torch.launch.profile_quantize``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FP32 (non-tensor-core) FLOP/s — the kernels do their arithmetic in FP32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# 2.25bpv_2d on the Llama-2-7B projections: d=2, k=16, 256-column groups of
# 4 rows; (N, K) per layer shape
VQ_D, VQ_K, VQ_GROUP_COLS, VQ_ROWS_PER_BAND = 2, 16, 256, 4
MATMUL_SHAPES = {"wq": (4096, 4096), "w1": (11008, 4096), "w2": (4096, 11008)}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Failed(Exception):
    pass


def phase_device(torch):
    t0 = time.perf_counter()
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{time.perf_counter() - t0:.2f}s")
    log(f"[device] nvidia-smi: {smi}")
    return dev, name, smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all(force=True)
    for name, rep in report.items():
        used = [ln.strip() for ln in rep["ptxas"].splitlines()
                if "Used" in ln or "spill" in ln]
        log(f"[build] {name}.cu {rep['seconds']:.1f}s")
        for ln in used:
            log(f"[build]   {ln}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.1f}s")


def check_assign(torch, dev, B: int, n: int, label: str) -> dict:
    from repro_torch.core.codebook import weighted_distances
    from repro_torch.kernels.vq_assign import vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(B * 1000 + n)
    d, k = VQ_D, VQ_K
    x = torch.randn((B, n, d), generator=g, device=dev)
    hw = torch.rand((n, d), generator=g, device=dev) + 0.1
    cb = torch.randn((B, k, d), generator=g, device=dev)
    idx_k = vq_assign(x, hw, cb)
    idx_p = vq_assign_plain(x, hw, cb)
    torch.cuda.synchronize()
    diff = x[:, :, None, :] - cb[:, None, :, :]
    dist = torch.sum(hw[None, :, None, :] * diff * diff, dim=-1)
    dk = torch.gather(dist, 2, idx_k.long()[..., None])[..., 0]
    dp = torch.gather(dist, 2, idx_p.long()[..., None])[..., 0]
    # argmin outputs: hold the chosen weighted distances, not the indices
    # (a near-tie may flip an index); same f32 sum, FMA contraction aside
    abs_err = float((dk - dp).abs().max())
    err = float(((dk - dp).abs() / (1 + dp.abs())).max())
    tol = 1e-5
    ms = time_ms(torch, lambda: vq_assign(x, hw, cb))
    plain_ms = time_ms(torch, lambda: vq_assign_plain(x, hw, cb))
    lib_ms = time_ms(torch, lambda: torch.argmin(
        weighted_distances(x, hw, cb), dim=-1))
    nbytes = 4 * (x.numel() + hw.numel() + cb.numel() + B * n)
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * n * k * d)
    row = {"name": "vq_assign", "shape": label, "B": B, "n": n, "d": d,
           "k": k, "max_abs_err": abs_err, "max_rel_err": err, "tol": tol,
           "index_agreement": float((idx_k == idx_p).float().mean()),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] vq_assign {label} B={B} n={n}: chosen-distance max abs "
        f"err {abs_err:.2e}, rel err {err:.2e} (tol {tol:.0e}), index agreement "
        f"{row['index_agreement']:.6f} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, argmin(expanded) {lib_ms:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by})")
    if not err <= tol:
        raise Failed(f"vq_assign {label}: error {err} > {tol}")
    return row


def check_matmul(torch, dev, layer: str, M: int, scale_block: int) -> dict:
    from repro_torch.kernels.vq_dequant_matmul import (
        reconstruct, vq_dequant_matmul, vq_dequant_matmul_plain)

    N, K = MATMUL_SHAPES[layer]
    d, k = VQ_D, VQ_K
    n_cg, n_bands = K // VQ_GROUP_COLS, N // VQ_ROWS_PER_BAND
    g = torch.Generator(device=dev).manual_seed(N + K + M + scale_block)
    words = torch.randint(-2**31, 2**31 - 1, (N, K // d // 8),
                          generator=g, device=dev, dtype=torch.int32)
    cb = torch.randn((n_cg, n_bands, k, d), generator=g, device=dev) * 0.05
    scales = None
    if scale_block:
        scales = torch.rand((N, K // scale_block), generator=g,
                            device=dev) + 0.5
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(d=d, code_bits=4, rows_per_band=VQ_ROWS_PER_BAND,
              group_cols=VQ_GROUP_COLS, scale_block=scale_block)
    y = vq_dequant_matmul(x, words, cb, scales, k_c=k, **kw)
    ref = vq_dequant_matmul_plain(x, words, cb, scales, **kw)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    ms = time_ms(torch, lambda: vq_dequant_matmul(x, words, cb, scales,
                                                  k_c=k, **kw))
    plain_ms = time_ms(torch, lambda: vq_dequant_matmul_plain(
        x, words, cb, scales, **kw))
    W = reconstruct(words, cb, scales, **kw)
    xf = x.float()
    lib_ms = time_ms(torch, lambda: torch.matmul(xf, W.T))
    nbytes = (x.numel() * x.element_size() + words.numel() * 4
              + cb.numel() * 4 + (scales.numel() * 4 if scale_block else 0)
              + M * N * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K)
    row = {"name": "vq_dequant_matmul", "shape": layer, "M": M, "N": N,
           "K": K, "scale_block": scale_block, "max_abs_err": err,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] vq_dequant_matmul {layer} M={M} N={N} K={K} "
        f"sb={scale_block}: max abs err {err:.2e} (tol {tol:.2e}), max rel "
        f"{err / max(float(ref.abs().max()), 1e-30):.2e} | kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, torch.matmul(x, W.T) {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        raise Failed(f"vq_dequant_matmul {layer} M={M} sb={scale_block}: "
                     f"error {err} > {tol}")
    return row


def phase_kernels(torch, dev) -> list[dict]:
    t0 = time.perf_counter()
    rows = []
    for label, B, n in (("em", 1024, 512), ("em", 2752, 512),
                        ("sweep", 1024, 4), ("sweep", 2752, 4)):
        rows.append(check_assign(torch, dev, B, n, label))
    for layer in MATMUL_SHAPES:
        for M in (1, 4, 512):
            for sb in (0, 32):
                rows.append(check_matmul(torch, dev, layer, M, sb))
    log(f"[kernels] {len(rows)} checks passed in "
        f"{time.perf_counter() - t0:.1f}s")
    return rows


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_small(torch, dev) -> dict:
    """The whole path on a small input, on the card and on the CPU (where
    every kernel runs its plain version): the SKILL smoke config in f32,
    same weights and tokens. f32 sums in another order can flip a near-tie
    in the sweep, which feeds a different error forward, so the packed
    codes must agree on >= 90% of spans and per-target errors within 10%;
    the packed model's logits must be finite."""
    from repro_torch.configs import SMOKE
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import model_zoo

    t0 = time.perf_counter()
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=2, d_model=64,
                                    vocab_size=256, max_seq_len=64)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    calib = torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"]).with_quantize_overrides(
            em_iters=8, codebook_update_iters=4)
    out = {}
    for where in ("cpu", dev):
        q, rep = quantize_model(model, _to(params, where), calib.to(where),
                                recipe=recipe, pack=True)
        logits = model.forward(vql_mod.prepare_fused_tree(q),
                               {"tokens": tokens.to(where)})[0]
        codes = torch.cat([vql_mod.unpack_indices(leaf).flatten().cpu()
                           for lp in q["layers"]
                           for sub in (lp["attn"], lp["ffn"])
                           for leaf in sub.values()])
        out[str(where)] = ({k: e["error"] for k, e in rep.per_target.items()},
                           codes, logits)
    (err_c, codes_c, _), (err_g, codes_g, lg_g) = out["cpu"], out[str(dev)]
    worst = max(abs(err_g[k] - err_c[k]) / err_c[k] for k in err_c)
    agree = float((codes_g == codes_c).float().mean())
    finite = bool(torch.isfinite(lg_g).all())
    log(f"[small] smoke config on {dev} vs cpu: codes agree on "
        f"{agree:.4f} of spans (tol 0.9), worst per-target error ratio "
        f"{worst:.2e} (tol 0.1), logits finite {finite} | "
        f"{time.perf_counter() - t0:.1f}s")
    if not (agree >= 0.9 and worst <= 0.1 and finite):
        raise Failed("small-input check of the CUDA path against the CPU")
    return {"code_agreement": agree, "worst_error_ratio": worst}


def phase_main(torch, dev) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.train.loss import perplexity

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    log(f"[main] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers}, "
        f"dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=16, seq_len=64,
                               device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=8, seq_len=64,
                                 seed=777, device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(em_iters=25, codebook_update_iters=10)

    vq_assign.launches = 0
    vq_dequant_matmul.launches = 0
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[main]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = vql_mod.prepare_fused_tree(qparams)
    ppl_vq = perplexity(model, fused, heldout)
    t["ppl_vq"] = time.perf_counter() - t0
    launches = {"vq_assign": vq_assign.launches,
                "vq_dequant_matmul": vq_dequant_matmul.launches}
    packed = sum(leaf.payload_bytes() for lp in fused["layers"]
                 for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    dense = sum(w.numel() * w.element_size() for lp in params["layers"]
                for sub in (lp["attn"], lp["ffn"]) for w in sub.values())

    log(f"[main] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.4f} bpv")
    for name, e in rep.per_target.items():
        log(f"[main]   {name}: error {e['error']:.5f} bpv {e['bpv']:.4f}")
    log("[main] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[main] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[main] launches in the main path: {launches}")
    log(f"[main] quantized weights streamed per forward: {packed / 2**20:.1f}"
        f" MiB packed (words + f32 codebooks) vs {dense / 2**20:.1f} MiB "
        f"dense {cfg.dtype}")

    with torch.no_grad():
        lf = model.forward(fused, {"tokens": heldout})[0]
        lg = model.forward(qparams, {"tokens": heldout})[0]
    dl = (lf - lg).float()
    max_d, rms_d = float(dl.abs().max()), float(dl.pow(2).mean().sqrt())
    # tolerance: the gather form rounds the dequantized W and every matmul
    # output to bf16 (relative 2^-9); over 2 layers that moves logits of
    # unit scale by ~1e-2 RMS. A wrong code, band or scale moves them O(1).
    max_tol, rms_tol = 0.5, 0.05
    log(f"[main] fused vs gather logits {tuple(lf.shape)}: max |diff| "
        f"{max_d:.4e} (tol {max_tol}), RMS {rms_d:.4e} (tol {rms_tol})")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] max_memory_allocated {peak / 2**30:.2f} GiB")

    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits shape": tuple(lf.shape) == (8, 64, cfg.padded_vocab),
        "logits finite": bool(torch.isfinite(lf).all()),
        "fused vs gather": max_d <= max_tol and rms_d <= rms_tol,
        "bpv": abs(rep.achieved_bpv - 2.25) < 1e-9,
        "vq_assign launched": launches["vq_assign"] > 0,
        "vq_dequant_matmul launched": launches["vq_dequant_matmul"] > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"main path checks failed: {bad}")
    return {"launches": launches, "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv,
            "per_target": rep.per_target, "stage_seconds": rep.stage_seconds,
            "seconds": t, "logit_max_diff": max_d, "logit_rms_diff": rms_d,
            "packed_bytes": packed, "dense_bytes": dense,
            "max_memory_allocated": peak}


def kernel_line(rows: list[dict], launches: dict) -> dict:
    """One entry per kernel, at the shape the main path launches most:
    vq_dequant_matmul at the eval's M=512 on a 4096x4096 projection,
    vq_assign at the span sweep's B=1024, n=4."""
    pick = {
        "vq_dequant_matmul": (
            lambda r: r["shape"] == "wq" and r["M"] == 512
            and r["scale_block"] == 0,
            "src/repro_torch/kernels/csrc/vq_dequant_matmul.cu",
            "src/repro/kernels/vq_dequant_matmul.py:137"),
        "vq_assign": (
            lambda r: r["shape"] == "sweep" and r["B"] == 1024,
            "src/repro_torch/kernels/csrc/vq_assign.cu",
            "src/repro/kernels/vq_assign.py:37"),
    }
    out = []
    for name, (sel, source, replaces) in pick.items():
        r = next(r for r in rows if r["name"] == name and sel(r))
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches.get(name, 0),
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return {"kernels": out}


def main() -> int:
    out_dir = os.path.join(ROOT, "chiprun_out")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    dev, name, smi = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch, dev)
    small_res = phase_small(torch, dev)
    main_res = phase_main(torch, dev)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "chip_smoke.json")
    with open(out, "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": rows,
                   "small": small_res, "main": main_res}, f, indent=1,
                  default=str)
    log(f"[done] {time.perf_counter() - t_all:.1f}s; details in {out}")
    print(json.dumps(kernel_line(rows, main_res["launches"])))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
