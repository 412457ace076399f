"""Serving launcher (port of ``repro/launch/serve.py``): synthesize weights,
optionally GPTVQ-quantize them, and serve batched synthetic requests
through the paged engine.

Runs on ``cuda`` unless ``--device cpu``. The flags are the reference's;
``--paged-attn-impl`` and ``--vq-matmul-impl`` take "gather" or "fused"
(the reference's "xla" and "pallas" are both "fused" here: the CUDA kernel
on the card, its plain PyTorch version on the CPU). Every family serves
from tokens alone, as the reference's engine does: vlm without patches,
audio (``--arch whisper-small``) without frames, its cross K/V left at
the zeros its cache starts from.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --vq --device cpu --paged-attn-impl fused \
      --vq-matmul-impl fused --requests 4 --max-new 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, SMOKE
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import get_recipe
from repro_torch.data.calibration import calibration_tokens
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.attention import KVQuantSpec
from repro_torch.obs import Telemetry
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged_cache import pool_bytes_of

_IMPL_HELP = ("'fused' = the CUDA kernel on the card, its plain PyTorch "
              "version on the CPU (the reference's 'xla' and 'pallas' both "
              "map to 'fused')")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (default) or cpu")
    ap.add_argument("--vq", action="store_true",
                    help="GPTVQ-quantize before serving")
    ap.add_argument("--recipe", default="2.25bpv_2d",
                    help="recipe preset name (with --vq)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--paged-attn-impl", default="gather",
                    choices=["gather", "fused"],
                    help="decode attention over the paged KV pool: the "
                         "logical-view gather (default) or the fused "
                         "in-kernel page walk; " + _IMPL_HELP)
    ap.add_argument("--vq-matmul-impl", default="gather",
                    choices=["gather", "fused"],
                    help="execution path for VQ-packed weights: per-layer "
                         "dense dequantization (default) or the fused "
                         "VQ-dequant matmul; " + _IMPL_HELP)
    ap.add_argument("--kv-cache-bits", default=16,
                    type=lambda s: s if s == "vq2" else int(s),
                    choices=[16, 8, 4, "vq2"],
                    help="paged KV-cache storage: 16 = passthrough, 8/4 = "
                         "int8/packed-int4 pages with per-row per-kv-head "
                         "scales, vq2 = 4-bit codebook indices over d=2 "
                         "head-dim vectors (codebooks calibrated at engine "
                         "load, then frozen)")
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="radix prefix cache + refcounted copy-on-write "
                         "page tables")
    ap.add_argument("--parallel-n", type=int, default=1,
                    help="parallel samples per request (forks sharing the "
                         "prompt's KV blocks)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--events-out", default=None,
                    help="write the request-lifecycle JSONL event stream")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot (registry + "
                         "dispatch counts) as JSON")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the serve loop; "
                         "host spans become record_function ranges")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if args.smoke:
        cfg = cfg.scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=device)
    print(f"arch={cfg.name} params={model_zoo.count_params(model)/1e6:.1f}M "
          f"device={device}")

    if args.vq:
        t0 = time.time()
        calib = calibration_tokens(cfg.vocab_size, n_sequences=8, seq_len=64,
                                   device=device)
        recipe = get_recipe(args.recipe).with_quantize_overrides(
            em_iters=15, codebook_update_iters=5)
        params, rep = quantize_model(model, params, calib, recipe=recipe,
                                     pack=True)
        print(f"GPTVQ[{recipe.name}]: {rep.achieved_bpv:.3f} bpv "
              f"in {time.time()-t0:.1f}s")

    rng = np.random.RandomState(0)
    prefix_on = args.prefix_cache == "on"
    if prefix_on:
        # shared-prefix traffic: the same 2 pages of header, private tails
        header = rng.randint(0, cfg.vocab_size, size=32)
        prompts = [np.concatenate([
            header, rng.randint(0, cfg.vocab_size, size=6 + i % 5)])
            for i in range(args.requests)]
    else:
        prompts = [rng.randint(0, cfg.vocab_size, size=6 + i % 5)
                   for i in range(args.requests)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=args.max_new,
                    temperature=args.temperature, n=args.parallel_n)
            for i, p in enumerate(prompts)]
    telemetry = Telemetry(events_out=args.events_out,
                          trace_dir=args.trace_dir)
    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=args.max_len, paged_attn_impl=args.paged_attn_impl,
                 kv_cache_bits=args.kv_cache_bits,
                 vq_matmul_impl=args.vq_matmul_impl, prefix_cache=prefix_on,
                 telemetry=telemetry, device=device)
    if args.kv_cache_bits != 16:
        fp_layout = dataclasses.replace(eng.layout, kv=KVQuantSpec())
        print(f"kv_cache_bits={args.kv_cache_bits}: per-layer pool "
              f"{pool_bytes_of(cfg, eng.layout, torch.float32)} B vs "
              f"{pool_bytes_of(cfg, fp_layout, torch.float32)} B fp32 "
              f"at the same page count")
    eng.run(reqs)
    tok_s = eng.stats["tokens"] / max(eng.stats["wall_s"], 1e-9)
    print(f"served {len(reqs)} requests, {eng.stats['tokens']} tokens in "
          f"{eng.stats['wall_s']:.2f}s ({tok_s:.1f} tok/s on {device})")

    records = eng.drain_request_records()
    ttfts = sorted(r.ttft_s for r in records if r.ttft_s is not None)
    itls = sorted(r.itl_mean_s for r in records if r.itl_mean_s is not None)
    if ttfts:
        print(f"TTFT: median {ttfts[len(ttfts) // 2]*1e3:.1f}ms  worst "
              f"{ttfts[-1]*1e3:.1f}ms (enqueue -> first sampled token)")
    if itls:
        print(f"ITL:  median {itls[len(itls) // 2]*1e3:.1f}ms/token  worst "
              f"{itls[-1]*1e3:.1f}ms/token")
    preempted = sum(r.preemptions for r in records)
    if preempted:
        print(f"preemptions: {preempted} (recompute-style; preempted "
              f"tokens were discarded and regenerated)")
    if eng.prefix_cache is not None:
        s = eng.stats
        print(f"prefix cache: {s['prefix_hits']} hits / "
              f"{s['prefix_misses']} misses, {s['prefix_hit_tokens']} "
              f"prompt tokens served from shared pages, "
              f"{s['prefix_cached_blocks']} blocks cached, "
              f"{s['prefix_evictions']} evicted")
    if args.parallel_n > 1:
        kids = sum(len(r.forks) for r in reqs)
        print(f"parallel sampling: {kids} forked sequences "
              f"(n={args.parallel_n}) shared their prompts' KV pages")
    if args.metrics_out:
        telemetry.write_metrics(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.events_out:
        print(f"event stream -> {args.events_out}")
    if args.trace_dir:
        print(f"profiler trace -> {args.trace_dir}")
    eng.close()
    telemetry.close()
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.prompt[:4].tolist()}... -> {r.out_tokens[:8]}")
    return eng, reqs


if __name__ == "__main__":
    main()
