"""End-to-end driver on the PyTorch/CUDA port (``examples/
quantize_and_serve.py``'s, through ``repro_torch``): train a small LM,
GPTVQ-quantize it post-training, and serve batched requests with the same
engine for fp and VQ-compressed weights.

The VQ serving passes run twice: on the gather path (densify per layer
inside the forward) and with ``--vq-matmul-impl fused``, every packed
matmul through the ``vq_dequant_matmul`` kernel on the card (its plain
version on the CPU); greedy outputs are token-identical. Each serving
pass reports TTFT (from enqueue) and ITL from the engine's request
records and the decode tick's host/device split from its spans; the
quantize calls report their stage seconds. Then a pass over quantized KV
pages (``--kv-cache-bits``), prefix sharing with forked sampling, and,
with ``--family``, the same ``quantize_model`` call on another family's
smoke config.

Run: PYTHONPATH=src python examples/torch_quantize_and_serve.py
     [--device cpu] [--steps 150] [--family ssm] [--vq-matmul-impl fused]
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import FAMILY_REPRESENTATIVE as FAMILY_ARCH, SMOKE
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core.bpv import PAPER_SETTINGS, VQConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.data.synthetic import SyntheticStream, sample_batch
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import perplexity
from repro_torch.train.train_step import init_state, make_train_step


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def quantize_other_family(family: str, device, log=print) -> dict:
    """Same quantize_model call, different architecture family."""
    cfg = SMOKE[FAMILY_ARCH[family]].scaled(dtype="float32")
    log(f"== GPTVQ on the {family} family ({cfg.name} smoke config) ==")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=device)
    calib = sample_batch(_gen(device, 9), cfg.vocab_size, 32, 8)
    vq_cfg = VQConfig(d=2, bits_per_dim=3, group_size=4096, em_iters=10,
                      codebook_update_iters=5)
    t0 = time.time()
    qparams, rep = quantize_model(model, params, calib, "gptvq", vq_cfg,
                                  pack=True)
    heldout = sample_batch(_gen(device, 4), cfg.vocab_size, 32, 4)
    extras = adapters.calib_extras(cfg, heldout)
    with torch.no_grad():
        ppl_fp = perplexity(model, params, heldout, batch_extra=extras)
        ppl_vq = perplexity(model, qparams, heldout, batch_extra=extras)
    log(f"  {len(rep.per_layer)} blocks in {time.time()-t0:.1f}s at "
        f"{rep.bits_per_value:.3f} bpv | recon err {rep.total_error():.3f}"
        f" | ppl fp={ppl_fp:.2f} vq={ppl_vq:.2f}")
    return {"family": family, "bits_per_value": rep.bits_per_value,
            "ppl_fp": ppl_fp, "ppl_vq": ppl_vq}


def serve_pass(model, params, prompts, device, *, vq_impl: str, log=print,
               **engine_kw) -> tuple:
    """6 batched requests through one engine; (its figures, the engine,
    the requests)."""
    eng = Engine(model, params, max_batch=4, max_len=128, device=device,
                 vq_matmul_impl=vq_impl, **engine_kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    recs = eng.drain_request_records()
    ttfts = sorted(r.ttft_s for r in recs if r.ttft_s is not None)
    itls = [r.itl_mean_s for r in recs if r.itl_mean_s is not None]
    snap = eng.telemetry.registry.snapshot()
    host = snap.get("span.decode_tick/host_prep", {}).get("sum", 0.0)
    dev = snap.get("span.decode_tick/device", {}).get("sum", 0.0)
    s = eng.stats
    fig = {"tokens": s["tokens"], "wall_s": s["wall_s"],
           "decode_ticks": s["decode_ticks"],
           "ttft_med_s": ttfts[len(ttfts) // 2], "ttft_worst_s": ttfts[-1],
           "itl_mean_s": float(np.mean(itls)),
           "device_frac": dev / (host + dev) if host + dev else 0.0,
           "sample": [int(t) for t in reqs[0].out_tokens[:8]]}
    log(f"  {fig['tokens']} tokens in {fig['wall_s']:.2f}s "
        f"({fig['decode_ticks']} ticks); sample: {fig['sample']}")
    log(f"  TTFT med={1e3*fig['ttft_med_s']:.0f}ms "
        f"worst={1e3*fig['ttft_worst_s']:.0f}ms | "
        f"ITL mean={1e3*fig['itl_mean_s']:.1f}ms/tok | decode device frac "
        f"{fig['device_frac']:.2f}")
    return fig, eng, reqs


def run(device, *, steps: int = 150, d_model: int = 128,
        family: str | None = None, kv_cache_bits=8,
        vq_matmul_impl: str = "fused", em_iters: int = 30,
        update_iters: int = 15, log=print) -> dict:
    """The example's figures (a dict); ``steps``, ``d_model`` and the
    quantizer's iterations size it."""
    cfg = ModelConfig(
        name="serve-demo", family="dense", n_layers=4, d_model=d_model,
        n_heads=4, n_kv_heads=2, head_dim=d_model // 4, d_ff=d_model * 3,
        vocab_size=2048, max_seq_len=256, dtype="float32",
        vocab_pad_multiple=64)
    model = model_zoo.build(cfg)
    fig: dict = {}

    log(f"== training {model_zoo.count_params(model)/1e6:.1f}M param LM "
        f"for {steps} steps ==")
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=min(20, steps),
                         total_steps=steps)
    state = init_state(model, 0, ocfg, device=device)
    step = make_train_step(model, ocfg)
    stream = SyntheticStream(cfg.vocab_size, seq_len=64, global_batch=16,
                             device=device)
    for i in range(steps):
        state, metrics = step(state, {"tokens": stream.next()})
        if (i + 1) % 50 == 0:
            log(f"  step {i+1}: loss={float(metrics['loss']):.3f}")
    fig["final_loss"] = float(metrics["loss"]) if steps else None

    heldout = sample_batch(_gen(device, 7), cfg.vocab_size, 64, 8)
    with torch.no_grad():
        fig["ppl_fp"] = perplexity(model, state.params, heldout)
    log(f"  fp32 perplexity: {fig['ppl_fp']:.2f}")

    log("== GPTVQ post-training quantization (2D, 2.25 bpv) ==")
    calib = sample_batch(_gen(device, 9), cfg.vocab_size, 64, 16)
    vq_cfg = VQConfig(d=2, bits_per_dim=2, group_size=1024,
                      em_iters=em_iters, codebook_update_iters=update_iters)
    t0 = time.time()
    qparams, report = quantize_model(model, state.params, calib, "gptvq",
                                     vq_cfg, pack=True)
    fig["quantize_s"] = time.time() - t0
    fig["bits_per_value"] = report.bits_per_value
    log(f"  quantized in {fig['quantize_s']:.1f}s at "
        f"{report.bits_per_value:.3f} bits/value")
    stages = sorted(report.stage_seconds.items(), key=lambda kv: -kv[1])
    log("  stage breakdown: " + " ".join(f"{k}={v:.1f}s" for k, v in stages))
    with torch.no_grad():
        fig["ppl_vq"] = perplexity(model, qparams, heldout)
    log(f"  VQ perplexity: {fig['ppl_vq']:.2f} (fp32 {fig['ppl_fp']:.2f})")

    log("== mixed QuantRecipe: attn 2D@2b, mlp 1D@4b, layer-0 wq dense ==")
    recipe = QuantRecipe(
        rules=(
            Rule("layers.0.attn.wq", KeepDense("demo: named target")),
            Rule("group:attn", Quantize(PAPER_SETTINGS["2.25bpv_2d"])),
            Rule("group:mlp", Quantize(PAPER_SETTINGS["4.125bpv_1d"])),
        ),
        default=Quantize(PAPER_SETTINGS["2.25bpv_2d"]), name="mixed-demo",
    ).with_quantize_overrides(em_iters=em_iters,
                              codebook_update_iters=update_iters)
    qparams_mix, rep_mix = quantize_model(model, state.params, calib,
                                          recipe=recipe, pack=True)
    with torch.no_grad():
        fig["ppl_mix"] = perplexity(model, qparams_mix, heldout)
    fig["achieved_bpv_mix"] = rep_mix.achieved_bpv
    mix = sorted({(e.get("d"), e.get("bits_per_dim"))
                  for e in rep_mix.per_target.values()
                  if e["action"] == "quantize"})
    log(f"  {rep_mix.achieved_bpv:.3f} bpv achieved | settings (d,b): "
        f"{mix} | ppl {fig['ppl_mix']:.2f} | dense: "
        f"{[k for k, e in rep_mix.per_target.items() if e['action'] == 'keep_dense']}")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=8 + i % 5)
               for i in range(6)]
    # the third pass serves the same packed checkpoint through the fused
    # VQ-dequant matmul (the engine preps VQLinear -> FusedVQLinear once
    # at load; greedy outputs are token-identical to the gather pass)
    passes = (("fp32", state.params, "gather"),
              ("gptvq-packed", qparams, "gather"),
              (f"gptvq-{vq_matmul_impl}", qparams, vq_matmul_impl))
    fig["serve"] = {}
    for tag, params, vq_impl in passes:
        log(f"== serving 6 batched requests [{tag}] ==")
        fig["serve"][tag], _, _ = serve_pass(model, params, prompts, device,
                                             vq_impl=vq_impl, log=log)

    # quantized KV pages: the same engine and VQ-packed weights, the pool
    # storing int8 / packed-int4 / vq2 pages; at a fixed pool byte budget
    # the allocator exposes the extra pages
    from repro_torch.models.attention import PagedLayout
    from repro_torch.serve.paged_cache import pool_bytes_of

    bits = kv_cache_bits
    log(f"== serving with --kv-cache-bits {bits} "
        f"[gptvq-packed weights + quantized KV pages] ==")
    mb, max_len, page_size = 4, 128, 16
    fp_blocks = mb * (-(-max_len // page_size)) + 1
    budget = pool_bytes_of(cfg, PagedLayout(fp_blocks, page_size),
                           torch.float32)
    kv_fig, eng, _ = serve_pass(model, qparams, prompts, device,
                                vq_impl="gather",
                                log=log, page_size=page_size,
                                kv_cache_bits=bits, pool_bytes=budget)
    fp_pages = fp_blocks - 1
    kv_fig["pages"] = eng.scheduler.allocator.capacity
    kv_fig["headroom"] = kv_fig["pages"] / fp_pages
    fig["kv_pages"] = kv_fig
    tag = bits if bits == "vq2" else f"kv{bits}"
    log(f"  fixed {budget} B/layer pool: {fp_pages} fp32 pages -> "
        f"{kv_fig['pages']} {tag} pages ({kv_fig['headroom']:.1f}x)")

    # prefix sharing and forked parallel sampling: requests behind one
    # shared header share its pages through the radix prefix cache, and
    # Request(n=) forks n samples off one prompt's blocks
    log("== prefix sharing: 6 requests behind one 48-token header ==")
    header = rng.randint(0, cfg.vocab_size, size=48)
    shared = [np.concatenate([header,
                              rng.randint(0, cfg.vocab_size, size=4 + i)])
              for i in range(6)]
    eng = Engine(model, qparams, max_batch=4, max_len=128, page_size=16,
                 prefix_cache=True, device=device)
    reqs = [Request(rid=200 + i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(shared)]
    eng.run(reqs)
    s = eng.stats
    fig["prefix"] = {k: s[k] for k in ("prefix_hits", "prefix_misses",
                                       "prefix_hit_tokens",
                                       "prefix_cached_blocks")}
    log(f"  {s['tokens']} tokens in {s['wall_s']:.2f}s | "
        f"{s['prefix_hits']} prefix hits / {s['prefix_misses']} misses: "
        f"{s['prefix_hit_tokens']} prompt tokens served from shared pages "
        f"({s['prefix_cached_blocks']} blocks cached)")
    par = Request(rid=300, prompt=shared[0], max_new_tokens=16, n=3)
    eng.run([par])
    fig["forks_identical"] = all(c.out_tokens == par.out_tokens
                                 for c in par.forks)
    log(f"  Request(n=3): parent + {len(par.forks)} forks off the same "
        f"prompt blocks, greedy-identical: {fig['forks_identical']}")
    if family:
        fig["family"] = quantize_other_family(family, device, log=log)
    return fig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--family", default=None, choices=sorted(FAMILY_ARCH),
                    help="also quantize a smoke config from this family "
                         "through the same pipeline")
    ap.add_argument("--kv-cache-bits", default=8,
                    type=lambda s: s if s == "vq2" else int(s),
                    choices=[16, 8, 4, "vq2"],
                    help="page storage for the quantized-KV serving pass")
    ap.add_argument("--vq-matmul-impl", default="fused",
                    choices=["gather", "fused"],
                    help="VQ weight execution for the third serving pass")
    ap.add_argument("--em-iters", type=int, default=30)
    ap.add_argument("--update-iters", type=int, default=15)
    args = ap.parse_args(argv)
    fig = run(resolve_device(args.device), steps=args.steps,
              d_model=args.d_model, family=args.family,
              kv_cache_bits=args.kv_cache_bits,
              vq_matmul_impl=args.vq_matmul_impl, em_iters=args.em_iters,
              update_iters=args.update_iters)
    print(json.dumps(fig, default=str))
    return fig


if __name__ == "__main__":
    main()
