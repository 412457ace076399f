#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):
  1. device   — the card's name and power limit; no CUDA device is an error.
  2. build    — compile every kernel of the path (one nvcc per source, in
                parallel) into build/repro_torch/.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                its path's shapes, with its tolerance, its time, the
                plain version's time, one PyTorch library call's time and
                the least time the card could take (bound), and the
                variant that ran (vq_dequant_matmul: split-K at M <= 16,
                int8 or 3-term tensor cores for bf16 x above; flash:
                tensor cores for bf16). vq_dequant_matmul's codebooks are
                in the path's form (int8 times a per-(group, band) scale),
                plus one row per regime with arbitrary f32 ones; its rows
                are held bitwise independent of the other rows of x and
                bitwise the same from call to call at M = 4 and M = 64.
                Each bf16 flash row also counts the outputs that differ
                from bf16(plain) for the tensor-core kernel, the FP32 one
                and p1-only and p1 + p2 controls (every term of p shows).
  4. small    — the whole path on the SKILL smoke config, on the card and
                on the CPU (plain versions), held against each other.
  5. main     — the port's main path at Llama-2-7B full width with depth cut
                to 2 layers (random weights from seed 0): calibration
                tokens, fp perplexity, GPTVQ quantize_model at 2.25bpv_2d
                (em_iters 25, update_iters 10, pack=True), then the packed
                model's perplexity through prepare_fused_tree (every
                quantized matmul in the vq_dequant_matmul kernel). Launch
                counts are zeroed just before and read just after; all 14
                vq_dequant_matmul launches must be int8 tensor-core ones.
                Then
                teacher-forced logits of the fused form against the
                dequant_tree (gather) form.
  6. serve    — main's packed model served by the paged engine (max_batch
                4, max_len 256, page_size 16, f32 KV pages, fused paged
                attention and fused VQ matmuls): 8 greedy requests of 40-72
                prompt tokens, 64 new tokens each. Launch counts zeroed just
                before ``run`` and read just after: paged_attention must
                equal decode ticks x layers, vq_dequant_matmul must run at
                M = 4 and, by variant, as the host plan predicts (split-K
                for decode ticks and chunks of <= 16 rows, int8 tensor
                cores for wider prefill chunks). Then teacher-forced
                logits of request 0 through the paged path (gather
                prefill + kernel decode) against the cache-free forward
                and against the gather decode, and three
                shorter engines (4 requests, 32 new tokens) with int8, int4
                and vq2 pages, their drift against the f32-page run printed
                and the vq2 engine's codebook fit counted (vq_assign
                launches zeroed just before the engine is built).
  7. long     — the quantize path at Llama-2-7B's 4096-token context, same
                full-width 2-layer model and recipe: calibration 4 x 4096
                tokens, heldout 8 x 4096; fp perplexity, quantize_model
                with a Telemetry, vq perplexity, the packed checkpoint
                saved (build/repro_torch/long_ckpt, removed after),
                restored and evaluated again. Every attention runs the
                flash_attention kernel; launch and dispatch counts are
                zeroed just before the fp perplexity and read just after
                the restored one, and held to the prediction (10 flash
                launches: 8 on tensor cores, 2 on the FP32 kernel in the
                f32 advance pass; 28 int8 tensor-core vq_dequant_matmul
                launches), with the restored leaves bit for bit, the
                restored perplexity equal to the vq one and the quant
                event counts.
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32
# (non-tensor-core) FLOP/s and bf16 tensor-core FLOP/s. A product of f32
# operands is bound at the FP32 peak; one of bf16 operands with an f32 sum
# at the bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# 2.25bpv_2d on the Llama-2-7B projections: d=2, k=16, 256-column groups of
# 4 rows; (N, K) per layer shape
VQ_D, VQ_K, VQ_GROUP_COLS, VQ_ROWS_PER_BAND = 2, 16, 256, 4
MATMUL_SHAPES = {"wq": (4096, 4096), "w1": (11008, 4096), "w2": (4096, 11008)}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time: bytes over the HBM rate or operations over the peak
    of the units that can do them exactly, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def impl_delta(before: dict, after: dict) -> dict:
    """Launches by variant between two snapshots of a launches_by_impl."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


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


def graph_ms(torch, fn, iters: int = 20):
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so no host dispatch is timed (what ``time_ms`` reads for
    a call whose host work outlasts its kernels). None, with the reason
    logged, if the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)
    except RuntimeError as e:  # a measurement, not a check of the port
        log(f"[kernels] graph timing unavailable: {e}")
        return None


def _fmt_ms(t) -> str:
    return "n/a" if t is None else f"{t:.4f} ms"


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


def matmul_inputs(torch, dev, layer: str, M: int, scale_block: int,
                  cb_form: str):
    """Random codes, codebooks and x at a Llama-2-7B projection's layout.
    cb_form "int8": the path's form, int8 values times a per-(group, band)
    f32 scale as quantize_codebooks leaves them (the kernel also gets the
    int8 codebooks and the scales); "f32": arbitrary f32 codebooks."""
    N, K = MATMUL_SHAPES[layer]
    d, k = VQ_D, VQ_K
    n_cg, n_bands = K // VQ_GROUP_COLS, N // VQ_ROWS_PER_BAND
    g = torch.Generator(device=dev).manual_seed(N + K + M + scale_block)
    words = torch.randint(-2**31, 2**31 - 1, (N, K // d // 8),
                          generator=g, device=dev, dtype=torch.int32)
    cb = torch.randn((n_cg, n_bands, k, d), generator=g, device=dev) * 0.05
    extra = {}
    if cb_form == "int8":
        s = cb.abs().amax(dim=(2, 3)) / 127
        cb_i8 = torch.clamp(torch.round(cb / s[..., None, None]), -128,
                            127).to(torch.int8)
        cb = cb_i8.to(torch.float32) * s[..., None, None]
        extra = dict(codebooks_i8=cb_i8, cb_scale=s)
    scales = None
    if scale_block:
        scales = torch.rand((N, K // scale_block), generator=g,
                            device=dev) + 0.5
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(d=d, code_bits=4, rows_per_band=VQ_ROWS_PER_BAND,
              group_cols=VQ_GROUP_COLS, scale_block=scale_block)
    return x, words, cb, scales, extra, kw


def check_matmul(torch, dev, layer: str, M: int, scale_block: int,
                 cb_form: str = "int8") -> dict:
    from repro_torch.kernels.vq_dequant_matmul import (
        Prepared, reconstruct, vq_dequant_matmul, vq_dequant_matmul_plain)

    N, K = MATMUL_SHAPES[layer]
    x, words, cb, scales, extra, kw = matmul_inputs(torch, dev, layer, M,
                                                    scale_block, cb_form)
    # timed as the path calls it: a fused leaf checks its codes and
    # codebooks once (core/vq_linear.fused_matmul), each call checks x
    prep = Prepared(words, cb, scales, k_c=VQ_K, **kw, **extra)
    run = lambda: prep(x)
    before = dict(vq_dequant_matmul.launches_by_impl)
    y = run()
    impl = impl_delta(before, vq_dequant_matmul.launches_by_impl)
    (impl,) = impl
    ref = vq_dequant_matmul_plain(x, words, cb, scales, **kw)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    it = (5, 1) if M * N * K > 2**38 else (20, 3)
    ms = time_ms(torch, run, *it)
    dev_ms = graph_ms(torch, run, it[0])
    plain_ms = time_ms(torch, lambda: vq_dequant_matmul_plain(
        x, words, cb, scales, **kw), *it)
    W = reconstruct(words, cb, scales, **kw)
    xf = x.float()
    lib_ms = time_ms(torch, lambda: torch.matmul(xf, W.T), *it)
    lib_dev_ms = graph_ms(torch, lambda: torch.matmul(xf, W.T), it[0])
    # the bytes the kernel must move: x, the words, the codebooks it reads
    # (int8 and their scales, or f32), the plane, y
    cb_bytes = (extra["codebooks_i8"].numel() + extra["cb_scale"].numel() * 4
                if extra else cb.numel() * 4)
    nbytes = (x.numel() * x.element_size() + words.numel() * 4 + cb_bytes
              + (scales.numel() * 4 if scale_block else 0) + M * N * 4)
    # whatever variant runs, bf16 x times a bf16-exact W is exact on bf16
    # tensor cores with an f32 sum: the int8 values as they are, an
    # arbitrary f32 value as three bf16 terms (three times the operations)
    flops = 2.0 * M * N * K * (1 if extra else 3)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
    row = {"name": "vq_dequant_matmul", "shape": layer, "M": M, "N": N,
           "K": K, "scale_block": scale_block, "cb_form": cb_form,
           "impl": impl, "max_abs_err": err, "tol": tol, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernels] vq_dequant_matmul {layer} M={M} N={N} K={K} "
        f"sb={scale_block} cb={cb_form} ({impl}): max abs err {err:.2e} "
        f"(tol {tol:.2e}), max rel "
        f"{err / max(float(ref.abs().max()), 1e-30):.2e} | kernel {ms:.4f} "
        f"ms ({_fmt_ms(dev_ms)} replayed from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, torch.matmul(x, W.T) {lib_ms:.4f} ms "
        f"({_fmt_ms(lib_dev_ms)} from a graph), bound {b_ms:.4f} ms "
        f"({b_by})")
    if not err <= tol:
        raise Failed(f"vq_dequant_matmul {layer} M={M} sb={scale_block} "
                     f"cb={cb_form}: error {err} > {tol}")
    return row


def check_matmul_rows(torch, dev) -> dict:
    """Row m of y is the same bit for bit whatever the other rows of x
    hold (the engine's solo-vs-interleaved token identity rests on it),
    and two calls give the same bits. At M = 4 (split-K) y of x[:1] is
    held to row 0; at M = 64 (tensor cores) y of x[:17], the fewest rows
    that stay on the tensor cores, to rows 0-16: x[:1] would run split-K,
    whose sums go in another order."""
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul

    out = {}
    for M, sub in ((4, 1), (64, 17)):
        x, words, cb, _, extra, kw = matmul_inputs(torch, dev, "wq", M, 0,
                                                   "int8")
        run = lambda xx: vq_dequant_matmul(xx, words, cb, k_c=VQ_K, **kw,
                                           **extra)
        y = run(x)
        same_run = bool(torch.equal(run(x), y))
        same_rows = bool(torch.equal(run(x[:sub].contiguous()), y[:sub]))
        other = x.clone()
        other[sub:] = -other[sub:]
        same_other = bool(torch.equal(run(other)[:sub], y[:sub]))
        out[M] = {"rows_checked": sub, "two_calls_equal": same_run,
                  "rows_alone_equal": same_rows,
                  "other_rows_changed_equal": same_other}
        log(f"[kernels] vq_dequant_matmul bitwise at M={M}: two calls "
            f"{same_run}, y(x[:{sub}]) == y(x)[:{sub}] {same_rows}, with "
            f"the other rows changed {same_other}")
        if not (same_run and same_rows and same_other):
            raise Failed(f"vq_dequant_matmul rows at M={M} are not "
                         "bitwise independent and deterministic")
    return out


# paged decode attention at the serve phase's shape (Llama-2-7B heads) and
# a GQA shape (Qwen2-72B heads, G = 8); B, n_pages, page_size as the engine
PAGED_SHAPES = {
    "serve": dict(B=4, H=32, KV=32, hd=128, pos=[0, 57, 111, 135]),
    "gqa": dict(B=4, H=64, KV=8, hd=128, pos=[200, 0, 255, 33]),
}
PAGE_SIZE, N_PAGES = 16, 16


def check_paged(torch, dev, shape: str, fmt, q_dtype) -> dict:
    """paged_attention against its plain version on random pools in
    ``fmt`` (quantized by kernels/kv_quant), ragged positions and an idle
    slot (pos 0, all-scratch table row)."""
    from repro_torch.kernels import kv_quant as kvq
    from repro_torch.kernels.paged_attention import (
        _decoded_view, paged_attention, paged_attention_plain)

    sh = PAGED_SHAPES[shape]
    B, H, KV, hd, pos = sh["B"], sh["H"], sh["KV"], sh["hd"], sh["pos"]
    nb = B * N_PAGES + 1
    g = torch.Generator(device=dev).manual_seed(H + KV + len(str(fmt)))
    q = torch.randn((B, H, hd), generator=g, device=dev).to(q_dtype)
    kp = torch.randn((nb, PAGE_SIZE, KV, hd), generator=g, device=dev)
    vp = torch.randn((nb, PAGE_SIZE, KV, hd), generator=g, device=dev)
    kw = {}
    if fmt == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    elif fmt == "vq2":
        cbs = [torch.randn((KV, 16, 2), generator=g, device=dev)
               for _ in range(2)]
        (kp, ks), (vp, vs) = (kvq.vq_quantize_rows(kp, cbs[0]),
                              kvq.vq_quantize_rows(vp, cbs[1]))
        kw = dict(k_scale=ks, v_scale=vs, k_codebook=cbs[0],
                  v_codebook=cbs[1])
    elif fmt in (8, 4):
        (kp, ks), (vp, vs) = kvq.quantize_kv(kp, fmt), kvq.quantize_kv(vp, fmt)
        kw = dict(k_scale=ks, v_scale=vs)
    kp, vp = kp.contiguous(), vp.contiguous()
    table = torch.zeros((B, N_PAGES), dtype=torch.int32)
    blocks = iter(torch.randperm(nb - 1, generator=torch.Generator()
                                 .manual_seed(B)).add(1).tolist())
    for b in range(B):
        if pos[b]:
            for p in range(pos[b] // PAGE_SIZE + 1):
                table[b, p] = next(blocks)
    table = table.to(dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = paged_attention(q, kp, vp, table, pos_t, **kw)
    ref = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # f32: online softmax and FMA dot products sum in another order; bf16
    # output: both round the same f32 result, one bf16 ulp apart at most
    tol = 2e-5 if q_dtype == torch.float32 else 8e-3
    ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))
    ms = time_ms(torch, lambda: paged_attention(q, kp, vp, table, pos_t,
                                                **kw))
    plain_ms = time_ms(torch, lambda: paged_attention_plain(
        q, kp, vp, table, pos_t, **kw))
    # library yardstick: SDPA over the K/V view gathered and decoded
    # beforehand, the same kpos <= pos mask
    kd = _decoded_view(kp, kw.get("k_scale"), kw.get("k_codebook"), table,
                       hd).transpose(1, 2).contiguous()
    vd = _decoded_view(vp, kw.get("v_scale"), kw.get("v_codebook"), table,
                       hd).transpose(1, 2).contiguous()
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            <= pos_t.long()[:, None])[:, None, None, :]
    qf = q.float()[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qf, kd, vd, attn_mask=mask,
                                         enable_gqa=True))
    rows = sum(min(p + 1, N_PAGES * PAGE_SIZE) for p in pos)
    row_bytes = kp.shape[-1] * kp.element_size() + (4 if kw else 0)
    nbytes = (2 * rows * KV * row_bytes + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + B * 4
              + (2 * KV * 32 * 4 if fmt == "vq2" else 0))
    b_ms, b_by = bound_ms(nbytes, 4.0 * rows * H * hd)
    row = {"name": "paged_attention", "shape": shape, "fmt": str(fmt),
           "q_dtype": str(q_dtype).replace("torch.", ""), "B": B, "H": H,
           "KV": KV, "hd": hd, "pos": pos, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] paged_attention {shape} fmt={fmt} q={row['q_dtype']} "
        f"B={B} H={H} KV={KV} hd={hd} pos={pos}: max abs err {err:.2e} "
        f"(tol {tol:.0e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa(decoded view) {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    if not ok:
        raise Failed(f"paged_attention {shape} fmt={fmt}: error {err} > "
                     f"{tol}")
    return row


# the long phase: Llama-2-7B's published 4096-token context
LONG_SEQ, LONG_CALIB, LONG_HELDOUT = 4096, 4, 8

# flash attention at the long phase's shapes (Llama-2-7B heads, 4096-token
# context: heldout B = 8, calibration B = 4), a GQA shape with Qwen2-72B's
# heads, and two small exactness cases (q_offset > 0; non-causal, Sk != Sq)
FLASH_SHAPES = {
    "llama B=8": dict(B=8, Sq=4096, Sk=4096, H=32, KV=32, hd=128,
                      causal=True, q_offset=0),
    "llama B=4": dict(B=4, Sq=4096, Sk=4096, H=32, KV=32, hd=128,
                      causal=True, q_offset=0),
    "gqa": dict(B=1, Sq=4096, Sk=4096, H=64, KV=8, hd=128, causal=True,
                q_offset=0),
    "q_offset": dict(B=2, Sq=512, Sk=2048, H=8, KV=2, hd=128, causal=True,
                     q_offset=1536),
    "non-causal": dict(B=2, Sq=512, Sk=2048, H=8, KV=8, hd=64,
                       causal=False, q_offset=0),
}


def attention_p_terms(torch, q, k, v, *, causal: bool, q_offset: int,
                      terms: int):
    """f32 attention in one softmax pass with p = exp(s - max) cut to the
    sum of its first ``terms`` bf16 terms (1: bf16(p)); (batch, 8 heads)
    blocks at a time. A control for what the tensor-core flash kernel
    would give with fewer terms of p."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    dev = q.device
    live = None
    if causal:
        live = (torch.arange(Sk, device=dev)[None, :]
                <= q_offset + torch.arange(Sq, device=dev)[:, None])
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    for b in range(B):
        for h0 in range(0, H, 8):
            heads = torch.arange(h0, min(H, h0 + 8), device=dev)
            kv = heads // (H // KV)
            qb = q[b][:, heads].float().transpose(0, 1)
            kb = k[b][:, kv].float().transpose(0, 1)
            vb = v[b][:, kv].float().transpose(0, 1)
            s = qb @ kb.transpose(1, 2) * scale
            if live is not None:
                s = s.masked_fill(~live, -1e30)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            l = p.sum(dim=-1, keepdim=True)
            cut, rest = torch.zeros_like(p), p
            for _ in range(terms):
                t = rest.to(torch.bfloat16).float()
                cut, rest = cut + t, rest - t
            out[b][:, heads] = ((cut @ vb) / l.clamp(min=1e-30)).transpose(
                0, 1)
    return out


def flash_term_counts(torch, q, k, v, out, ref, **kw) -> dict:
    """How many bf16 outputs differ from the plain version's: the
    tensor-core kernel's (all three terms of p), the FP32 kernel's on the
    same values (q upcast: that variant, output rounded to bf16 here), and
    the p1-only and p1 + p2 controls."""
    from repro_torch.kernels.flash_attention import flash_attention

    def off(x):
        return int((x.to(torch.bfloat16) != ref).sum())

    counts = {"elements": ref.numel(), "tc": off(out),
              "fp32": off(flash_attention(q.float(), k, v, **kw))}
    for n in (1, 2):
        counts[f"p{n}_only" if n == 1 else "p1_p2"] = off(
            attention_p_terms(torch, q, k, v, terms=n, **kw))
    return counts


def terms_match(c: dict) -> bool:
    """The tensor-core kernel's count is the FP32 kernel's, within a
    factor of 1.5 (both sum in another order than the plain version), at
    most a tenth of the p1-only control's and half the p1 + p2 one's: each
    term of p shows in the outputs."""
    return (c["tc"] <= 1.5 * c["fp32"] + 16 and 10 * c["tc"] <= c["p1_only"]
            and 2 * c["tc"] <= c["p1_p2"])


def check_flash(torch, dev, shape: str, dtype) -> dict:
    """flash_attention against its plain version (the reference's two-level
    scan), timed beside SDPA on the same q/k/v."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    sh = FLASH_SHAPES[shape]
    B, Sq, Sk, H, KV, hd = (sh[n] for n in ("B", "Sq", "Sk", "H", "KV", "hd"))
    causal, off = sh["causal"], sh["q_offset"]
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, q_offset=off)
    before = dict(flash_attention.launches_by_impl)
    out = flash_attention(q, k, v, **kw)
    (impl,) = impl_delta(before, flash_attention.launches_by_impl)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # f32: online softmax over 64-column tiles and FMA dot products sum in
    # another order; bf16 output: both round f32 results ~1e-6 apart, so
    # they differ by at most one bf16 ulp, 2^-7 of the value
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 1e-5)
    ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
    terms = None
    if impl == "tc":
        terms = flash_term_counts(torch, q, k, v, out, ref, **kw)
        log(f"[kernels] flash_attention {shape}: outputs off bf16(plain) "
            f"{terms}")
        ok = ok and terms_match(terms)
    big = B * H * Sq * Sk > 2**30
    iters, warm = (5, 1) if big else (20, 3)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, **kw), iters, warm)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                       iters, warm)
    # library yardstick: SDPA on the same q/k/v in (B, H, S, hd) order; a
    # q_offset needs an explicit mask (is_causal aligns rows at 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if causal and off:
        mask = (torch.arange(Sk, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])
    lib_ms = time_ms(torch, lambda: sdpa(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not off,
        enable_gqa=KV != H), iters, warm)
    # the work these inputs need: every unmasked (row, column) pair costs
    # 2 * hd FLOPs of q.k and 2 * hd of p.v per head; each input read once,
    # the output written once. With bf16 q, k, v, q.k is exact on bf16
    # tensor cores with an f32 sum, and so is p.v with the f32 p split
    # into three bf16 terms (p = p1 + p2 + p3 exactly): the ops take
    # (flops/2 + 3 flops/2) at the bf16 tensor-core peak. f32 inputs run
    # at the FP32 peak
    if causal:
        pairs = sum(min(Sk, off + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * hd * pairs * B * H
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == torch.bfloat16:
        b_ms, b_by = bound_ms(nbytes, 2 * flops, BF16_TC_FLOP_PER_S)
    else:
        b_ms, b_by = bound_ms(nbytes, flops)
    row = {"name": "flash_attention", "shape": shape, **sh,
           "dtype": str(dtype).replace("torch.", ""), "impl": impl,
           "max_abs_err": err, "rtol": rtol, "atol": atol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "flops": flops, "off_plain": terms}
    log(f"[kernels] flash_attention {shape} {row['dtype']} ({impl}) B={B} "
        f"Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
        f"q_offset={off}: max abs err {err:.2e} (rtol {rtol:.1e}, atol "
        f"{atol:.0e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not ok:
        raise Failed(f"flash_attention {shape} {dtype}: error {err} outside "
                     f"rtol {rtol}, atol {atol}")
    return row


def phase_kernels(torch, dev) -> list[dict]:
    t0 = time.perf_counter()
    rows = []
    # the quantizer's EM and span sweep, then the serve engine's vq2 KV
    # codebook fit (32 kv heads x 64 tokens x 64 pairs of head dims)
    for label, B, n in (("em", 1024, 512), ("em", 2752, 512),
                        ("sweep", 1024, 4), ("sweep", 2752, 4),
                        ("kv vq2 fit", 32, 4096)):
        rows.append(check_assign(torch, dev, B, n, label))
    # decode M = 1 (timed only), the serve engine's decode ticks (M = 4)
    # and prefill chunks (M = 64), the main phase's evaluation (M = 512),
    # the long phase's (8 x 4096 rows); then one row per regime with
    # arbitrary f32 codebooks
    for layer in MATMUL_SHAPES:
        for M in (1, SERVE_MAX_BATCH, SERVE_PREFILL_CHUNK, 512):
            for sb in (0, 64):
                rows.append(check_matmul(torch, dev, layer, M, sb))
        rows.append(check_matmul(torch, dev, layer, LONG_HELDOUT * LONG_SEQ,
                                 0))
    for M in (SERVE_MAX_BATCH, 512):
        rows.append(check_matmul(torch, dev, "wq", M, 0, "f32"))
    invariance = check_matmul_rows(torch, dev)
    for shape in PAGED_SHAPES:
        for fmt in ("f32", "bf16", 8, 4, "vq2"):
            rows.append(check_paged(torch, dev, shape, fmt, torch.float32))
    # the serve path's own dtypes: the bf16 model's queries over the
    # engine's f32 pages and over each quantized page format
    for fmt in ("f32", 8, 4, "vq2"):
        rows.append(check_paged(torch, dev, "serve", fmt, torch.bfloat16))
    for shape in FLASH_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            rows.append(check_flash(torch, dev, shape, dt))
    log(f"[kernels] {len(rows)} checks passed in "
        f"{time.perf_counter() - t0:.1f}s")
    return rows, invariance


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
    vq_dequant_matmul.launches_by_impl = {}
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
    impls = dict(vq_dequant_matmul.launches_by_impl)
    # one evaluation forward of 8 x 64 rows: 7 matmuls a layer, all on the
    # int8 tensor cores (bf16 x, int8 leaves)
    want_impl = {"tc_int8": 7 * cfg.n_layers}
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
    log(f"[main] launches in the main path: {launches}; vq_dequant_matmul "
        f"by variant {impls} (predicted {want_impl})")
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
        "vq_dequant_matmul by variant as planned": impls == want_impl,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"main path checks failed: {bad}")
    res = {"launches": launches, "vq_impl_counts": impls,
           "predicted_vq_impl_counts": want_impl,
           "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
           "recon_error": rep.total_error(),
           "achieved_bpv": rep.achieved_bpv,
           "per_target": rep.per_target, "stage_seconds": rep.stage_seconds,
           "seconds": t, "logit_max_diff": max_d, "logit_rms_diff": rms_d,
           "packed_bytes": packed, "dense_bytes": dense,
           "max_memory_allocated": peak}
    return res, model, qparams


# the serve phase: 8 greedy requests of 40-72 prompt tokens, 64 new tokens
SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_BATCH = 8, 64, 4
SERVE_PREFILL_CHUNK = 64  # the engine's default prefill chunk
SERVE_MAX_LEN, SERVE_PAGE = 256, 16
# serve/engine.calibrate_vq_codebooks's em_iters default
KV_FIT_EM_ITERS = 25


def serve_prompts(vocab: int, n: int) -> list:
    rng = np.random.RandomState(0)
    sizes = rng.randint(40, 73, size=n)
    return [rng.randint(0, vocab, size=int(s)) for s in sizes]


def prefill_chunk_ms(prompts) -> list:
    """The rows (M) of each prefill forward the engine plans for these
    prompts (scheduler.prefill_chunk_len: full chunks, then the rest
    padded to its power-of-two bucket)."""
    out = []
    for p in prompts:
        rest = len(p)
        while rest > 0:
            out.append(SERVE_PREFILL_CHUNK if rest >= SERVE_PREFILL_CHUNK
                       else 1 << (rest - 1).bit_length())
            rest -= min(rest, SERVE_PREFILL_CHUNK)
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def serve_run(torch, dev, model, qparams, kv_bits, n_req, n_new) -> dict:
    """One engine over ``n_req`` requests; kernel launch counts are zeroed
    just before ``run`` and read just after."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.serve.engine import Engine, Request

    # engine load: a vq2 engine fits its KV codebooks here (vq_assign)
    vq_assign.launches = 0
    t0 = time.perf_counter()
    eng = Engine(model, qparams, max_batch=SERVE_MAX_BATCH,
                 max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                 paged_attn_impl="fused", vq_matmul_impl="fused",
                 kv_cache_bits=kv_bits, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_assign = vq_assign.launches
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(serve_prompts(model.cfg.vocab_size, n_req))]
    paged_attention.launches = 0
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_m = {}
    vq_dequant_matmul.launches_by_impl = {}
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "vq_dequant_matmul": vq_dequant_matmul.launches}
    ms_seen = dict(vq_dequant_matmul.launches_by_m)
    impls_seen = dict(vq_dequant_matmul.launches_by_impl)
    st = eng.stats
    recs = eng.drain_request_records()
    ttft = [r.ttft_s for r in recs if r.ttft_s is not None]
    itl = [r.itl_mean_s for r in recs if r.itl_mean_s is not None]
    res = {"kv_bits": str(kv_bits), "requests": n_req, "new": n_new,
           "tokens": st["tokens"], "ticks": st["ticks"],
           "decode_ticks": st["decode_ticks"],
           "prefill_chunks": st["prefill_chunks"],
           "preemptions": st["preemptions"], "wall_s": wall,
           "engine_wall_s": st["wall_s"], "load_s": load_s,
           "tok_per_s": st["tokens"] / wall,
           "ttft_median_s": _median(ttft), "ttft_worst_s": max(ttft),
           "itl_median_s": _median(itl), "itl_worst_s": max(itl),
           "launches": launches, "vq_m_counts": ms_seen,
           "vq_impl_counts": impls_seen,
           "load_vq_assign_launches": load_assign,
           "out": [r.out_tokens for r in reqs],
           "prompts": [r.prompt for r in reqs]}
    log(f"[serve] kv={kv_bits}: {n_req} requests, {st['tokens']} tokens, "
        f"{st['ticks']} ticks ({st['decode_ticks']} decode, "
        f"{st['prefill_chunks']} prefill chunks, {st['preemptions']} "
        f"preemptions) in {wall:.3f} s = {res['tok_per_s']:.1f} tok/s "
        f"(engine load {load_s:.2f} s) | TTFT median "
        f"{res['ttft_median_s'] * 1e3:.1f} ms worst "
        f"{res['ttft_worst_s'] * 1e3:.1f} ms | ITL median "
        f"{res['itl_median_s'] * 1e3:.2f} ms worst "
        f"{res['itl_worst_s'] * 1e3:.2f} ms | launches {launches}, "
        f"vq_dequant_matmul launches by M {ms_seen}, by variant "
        f"{impls_seen}, vq_assign launches at engine load {load_assign}")
    res["engine"] = eng
    return res


def forced_logits(torch, dev, model, eng, prompt, forced, impl):
    """Teacher-forced per-step logits through a fresh paged cache in the
    engine's page format (and, for vq2, its frozen codebooks)."""
    from repro_torch.serve import paged_cache as pc
    from repro_torch.serve.serve_step import teacher_forced_logits

    cache = model.init_cache(1, SERVE_MAX_LEN, dtype=torch.float32,
                             paged=eng.layout, device=dev)
    n_pages = SERVE_MAX_LEN // SERVE_PAGE
    cache = pc.push_page_table(
        cache, np.arange(1, n_pages + 1, dtype=np.int32)[None])
    if eng.cache[0].k_codebook is not None:
        cache = [c._replace(k_codebook=e.k_codebook, v_codebook=e.v_codebook)
                 for c, e in zip(cache, eng.cache)]
    return teacher_forced_logits(model, eng.params, prompt, forced,
                                 cache=cache, paged_impl=impl)


def phase_serve(torch, dev, model, qparams) -> dict:
    cfg = model.cfg
    t_phase = time.perf_counter()
    main = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                     SERVE_NEW)
    eng = main.pop("engine")
    n_layers = cfg.n_layers
    want_pa = main["decode_ticks"] * n_layers
    # 7 quantized matmuls per layer in every forward (decode tick or
    # prefill chunk); the decode ticks run at M = max_batch
    want_vq = 7 * n_layers * (main["decode_ticks"] + main["prefill_chunks"])
    # by variant, from the host plan: decode ticks and prefill chunks of
    # <= 16 rows on split-K, wider chunks on the int8 tensor cores, none on
    # the 3-term or FP32 variants (the model is bf16, its leaves int8)
    chunks = prefill_chunk_ms(main["prompts"])
    want_impl = {
        "splitk": 7 * n_layers * (main["decode_ticks"]
                                  + sum(m <= 16 for m in chunks)),
        "tc_int8": 7 * n_layers * sum(m > 16 for m in chunks)}
    want_impl = {k: v for k, v in want_impl.items() if v}
    log(f"[serve] predicted launches: paged_attention = decode ticks x "
        f"layers = {want_pa}; vq_dequant_matmul = 7 x layers x (decode "
        f"ticks + prefill chunks) = {want_vq}, of them "
        f"{7 * n_layers * main['decode_ticks']} at M = {SERVE_MAX_BATCH}; "
        f"prefill chunks of {chunks} rows; by variant {want_impl}")

    # teacher-forced: request 0's prompt + outputs through the paged path
    prompt, out = main["prompts"][0], main["out"][0]
    forced = out[:-1]
    with torch.no_grad():
        fused = forced_logits(torch, dev, model, eng, prompt, forced, "fused")
        gather = forced_logits(torch, dev, model, eng, prompt, forced,
                               "gather")
        seq = torch.as_tensor(np.concatenate([prompt, forced]),
                              device=dev)[None]
        free = model.forward(eng.params, {"tokens": seq})[0][0]
        free = free[len(prompt) - 1:].float()
    diffs = {}
    for name, other in (("cache-free forward", free),
                        ("gather decode", gather)):
        d = (fused - other).float()
        diffs[name] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
    # bars set from the readings on the H100: sound decodes read up to
    # 5.2e-2 max / 1.0e-2 RMS (vs the cache-free forward, which rounds
    # probabilities to bf16) and 3.1e-2 / 5.2e-3 (vs the gather decode);
    # a decode that read K/V at int8 precision drifts 9.4e-2 / 1.77e-2
    # and fails the RMS bar, a wrong page, mask or scale moves logits O(1)
    max_tol, rms_tol = 0.1, 0.015
    for name, (mx, rms) in diffs.items():
        log(f"[serve] teacher-forced kernel decode vs {name}, "
            f"{tuple(fused.shape)} logits: max |diff| {mx:.4e} (tol "
            f"{max_tol}), RMS {rms:.4e} (tol {rms_tol})")
    greedy_agree = float((fused.argmax(-1).cpu()
                          == torch.tensor(out)).float().mean())
    log(f"[serve] teacher-forced argmax reproduces the served tokens on "
        f"{greedy_agree:.4f} of steps")

    # the vq2 engine's codebook fit: EM_ITERS E-steps per pool (K and V)
    # and layer, each one vq_assign launch over the 32 kv heads
    want_assign = {"8": 0, "4": 0, "vq2": KV_FIT_EM_ITERS * 2 * n_layers}
    quant = {}
    for bits in (8, 4, "vq2"):
        r = serve_run(torch, dev, model, qparams, bits, 4, 32)
        e = r.pop("engine")
        with torch.no_grad():
            ref = forced_logits(torch, dev, model, eng, prompt, out[:31],
                                "fused")
            got = forced_logits(torch, dev, model, e, prompt, out[:31],
                                "fused")
        d = got - ref
        r["drift_max"] = float(d.abs().max())
        r["drift_rms"] = float(d.pow(2).mean().sqrt())
        r["finite"] = bool(torch.isfinite(got).all())
        log(f"[serve] kv={bits}: vq_assign launches at engine load "
            f"{r['load_vq_assign_launches']} (predicted "
            f"{want_assign[str(bits)]})")
        log(f"[serve] kv={bits}: teacher-forced drift vs f32 pages on "
            f"request 0 (32 steps): max {r['drift_max']:.4e}, RMS "
            f"{r['drift_rms']:.4e}, finite {r['finite']}")
        quant[str(bits)] = r
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f}s")

    checks = {
        "all requests finished": all(len(o) == SERVE_NEW for o in main["out"]),
        "paged_attention launches == decode ticks x layers":
            main["launches"]["paged_attention"] == want_pa > 0,
        "vq_dequant_matmul launches == 7 x layers x forwards":
            main["launches"]["vq_dequant_matmul"] == want_vq > 0,
        "vq_dequant_matmul at M = 4": main["vq_m_counts"].get(
            SERVE_MAX_BATCH, 0) == 7 * n_layers * main["decode_ticks"],
        "prefill chunks as planned": main["prefill_chunks"] == len(chunks),
        "vq_dequant_matmul launches by variant as planned":
            main["vq_impl_counts"] == want_impl,
        "teacher-forced vs cache-free": diffs["cache-free forward"][0]
            <= max_tol and diffs["cache-free forward"][1] <= rms_tol,
        "teacher-forced vs gather decode": diffs["gather decode"][0]
            <= max_tol and diffs["gather decode"][1] <= rms_tol,
    }
    for bits, r in quant.items():
        checks[f"kv={bits} finished"] = all(len(o) == 32 for o in r["out"])
        checks[f"kv={bits} paged_attention launches"] = (
            r["launches"]["paged_attention"] == r["decode_ticks"] * n_layers
            > 0)
        checks[f"kv={bits} logits finite"] = r["finite"]
        checks[f"kv={bits} vq_dequant_matmul on split-K and int8 tensor "
               "cores only"] = set(r["vq_impl_counts"]) <= {"splitk",
                                                            "tc_int8"}
        checks[f"kv={bits} vq_assign launches at engine load"] = (
            r["load_vq_assign_launches"] == want_assign[bits])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"serve phase checks failed: {bad}")
    for r in [main, *quant.values()]:
        r.pop("prompts")
        r["out"] = r["out"][:2]
    return {"kv16": main, "quantized": quant, "teacher_forced": diffs,
            "greedy_agree": greedy_agree, "predicted": {
                "paged_attention": want_pa, "vq_dequant_matmul": want_vq,
                "vq_dequant_matmul_by_impl": want_impl,
                "vq_assign_at_load": want_assign}}


def phase_long(torch, dev) -> dict:
    """Quantize and evaluate at 4096 tokens (flash_attention in every
    attention), save the packed checkpoint, restore it and evaluate the
    restored tree. Launch and dispatch counts are zeroed just before the
    fp perplexity and read just after the restored one."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.obs import Telemetry, dispatch
    from repro_torch.train.loss import perplexity

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    log(f"[long] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, layers "
        f"{cfg.n_layers}, dtype {cfg.dtype}; calibration {LONG_CALIB} x "
        f"{LONG_SEQ}, heldout {LONG_HELDOUT} x {LONG_SEQ} tokens")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=LONG_CALIB,
                               seq_len=LONG_SEQ, device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=LONG_HELDOUT,
                                 seq_len=LONG_SEQ, seed=777, device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(em_iters=25, codebook_update_iters=10)
    tel = Telemetry()
    ck_dir = os.path.join(ROOT, "build", "repro_torch", "long_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    # one calibration chunk (4 sequences <= quantize_model's chunk of 8):
    # per layer one capture and one advance forward, and one forward in
    # each of the fp, vq and restored-vq evaluations, each with one
    # attention over 4096 tokens
    want_flash = cfg.n_layers * (2 + 3)
    want_vq = 7 * cfg.n_layers * 2  # the vq and restored-vq evaluations

    # by variant: the bf16 forwards (capture, the three evaluations) on
    # tensor cores, the advance forward on the FP32 kernel (it runs the
    # quantized block on f32-dequantized weights, as the reference's
    # adapters/transformer.advance does, so q, k and v are f32); every
    # vq_dequant_matmul on the int8 tensor cores (bf16 x, int8 leaves)
    want_impl = {"flash_attention": {"tc": cfg.n_layers * (1 + 3),
                                     "fp32": cfg.n_layers},
                 "vq_dequant_matmul": {"tc_int8": want_vq}}

    flash_attention.launches = 0
    flash_attention.launches_by_impl = {}
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    vq_assign.launches = 0
    dispatch.reset_dispatch_counters()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True, telemetry=tel,
        progress=lambda m: log(f"[long]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl_vq = perplexity(model, vql_mod.prepare_fused_tree(qparams), heldout)
    t["ppl_vq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Checkpointer(ck_dir, keep=1).save(0, qparams, metadata={
        "arch": cfg.name, "recipe": recipe.to_json(),
        "achieved_bpv": rep.achieved_bpv, "per_target": rep.per_target,
        "ppl_fp": ppl_fp, "ppl_vq": ppl_vq})
    t["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, meta = Checkpointer(ck_dir).restore(qparams)
    torch.cuda.synchronize()
    t["restore"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl_rs = perplexity(model, vql_mod.prepare_fused_tree(restored), heldout)
    t["ppl_restored"] = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "vq_dequant_matmul": vq_dequant_matmul.launches,
                "vq_assign": vq_assign.launches}
    impls = {"flash_attention": dict(flash_attention.launches_by_impl),
             "vq_dequant_matmul": dict(vq_dequant_matmul.launches_by_impl)}
    flash_dispatch = dispatch.snapshot_dispatch_counters()["flash"]["fused"]
    peak = torch.cuda.max_memory_allocated()

    from repro_torch.checkpoint.checkpointer import _flatten

    pairs = list(zip(_flatten(qparams), _flatten(restored)))
    bitwise = all(p == r and a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b) for (p, a), (r, b) in pairs)
    n_bf16 = sum(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
    ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(ck_dir) for f in fs)
    shutil.rmtree(ck_dir, ignore_errors=True)
    evs = tel.events.events
    n_stage = sum(e["event"] == "quant_stage" for e in evs)
    n_target = sum(e["event"] == "quant_target" for e in evs)
    # per block: capture, advance, and per target one codebook_update and
    # one em_init and one column_sweep for each of its column groups
    n_groups = sum(leaf.n_cg for lp in qparams["layers"]
                   for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    want_stage = cfg.n_layers * (2 + 7) + 2 * n_groups

    log(f"[long] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} restored={ppl_rs:.3f} | "
        f"recon err={rep.total_error():.4f} | achieved "
        f"{rep.achieved_bpv:.4f} bpv")
    log("[long] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[long] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[long] launches: {launches}; predicted flash_attention "
        f"{want_flash}, vq_dequant_matmul {want_vq}; \"flash\" dispatch "
        f"{flash_dispatch}; by variant {impls} (predicted {want_impl})")
    log(f"[long] checkpoint: {len(pairs)} leaves ({n_bf16} bf16), "
        f"{ck_bytes / 2**20:.1f} MiB, restored bit for bit: {bitwise}")
    log(f"[long] events: quant_stage {n_stage} (predicted {want_stage}), "
        f"quant_target {n_target} (predicted {7 * cfg.n_layers})")
    log(f"[long] max_memory_allocated {peak / 2**30:.2f} GiB")

    checks = {
        "ppl finite": all(math.isfinite(x) for x in (ppl_fp, ppl_vq, ppl_rs)),
        "restored ppl == vq ppl": ppl_rs == ppl_vq,
        "bpv": rep.achieved_bpv == 2.25,
        "checkpoint bitwise": bitwise and n_bf16 > 0,
        "metadata": meta["achieved_bpv"] == 2.25,
        "flash_attention launches": launches["flash_attention"] == want_flash,
        "flash dispatch": flash_dispatch == want_flash,
        "vq_dequant_matmul launches": launches["vq_dequant_matmul"] == want_vq,
        "launches by variant as planned": impls == want_impl,
        "vq_assign launched": launches["vq_assign"] > 0,
        "quant_stage events": n_stage == want_stage,
        "quant_target events": n_target == 7 * cfg.n_layers,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"long phase checks failed: {bad}")
    return {"launches": launches, "launches_by_impl": impls, "predicted": {
                "flash_attention": want_flash, "vq_dequant_matmul": want_vq,
                "quant_stage": want_stage, "by_impl": want_impl},
            "flash_dispatch": flash_dispatch, "ppl_fp": ppl_fp,
            "ppl_vq": ppl_vq, "ppl_restored": ppl_rs,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv,
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "checkpoint_leaves": len(pairs), "checkpoint_bf16_leaves": n_bf16,
            "checkpoint_bytes": ck_bytes, "events": {
                "quant_stage": n_stage, "quant_target": n_target},
            "max_memory_allocated": peak}


def kernel_line(rows: list[dict], launches: dict) -> dict:
    """One entry per kernel, at the shape its path launches most:
    vq_dequant_matmul at the eval's M=512 on a 4096x4096 projection,
    vq_assign at the span sweep's B=1024, n=4, paged_attention at the serve
    phase's B=4, 32 heads of 128, bf16 queries over f32 pages,
    flash_attention at the long phase's heldout B=8, 32 heads of 128, 4096
    tokens, bf16. Launches: the main phase's for the first two, the serve
    phase's (f32 pages) for paged_attention, the long phase's for
    flash_attention."""
    pick = {
        "vq_dequant_matmul": (
            lambda r: r["shape"] == "wq" and r["M"] == 512
            and r["scale_block"] == 0 and r["cb_form"] == "int8",
            "src/repro_torch/kernels/csrc/vq_dequant_matmul.cu",
            "src/repro/kernels/vq_dequant_matmul.py:137"),
        "vq_assign": (
            lambda r: r["shape"] == "sweep" and r["B"] == 1024,
            "src/repro_torch/kernels/csrc/vq_assign.cu",
            "src/repro/kernels/vq_assign.py:37"),
        "paged_attention": (
            lambda r: r["shape"] == "serve" and r["fmt"] == "f32"
            and r["q_dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:128"),
        "flash_attention": (
            lambda r: r["shape"] == "llama B=8" and r["dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
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
    rows, invariance = phase_kernels(torch, dev)
    small_res = phase_small(torch, dev)
    main_res, model, qparams = phase_main(torch, dev)
    serve_res = phase_serve(torch, dev, model, qparams)
    del model, qparams
    long_res = phase_long(torch, dev)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "chip_smoke.json")
    with open(out, "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": rows,
                   "vq_dequant_matmul_bitwise": invariance,
                   "small": small_res, "main": main_res,
                   "serve": serve_res, "long": long_res}, f, indent=1,
                  default=str)
    log(f"[done] {time.perf_counter() - t_all:.1f}s; details in {out}")
    launches = dict(main_res["launches"], paged_attention=serve_res[
        "kv16"]["launches"]["paged_attention"],
        flash_attention=long_res["launches"]["flash_attention"])
    print(json.dumps(kernel_line(rows, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
