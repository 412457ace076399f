"""Profile the quantize path on the card with torch.profiler.

Runs ``quantize_model`` once unprofiled and once under the profiler on a
full-width Llama-2-7B cut to one layer (random weights, seed 0,
2.25bpv_2d with the launcher's em_iters 25 / update_iters 10), then prints
the device's busy share of the wall time and the ops that take the host's
and the device's time. The profiler's own cost inflates the wall time, so
the busy share of the profiled wall is a lower bound; the unprofiled wall
time is printed beside it (that run comes first, so it also loads the
kernels, and builds any that are missing). Summarizing the trace of one
layer takes under a minute.

    PYTHONPATH=src python -m repro_torch.launch.profile_quantize \\
        [--table chiprun_out/quantize_profile.txt]
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def profile_quantize(table: str | None = None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.device import resolve_device
    from repro_torch.models import model_zoo

    dev = resolve_device("cuda")
    cfg = ARCHS["llama2-7b"].scaled(n_layers=1)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=16, seq_len=64,
                               device=dev)
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(em_iters=25, codebook_update_iters=10)
    t0 = time.perf_counter()
    quantize_model(model, params, calib, recipe=recipe, pack=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rep = quantize_model(model, params, calib, recipe=recipe,
                                pack=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side rows (kernels, memcpy, memset) on one stream: their sum is
    # the time the device was busy
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in on_dev)
    by_dev = sorted(on_dev, key=dev_us, reverse=True)[:15]
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:15]
    res = {"wall_s_unprofiled": plain_wall, "wall_s_profiled": wall,
           "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "stage_seconds": rep.stage_seconds,
           "top_device": [(e.key, e.count, dev_us(e) / 1e3) for e in by_dev],
           "top_host": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                        for e in by_cpu]}
    print(f"[profile] 1 layer: quantize {plain_wall:.2f}s "
          f"unprofiled, {wall:.2f}s profiled; device busy "
          f"{busy_us / 1e6:.2f}s = {100 * res['device_busy_share']:.1f}% of "
          f"the profiled wall", flush=True)
    for key, n, ms in res["top_device"][:10]:
        print(f"[profile]   device {ms:9.1f} ms  {n:7d}x  {key}")
    for key, n, ms in res["top_host"][:10]:
        print(f"[profile]   host   {ms:9.1f} ms  {n:7d}x  {key}")
    if table:
        os.makedirs(os.path.dirname(table) or ".", exist_ok=True)
        with open(table, "w") as f:
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default=None,
                    help="write the profiler's top-40 host table here")
    args = ap.parse_args(argv)
    profile_quantize(args.table)


if __name__ == "__main__":
    main()
