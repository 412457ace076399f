"""Run one cell of the benchmark of the PyTorch/CUDA port and print its
result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``src/repro_torch`` beside
``perfbench/`` and ``BENCHMARK.json``. It measures on the machine it runs
on and needs as many CUDA cards as the cell names: without them it exits
with a code other than 0 and prints no result. ``--trace 1`` adds a
profiler slice and reports the cell's per-layer metrics instead of its
end-to-end ones. Every build and kernel cache stays under ``build/`` in
the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no src/repro_torch beside {ROOT / 'perfbench'}: "
              f"nothing to measure", file=sys.stderr)
        return 2
    from perfbench import bench

    try:
        cell = bench.load_cell(ROOT, args.workload)
    except bench.CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False: no result",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found: no result",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    run = bench.runner(cell.mix["kind"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 4
    line = bench.result_line(cell, run, bool(args.trace))
    print(f"perfbench: {json.dumps(run.notes)}", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
