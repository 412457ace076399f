"""Readings that a cell's limits are set from, on the card: for each seed
one run of the cell in this process (the program's readings, as a run
prints them), then the cell's control on the same run: the plain
reference computed with float8 e4m3 operands (the precision below the
configuration's bf16) put in the program's place, read by the cell's own
number (``control`` of the mix's runner). The benchmark's own runs never
run this.

    python3 perfbench/control.py --workload qwen2-72b.chat \
        --seconds 51 --seeds 11 12 13 [--out control.jsonl]

One JSON line a seed: {"seed", "correct", the program's and the control's
readings}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from perfbench import run as entry  # noqa: E402


def readings(cell, seed: int, seconds: float, device) -> dict:
    import gc

    import torch

    from perfbench import bench

    kind = bench.runner(cell.mix["kind"])
    run = kind.run(cell, seed=seed, seconds=seconds, trace=False,
                   device=device, t_start=time.perf_counter())
    out = {"seed": seed, "correct": run.correct,
           **kind.control(cell, run, seed, device)}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    entry._environment()
    import torch

    from perfbench import bench

    cell = bench.load_cell(entry.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed, args.seconds, dev))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
