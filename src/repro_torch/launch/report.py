"""Render the dry run's tables from artifacts/dryrun_torch/*.json (port of
``repro/launch/report.py``): a summary, the dry-run table, the roofline
at 256 and at 512 cards and VQ against bf16 at decode, headed by the
card's figures (``launch/mesh.HARDWARE``: NVIDIA's data-sheet figures for
an H100 SXM at 700 W, not measurements).

Run: PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR] \\
        > artifacts/roofline_tables_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import ART_DIR
from repro_torch.launch.mesh import HARDWARE


def load(art_dir: str = ART_DIR) -> dict:
    cells = {}
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        cells[r["cell"]] = r
    return cells


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def gb(x):
    return f"{(x or 0)/1e9:.2f}"


def budget_label() -> str:
    return (f"fits {HARDWARE['hbm_bytes'] / 1e9:.0f} GB less the reserve "
            f"({HARDWARE['hbm_reserve'] / 1e9:.2f} GB)")


def header() -> str:
    h = HARDWARE
    return (f"Card: {h['card']} (data-sheet figures, not measurements): "
            f"{h['peak_flops_bf16'] / 1e12:.0f} TFLOP/s bf16, "
            f"{h['hbm_bw'] / 1e12:.2f} TB/s HBM, {h['hbm_bytes'] / 1e9:.0f}"
            f" GB; NVLink {h['nvlink_bw'] / 1e9:.0f} GB/s and network "
            f"{h['net_bw'] / 1e9:.0f} GB/s a direction a card. The model "
            "axis is one node's 8 NVLink cards; data (and pod) run between "
            "nodes.")


def dryrun_table(cells):
    lines = [
        f"| cell | status | chips | {budget_label()} | args GB | "
        "peak GB | trace s | collective bytes/card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cid, r in sorted(cells.items()):
        if r["status"] == "skipped":
            lines.append(f"| {cid} | skipped ({r['reason'][:40]}...) "
                         "| | | | | | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {cid} | **{r['status']}** | | | | | | |")
            continue
        m = r["memory"]
        lines.append(
            f"| {cid} | ok | {r['chips']} | {'Y' if r['fits'] else 'N'} | "
            f"{gb(m['argument_bytes'])} | {gb(m['peak_bytes'])} | "
            f"{r['trace_s']} | {r['collectives']['total']:,} |")
    return "\n".join(lines)


def roofline_table(cells, pod: str = "pod1"):
    lines = [
        "| arch | shape | variant | compute | memory | collective | "
        "dominant | bound (s) | MFU@bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for cid, r in sorted(cells.items()):
        if r["status"] != "ok" or f"__{pod}" not in cid:
            continue
        parts = cid.split("__")
        arch, shape = parts[0], parts[1]
        variant = "vq" if cid.endswith("__vq") else "bf16"
        ro = r["roofline"]
        mfu = ro["useful_compute_s"] / ro["step_lower_bound_s"] \
            if ro["step_lower_bound_s"] else 0
        lines.append(
            f"| {arch} | {shape} | {variant} | {fmt_s(ro['compute_s'])} | "
            f"{fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} | "
            f"**{ro['dominant']}** | {fmt_s(ro['step_lower_bound_s'])} | "
            f"{mfu:.3f} |")
    return "\n".join(lines)


def vq_comparison(cells):
    """Per-arch decode: bf16 vs VQ memory term (the paper's claim)."""
    lines = [
        "| arch | shape | bf16 bound | VQ bound | speedup | "
        "bf16 weight+cache GB/card | VQ GB/card |",
        "|---|---|---|---|---|---|---|",
    ]
    for cid, r in sorted(cells.items()):
        if not cid.endswith("__vq") or r["status"] != "ok":
            continue
        base_id = cid[: -len("__vq")]
        b = cells.get(base_id)
        if not b or b["status"] != "ok":
            continue
        arch, shape = cid.split("__")[0], cid.split("__")[1]
        rb, rv = b["roofline"], r["roofline"]
        sp = rb["step_lower_bound_s"] / rv["step_lower_bound_s"]
        lines.append(
            f"| {arch} | {shape} | {fmt_s(rb['step_lower_bound_s'])} | "
            f"{fmt_s(rv['step_lower_bound_s'])} | **{sp:.2f}x** | "
            f"{rb['hbm_bytes']/1e9:.2f} | {rv['hbm_bytes']/1e9:.2f} |")
    return "\n".join(lines)


def summary(cells):
    ok = [r for r in cells.values() if r["status"] == "ok"]
    fits = [r for r in ok if r.get("fits")]
    skipped = [r for r in cells.values() if r["status"] == "skipped"]
    failed = [r for r in cells.values()
              if r["status"] not in ("ok", "skipped")]
    doms = {}
    for r in ok:
        doms[r["roofline"]["dominant"]] = doms.get(
            r["roofline"]["dominant"], 0) + 1
    return (f"{len(cells)} cells: {len(ok)} traced ok "
            f"({len(fits)} {budget_label()}), {len(skipped)} skipped "
            f"by design, {len(failed)} failed. "
            f"Dominant terms: {doms}.")


def render(cells) -> str:
    return "\n".join([
        header(), "", "## Summary\n", summary(cells),
        "\n## Dry-run table\n", dryrun_table(cells),
        "\n## Roofline (single-pod, 256 cards)\n",
        roofline_table(cells, "pod1"),
        "\n## Roofline (multi-pod, 512 cards)\n",
        roofline_table(cells, "pod2"),
        "\n## VQ vs bf16 serving (paper's deployment claim)\n",
        vq_comparison(cells)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ART_DIR)
    args = ap.parse_args(argv)
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
