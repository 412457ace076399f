"""The harness: finds a cell's configuration, traffic mix, limits and
metric readers by the names in ``BENCHMARK.json``, hands the run to the
runner that the mix's ``kind`` names, and prints the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by name under the benchmark's root:

* ``<config file>`` (``BENCHMARK.json``'s ``configs[].file``): the sizes,
  the deployment, and its ``arch``, which names the weight maker and the
  program's tree (``perfbench/models/<arch>.py``) and the plain reference
  that judges it (``perfbench/reference/<arch>.py``);
* ``perfbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the general runner ``perfbench/kinds/<kind>.py`` that reads it;
* ``perfbench/limits/<workload>.json``: each compared number's limit;
* ``perfbench/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer, with ``read(run) -> float | None`` over the runner's record
  (None: nothing to read, and the metric is left out of the line).

A later change adds a cell, a mix or a metric by adding such files and
entries; no file here needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

# modules that must not be loaded in the process that prints a result:
# the JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(RuntimeError):
    """The cell cannot run here (no such cell, no card, a missing file)."""


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CellError(f"missing file {path}") from e


def load_cell(root: Path, workload: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config_name=conf["name"],
                config=load_json(root / conf["file"]),
                traffic_name=w["traffic"],
                mix=load_json(root / "perfbench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=load_json(root / "perfbench" / "limits"
                                 / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer)


def _load_file(path: Path, modname: str):
    if not path.exists():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    safe = "perfbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in metric)
    return _load_file(root / "perfbench" / "metrics" / f"{metric}.py",
                      safe).read


def runner(kind: str):
    """The general runner of a mix kind: ``perfbench/kinds/<kind>.py``."""
    if not kind.replace("_", "").isalnum():
        raise CellError(f"bad mix kind {kind!r}")
    return importlib.import_module(f"perfbench.kinds.{kind}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole
    (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def metric_values(cell: Cell, run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        v = reader(cell.root, m["name"])(run)
        if v is None:
            continue
        v = float(v)
        if not math.isfinite(v):
            raise RuntimeError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: Cell, run, trace: bool) -> dict:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and, traced, ``breakdown``), then ``checks``,
    each compared number beside its limit."""
    metrics = metric_values(cell, run,
                            cell.per_layer if trace else cell.end_to_end)
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(run.correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["setup_parts"] = run.notes.get("setup_s", {})
    line["checks"] = run.checks
    return line
