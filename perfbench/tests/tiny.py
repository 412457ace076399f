"""A benchmark root in a temporary directory with one tiny cell of its own
(a configuration, a mix, limits and a metric reader that the repository
does not have) beside copies of the real readers: what a later change
adds, made without touching a file of the repository. The tiny cell runs
on the CPU through the same runner, the port's plain kernels standing in
for the CUDA ones, in float32 (the CPU's bf16 matmuls build a kernel for
each new shape, seconds apiece)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELL = "tiny.tinychat"
QCELL = "tiny.tinyquant"
DUMMY_METRIC = "tiny.requests_seen"

# the tiny quantizer's limits: sound CPU runs read Hessian gaps of a few
# 1e-7 (float32 on both sides) and leaf errors of about 0.1
QLIMITS = {"hessian_gap_max": 1e-3, "leaf_error_max": 0.5}

_DUMMY_READER = '''"""tiny.requests_seen: requests the clients submitted."""


def read(run):
    return len(run.reqs)
'''


def make_root(tmp: Path) -> Path:
    """The temporary root; the real BENCHMARK.json and files are read."""
    (tmp / "perfbench" / "configs").mkdir(parents=True)
    (tmp / "perfbench" / "traffic").mkdir()
    (tmp / "perfbench" / "limits").mkdir()
    shutil.copytree(REPO / "perfbench" / "metrics",
                    tmp / "perfbench" / "metrics")
    (tmp / "perfbench" / "metrics" / f"{DUMMY_METRIC}.py").write_text(
        _DUMMY_READER)
    cfg = json.loads((REPO / "perfbench/configs/qwen2-72b.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=160, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
               max_position_embeddings=128, torch_dtype="float32")
    cfg["assumed"] = dict(cfg["assumed"], head_dim=16)
    (tmp / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "perfbench/traffic/chat.json").read_text())
    # prompts fit one prefill chunk, padded to 8, 16, 32 or 64 tokens:
    # the first requests' prompts meet each width in warm-up
    mix.update(clients=4, requests_per_client=6,
               prompt_tokens={"dist": "loguniform", "lo": 8, "hi": 40},
               output_tokens={"dist": "loguniform", "lo": 8, "hi": 32},
               warm_prompts=[8, 16, 32, 40], warmup_ticks=3, trace_ticks=2,
               check_requests=6)
    (tmp / "perfbench/traffic/tinychat.json").write_text(json.dumps(mix))
    (tmp / "perfbench/limits" / f"{CELL}.json").write_text(
        json.dumps({"logit_gap_max": 0.05}))
    qcfg = json.loads(
        (REPO / "perfbench/configs/qwen3-moe-30b-a3b.json").read_text())
    qcfg.update(hidden_size=64, moe_intermediate_size=32,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                num_experts=8, num_experts_per_tok=2, num_hidden_layers=3,
                vocab_size=512, torch_dtype="float32")
    (tmp / "perfbench/configs/tinymoe.json").write_text(json.dumps(qcfg))
    qmix = json.loads((REPO / "perfbench/traffic/gptvq.json").read_text())
    qmix.update(sequences=4, tokens=32, chunk=2, warm_experts=2,
                check_experts=2)
    (tmp / "perfbench/traffic/tinyquant.json").write_text(json.dumps(qmix))
    (tmp / "perfbench/limits" / f"{QCELL}.json").write_text(
        json.dumps(QLIMITS))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    spec["configs"] += [
        dict(configs["qwen2-72b"], name="tiny",
             file="perfbench/configs/tiny.json"),
        dict(configs["qwen3-moe-30b-a3b"], name="tinymoe",
             file="perfbench/configs/tinymoe.json")]
    spec["workloads"] += [
        dict(cells["qwen2-72b.chat"], name=CELL, config="tiny",
             traffic="tinychat"),
        dict(cells["qwen3-moe-30b-a3b.gptvq"], name=QCELL,
             config="tinymoe", traffic="tinyquant")]
    twin = {"qwen2-72b.chat": CELL, "qwen3-moe-30b-a3b.gptvq": QCELL}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                twin[w] for w in m["workloads"] if w in twin]
    spec["end_to_end"].append({
        "name": DUMMY_METRIC, "unit": "requests", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(root: Path, seed: int = 2 ** 31 + 77, seconds: float = 2.0,
        cell: str = CELL):
    """(cell, run record, result line) of a tiny cell on the CPU."""
    import time

    import torch

    from perfbench import bench

    torch.set_num_threads(1)  # tiny tensors: threads only contend
    cell = bench.load_cell(root, cell)
    rec = bench.runner(cell.mix["kind"]).run(
        cell, seed=seed, seconds=seconds, trace=False,
        device=torch.device("cpu"), t_start=time.perf_counter())
    return cell, rec, bench.result_line(cell, rec, False)
