"""Every configuration, mix, limit and metric reader that BENCHMARK.json
names loads by its name, and a cell, configuration, mix and metric can be
added as new files alone: the tiny cell of ``tiny.py`` lives in a
temporary directory and runs through the unchanged harness."""
import json

import pytest

import tiny
from tiny import REPO
from perfbench import bench

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_by_name(workload):
    cell = bench.load_cell(REPO, workload)
    assert cell.config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == cell.config_name)
    assert bench.runner(cell.mix["kind"]).run
    assert any(isinstance(v, (int, float)) for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(bench.reader(REPO, metric))


def test_config_files_state_their_cuts():
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]


def test_unknown_workload_is_refused():
    with pytest.raises(bench.CellError):
        bench.load_cell(REPO, "no.such-cell")


def test_a_cell_added_as_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    cell, rec, line = tiny.run(root)
    assert line["correct"] is True, line
    assert line["metrics"][tiny.DUMMY_METRIC]["value"] == len(rec.reqs)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks"
    assert line["checks"]["logit_gap_max"]["limit"] == 0.05


def test_a_quantize_cell_added_as_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    cell, rec, line = tiny.run(root, cell=tiny.QCELL)
    assert line["correct"] is True, line
    assert set(line["metrics"]) == {"quant_weights_per_s", "setup_s"}
    assert line["attempted"] == len(rec.window_targets()) > 0
    assert {k: v["limit"] for k, v in line["checks"].items()} == \
        dict(tiny.QLIMITS, layout_mismatches=0)
