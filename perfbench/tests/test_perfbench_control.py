"""Each cell kind's control at a size a test run holds: the plain
reference computed with float8 e4m3 operands (the precision below the
configurations' bf16), put in the program's place, fails the limit that
the program's run meets. On the card the same readings, at the cell's own
size, come from ``perfbench/control.py`` (PERF.md section 2)."""
import torch

import tiny
from perfbench import bench, judge
from perfbench.models import qwen2


def test_fp8_control_fails_where_the_program_passes(tmp_path):
    root = tiny.make_root(tmp_path)
    seed = 2 ** 31 + 77
    cell, rec, line = tiny.run(root, seed=seed)
    assert line["correct"] is True
    picked = judge.sample(rec.finished(), cell.mix["check_requests"], seed)
    raw = qwen2.weights(cell.config, seed, torch.device("cpu"))
    served = judge.served_gaps(cell.config, raw, picked)
    ctrl = judge.control_gaps(cell.config, raw, picked)
    limit = cell.limits["logit_gap_max"]
    assert float(served.max()) == line["checks"]["logit_gap_max"]["value"]
    assert float(served.max()) <= limit < float(ctrl.max())


def test_fp8_control_fails_where_the_quantizer_passes(tmp_path):
    root = tiny.make_root(tmp_path)
    seed = 2 ** 31 + 78
    cell, rec, line = tiny.run(root, seed=seed, cell=tiny.QCELL)
    assert line["correct"] is True
    ctrl = bench.runner(cell.mix["kind"]).control(cell, rec, seed,
                                                  torch.device("cpu"))
    limit = cell.limits["hessian_gap_max"]
    assert ctrl["program_hessian_gap_max"] <= limit
    assert ctrl["control_hessian_gap_max"] > limit
