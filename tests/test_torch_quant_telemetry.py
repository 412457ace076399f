"""Port parity for ``quantize_model(telemetry=)`` and the quantize
launcher's ``--events-out`` / ``--metrics-out``: the stage split surfaces as
``span.quant/<stage>`` metrics (the port's case of
``tests/core/test_budget_solvers.py::TestPipelineIntegration::
test_stage_seconds_splits_em_init_from_column_sweep``); the ``quant_stage``
and ``quant_target`` events pass the reference's validators and have the
reference's names and fields, in the reference's order, on the same run;
the launcher's files pass the reference's schema checks.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.pipeline import quantize_model as j_quantize_model
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import Quantize as JQuantize
from repro.models import model_zoo as jzoo
from repro.obs import Telemetry as JTelemetry
from repro.obs import read_jsonl as j_read_jsonl
from repro.obs import validate_event as j_validate_event
from repro.obs import validate_metrics_snapshot as j_validate_snapshot

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe, Quantize
from repro_torch.launch import quantize as launch_quantize
from repro_torch.models import model_zoo
from repro_torch.obs import Telemetry

# the reference test's tiny model and its TINY action
CFG_KW = dict(name="bs-t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
              max_seq_len=128, dtype="float32", vocab_pad_multiple=64)
TINY_KW = dict(em_iters=4, codebook_update_iters=0)
STAGES = {"hessian_capture", "em_init", "column_sweep", "codebook_update",
          "advance"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_recipe():
    return QuantRecipe(rules=(), default=Quantize(dataclasses.replace(
        PAPER_SETTINGS["2.25bpv_2d"], **TINY_KW)))


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's tiny model quantized with telemetry: its params and
    calibration tokens (numpy) and its event stream."""
    cfg = JModelConfig(**CFG_KW)
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(16, 4)).astype(np.int32)
    path = str(tmp_path_factory.mktemp("ref_events") / "events.jsonl")
    tel = JTelemetry(events_out=path)
    recipe = JRecipe(rules=(), default=JQuantize(dataclasses.replace(
        JSETTINGS["2.25bpv_2d"], **TINY_KW)))
    j_quantize_model(model, params, jnp.asarray(calib), recipe=recipe,
                     chunk=4, telemetry=tel)
    tel.close()
    return dict(params=jax.tree.map(np.asarray, params), calib=calib,
                events=j_read_jsonl(path))


def _port_run(ref_run, telemetry):
    cfg = ModelConfig(**CFG_KW)
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_run["params"], cfg, device="cpu")
    return quantize_model(model, params,
                          torch.from_numpy(ref_run["calib"]).long(),
                          recipe=_tiny_recipe(), chunk=4,
                          telemetry=telemetry)


def test_stage_seconds_splits_em_init_from_column_sweep(ref_run):
    tel = Telemetry()
    _, rep = _port_run(ref_run, tel)
    assert set(rep.stage_seconds) == STAGES
    assert rep.stage_seconds["em_init"] > 0
    assert rep.stage_seconds["column_sweep"] > 0
    # the split surfaces in the span flame-graph metrics too
    metrics = tel.metrics_snapshot()["metrics"]
    for stage in STAGES:
        assert f"span.quant/{stage}" in metrics
    j_validate_snapshot(json.loads(json.dumps(metrics)))
    tel.close()


def test_quant_events_match_reference(ref_run, tmp_path):
    """Every event passes the reference's validator (read_jsonl validates
    each row), and the stream has the reference's events and fields in the
    reference's order: one quant_stage per (block, stage) call, one
    quant_target per target."""
    path = str(tmp_path / "events.jsonl")
    tel = Telemetry(events_out=path)
    _port_run(ref_run, tel)
    tel.close()
    got = j_read_jsonl(path)
    for e in got:
        j_validate_event(e)

    def key(e):
        return (e["event"], sorted(e), e.get("stage"), e.get("block"),
                e.get("name"), e.get("action"))

    want = ref_run["events"]
    assert [key(e) for e in got] == [key(e) for e in want]
    targets = [e for e in got if e["event"] == "quant_target"]
    stages = [e for e in got if e["event"] == "quant_stage"]
    assert len(targets) == 14 and {e["action"] for e in targets} == {
        "quantize"}
    # per block: capture, 7 x (em_init, column_sweep, codebook_update),
    # advance
    assert len(stages) == 2 * (2 + 7 * 3)
    assert {e["block"] for e in stages} == {"layer0", "layer1"}
    assert all(e["seconds"] >= 0 for e in got)


def test_launcher_events_and_metrics_out(tmp_path):
    events, metrics = tmp_path / "ev.jsonl", tmp_path / "m.json"
    launch_quantize.main([
        "--arch", "llama2-7b", "--smoke", "--device", "cpu", "--sequences",
        "4", "--seq-len", "16", "--em-iters", "2", "--update-iters", "1",
        "--out", str(tmp_path / "ckpt"), "--events-out", str(events),
        "--metrics-out", str(metrics)])
    evs = j_read_jsonl(str(events))
    assert sum(e["event"] == "quant_target" for e in evs) == 14
    assert {e["stage"] for e in evs if e["event"] == "quant_stage"} == STAGES
    snap = json.loads(metrics.read_text())
    j_validate_snapshot(snap["metrics"])
    assert {f"span.quant/{s}" for s in STAGES} <= set(snap["metrics"])
    assert "flash" in snap["dispatch"]
