"""Port parity for ``obs/``: the port's metric snapshots and JSONL event
streams pass the reference's own schema validators
(``validate_metrics_snapshot``, ``read_jsonl``/``validate_event``); the
instruments behave as the reference's on the same observations; an engine
run keeps ``sum(record.tokens)`` equal to its token counter, through
preemption; spans nest, and become profiler ranges under ``--trace-dir``.
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import EVENT_FIELDS as J_EVENT_FIELDS
from repro.obs import Histogram as JHistogram
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import read_jsonl as j_read_jsonl
from repro.obs import validate_event as j_validate_event
from repro.obs import validate_metrics_snapshot as j_validate_snapshot

from repro_torch.configs import SMOKE
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_zoo
from repro_torch.obs import (
    EVENT_FIELDS, Histogram, MetricsRegistry, RequestRecord, SpanTimer,
    Telemetry, dispatch, read_jsonl, validate_metrics_snapshot)
from repro_torch.serve.engine import Engine, Request

SMOKE_KW = dict(dtype="float32", n_layers=2, d_model=64, vocab_size=256,
                max_seq_len=64)


@pytest.fixture(scope="module")
def dense():
    cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = model_zoo.build(cfg)
    return model, model.init_params(seed=0, device="cpu")


def test_instruments_match_reference():
    obs = (0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 100.0, 0.0)
    mine, ref = Histogram((1.0, 2.0, 4.0)), JHistogram((1.0, 2.0, 4.0))
    for v in obs:
        mine.observe(v)
        ref.observe(v)
    assert mine.to_json() == ref.to_json()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q)
    regs = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("tokens").inc(5)
        reg.gauge("depth").set(3)
        reg.histogram("lat").observe(0.01)
        regs.append(json.loads(json.dumps(reg.snapshot())))
    assert regs[0] == regs[1]
    assert MetricsRegistry(enabled=False).snapshot() == {}


def test_engine_snapshot_and_events_pass_reference_schema(dense, tmp_path):
    """An engine run with a tight pool (preemptions), a prefix cache, a
    rejected request and forks: its metrics snapshot passes the reference's
    validator, every JSONL event the reference's, and the request records'
    tokens sum to the engine's counter."""
    model, params = dense
    path = tmp_path / "events.jsonl"
    tel = Telemetry(events_out=str(path))
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=4,
                 num_blocks=9, prefix_cache=True, paged_attn_impl="fused",
                 telemetry=tel, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, 255, size=s),
                    max_new_tokens=8) for i, s in enumerate((10, 14, 7))]
    reqs.append(Request(rid=3, prompt=rng.randint(0, 255, size=60),
                        max_new_tokens=30))          # never fits: rejected
    reqs.append(Request(rid=4, prompt=rng.randint(0, 255, size=9),
                        max_new_tokens=3, n=2))      # one fork
    eng.run(reqs)
    assert eng.stats["preemptions"] > 0
    assert reqs[3].error and all(r.done for r in reqs)
    records = eng.drain_request_records()
    assert sum(r.tokens for r in records) == eng.stats["tokens"]
    assert tel.request_token_total() == 0  # all drained
    assert eng.stats["tokens"] == sum(len(r.out_tokens) for r in reqs
                                      + reqs[4].forks)
    snap = json.loads(json.dumps(tel.metrics_snapshot()))
    validate_metrics_snapshot(snap["metrics"])
    j_validate_snapshot(snap["metrics"])
    assert snap["metrics"]["serve.tokens"] == eng.stats["tokens"]
    assert {"paged", "vq"} <= set(snap["dispatch"])
    assert "span.decode_tick/device" in snap["metrics"]
    tel.close()
    events = j_read_jsonl(str(path))
    assert read_jsonl(str(path)) == events
    kinds = {e["event"] for e in events}
    assert {"enqueue", "admit", "first_token", "preempt", "finish",
            "reject", "prefix_hit"} <= kinds
    for e in events:
        j_validate_event(e)
    assert EVENT_FIELDS == J_EVENT_FIELDS


def test_request_record_lifecycle_and_preempt_reset():
    rec = RequestRecord(rid=1, enqueue_ts=0.0)
    rec.first_token_ts, rec.last_token_ts, rec.tokens = 1.0, 3.0, 3
    assert rec.ttft_s == 1.0 and rec.itl_mean_s == 1.0
    rec.on_preempt()
    assert rec.tokens == 0 and rec.ttft_s is None and rec.preemptions == 1


def test_spans_nest_and_trace_with_the_profiler(tmp_path):
    reg = MetricsRegistry()
    spans = SpanTimer(reg, step_ref=lambda: 7)
    spans.start_trace(str(tmp_path))
    with spans.span("tick"):
        with spans.span("device"):
            torch.ones(4).sum()
    spans.stop_trace()
    assert set(reg.snapshot()) == {"span.tick", "span.tick/device"}
    assert any(tmp_path.iterdir())  # the trace was written
    with pytest.raises(ValueError):
        with spans.span("a/b"):
            pass
    assert spans.current_path == ""


def test_dispatch_registry_is_live_and_resets_in_place():
    counts = dispatch.register_dispatch("test_src", ("a", "b"))
    assert dispatch.register_dispatch("test_src", ("a",)) is counts
    counts["a"] += 2
    snap = dispatch.snapshot_dispatch_counters()
    assert snap["test_src"] == {"a": 2, "b": 0}
    snap["test_src"]["a"] = 99
    assert counts["a"] == 2
    dispatch.reset_dispatch_counters()
    assert counts == {"a": 0, "b": 0}


def test_serve_launcher_on_cpu(tmp_path, capsys):
    """The SKILL command: the packed smoke model served through both fused
    paths, with the metrics snapshot the reference's validator accepts."""
    metrics = tmp_path / "m.json"
    eng, reqs = launch_serve.main([
        "--arch", "llama2-7b", "--smoke", "--vq", "--device", "cpu",
        "--paged-attn-impl", "fused", "--vq-matmul-impl", "fused",
        "--requests", "4", "--max-new", "8", "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    assert "served 4 requests, 32 tokens" in out and "device=cpu" in out
    assert all(len(r.out_tokens) == 8 for r in reqs)
    snap = json.loads(metrics.read_text())
    j_validate_snapshot(snap["metrics"])
    assert snap["dispatch"]["vq"]["fused"] > 0


def test_serve_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "llama2-7b", "--smoke"])
