"""Port parity for ``obs/``: the port's metric snapshots and JSONL event
streams pass the reference's own schema validators
(``validate_metrics_snapshot``, ``read_jsonl``/``validate_event``); the
instruments behave as the reference's on the same observations; an engine
run keeps ``sum(record.tokens)`` equal to its token counter, through
preemption; spans nest, and become profiler ranges under ``--trace-dir``
or any other profiler; the engine's device-clocked spans, tick histogram
and tick records add up as the benchmark reads them.
"""
import collections
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
    Telemetry, TickRecord, dispatch, read_jsonl, validate_metrics_snapshot)
from repro_torch.obs import telemetry as telemetry_mod
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
    spans = SpanTimer(reg)
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


def _serve(model, params, telemetry):
    """Four requests through a two-slot engine: admissions, multi-chunk
    prefills, prompt samples and decode ticks all happen."""
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=4,
                 prefill_chunk=8, telemetry=telemetry, device="cpu")
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, 255, size=s),
                    max_new_tokens=5) for i, s in enumerate((19, 6, 11, 3))]
    eng.run(reqs)
    return eng


def test_engine_device_spans_and_tick_histogram(dense, monkeypatch):
    """Each device-clocked span is counted once a tick that ran its phase,
    ``serve.tick_s`` once a tick, its sum the engine's ``wall_s``, and the
    snapshot passes both validators."""
    model, params = dense
    admit_ticks, chunk_ticks, sample_ticks = set(), set(), set()
    real_step = Engine.step
    real_chunk, real_done = Engine._prefill_chunk, Engine._on_prompt_done

    def step(self):
        if self.scheduler.queue:
            admit_ticks.add(self.ticks)
        return real_step(self)

    def chunk(self, *a):
        chunk_ticks.add(self.ticks)
        return real_chunk(self, *a)

    def prompt_done(self, *a):
        sample_ticks.add(self.ticks)
        return real_done(self, *a)

    monkeypatch.setattr(Engine, "step", step)
    monkeypatch.setattr(Engine, "_prefill_chunk", chunk)
    monkeypatch.setattr(Engine, "_on_prompt_done", prompt_done)
    tel = Telemetry()
    eng = _serve(model, params, tel)
    snap = json.loads(json.dumps(tel.metrics_snapshot()["metrics"]))
    validate_metrics_snapshot(snap)
    j_validate_snapshot(snap)
    st = eng.stats
    counts = {k[len("span_device."):]: v["count"] for k, v in snap.items()
              if k.startswith("span_device.")}
    assert counts == {"admit": len(admit_ticks), "prefill": len(chunk_ticks),
                      "prompt_sample": len(sample_ticks),
                      "decode_tick/device": st["decode_ticks"]}
    assert len(sample_ticks) == 4 and st["prefill_chunks"] > len(chunk_ticks)
    assert 0 < len(admit_ticks) < st["ticks"]
    assert snap["serve.tick_s"]["count"] == eng.ticks
    assert snap["serve.tick_s"]["sum"] == st["wall_s"]
    assert tel.spans.pending == 0


def test_engine_tick_records_match_the_registry(dense, monkeypatch):
    """``Telemetry.on_tick`` keeps one record a tick in ``RECENT_TICKS``:
    their wall times are ``serve.tick_s``'s, their device times each
    ``span_device.*`` histogram's, their chunks the engine's, in tick
    order and none pending; a disabled telemetry keeps none."""
    model, params = dense
    monkeypatch.setattr(telemetry_mod, "RECENT_TICKS",
                        collections.deque())
    tel = Telemetry()
    eng = _serve(model, params, tel)
    recs = list(telemetry_mod.RECENT_TICKS)
    snap = tel.registry.snapshot()
    assert len(recs) == eng.ticks == snap["serve.tick_s"]["count"]
    assert sum(r.wall_s for r in recs) == pytest.approx(
        snap["serve.tick_s"]["sum"], rel=1e-12)
    assert all(a.t < b.t for a, b in zip(recs, recs[1:]))
    assert sum(r.chunks for r in recs) == eng.stats["prefill_chunks"]
    assert not any(r.pending for r in recs)
    for name, h in snap.items():
        if name.startswith("span_device."):
            path = name[len("span_device."):]
            assert sum(r.device_s.get(path, 0.0) for r in recs) == (
                pytest.approx(h["sum"], rel=1e-12))
            assert sum(path in r.device_s for r in recs) == h["count"]
    assert all(r.wall_s >= sum(r.device_s.values()) for r in recs)
    telemetry_mod.RECENT_TICKS.clear()
    _serve(model, params, Telemetry(enabled=False))
    assert not telemetry_mod.RECENT_TICKS


def test_spans_name_ranges_in_an_outside_profiler(dense, tmp_path):
    """Under a profiler the engine did not start, its spans are
    ``user_annotation`` ranges named by the span path alone."""
    model, params = dense
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(model, params, Telemetry())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"admit", "prefill", "prompt_sample", "decode_tick/host_prep",
            "decode_tick/device"} <= names
    assert not any("#" in n for n in names)


def test_disabled_telemetry_makes_no_events(dense, monkeypatch):
    model, params = dense

    def no_event(*a, **k):
        raise AssertionError("a disabled registry made a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tel = Telemetry(enabled=False)
    _serve(model, params, tel)
    assert tel.metrics_snapshot()["metrics"] == {}
    assert tel.spans.pending == 0
    with tel.spans.span("tick", device=torch.device("cuda")):
        pass
    assert tel.spans.pending == 0 and tel.registry.snapshot() == {}


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: completes when ``done`` is set;
    its time is ``clock`` (ms) at ``record``."""
    clock, made = 0, []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.made.append(self)
        self.done, self.t = False, None

    def record(self, stream=None):
        self.done, self.t = False, self.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_spans_collect_without_waiting(monkeypatch):
    """The CUDA path with events that complete when told: a pair whose end
    has not completed stays pending, a completed one is read in seconds,
    and its events are reused; nothing synchronises."""
    def no_sync(*a, **k):
        raise AssertionError("the span timer synchronised the device")

    monkeypatch.setattr(_FakeEvent, "made", [])
    monkeypatch.setattr(_FakeEvent, "clock", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    reg = MetricsRegistry()
    spans = SpanTimer(reg)
    cuda = torch.device("cuda")
    rec = TickRecord()
    with spans.span("tick", device=cuda, into=rec):
        _FakeEvent.clock += 3
    spans.collect()
    assert spans.pending == 1 and "span_device.tick" not in reg.snapshot()
    assert rec.pending == 1 and rec.device_s == {}
    for ev in _FakeEvent.made:
        ev.done = True
    spans.collect()
    assert spans.pending == 0 and rec.pending == 0
    assert reg.snapshot()["span_device.tick"]["sum"] == pytest.approx(3e-3)
    assert rec.device_s == {"tick": pytest.approx(3e-3)}
    with spans.span("tick", device=cuda):
        pass
    assert len(_FakeEvent.made) == 2 and spans.pending == 1


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
