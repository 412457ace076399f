"""The profiler slice's reading: device busy time as the union of device
intervals inside the slice, idle gaps named by the innermost host range
open across them, kernels summed by name. On a card, the slice of a real
loop of launches."""
import pytest

from perfbench import trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_synthetic_trace():
    evs = [_ev("user_annotation", trace.SLICE, 100.0, 100.0),
           _ev("cpu_op", "aten::mm", 100.0, 20.0),
           _ev("kernel", "vqdm_tc_kernel", 110.0, 30.0),
           _ev("kernel", "vqdm_tc_kernel", 120.0, 30.0),   # overlaps
           _ev("cpu_op", "engine.step", 150.0, 40.0),
           _ev("cpu_op", "aten::item", 160.0, 10.0),
           _ev("gpu_memcpy", "Memcpy DtoH", 175.0, 5.0),
           _ev("kernel", "paged_split_kernel", 190.0, 20.0),  # clipped
           _ev("kernel", "outside", 300.0, 5.0)]
    s = trace.summarize({"traceEvents": evs})
    assert s.window_s == pytest.approx(100e-6)
    # busy: [110, 150) + [175, 180) + [190, 200)
    assert s.busy_s == pytest.approx(55e-6)
    assert s.kernel_seconds("vqdm_") == pytest.approx(60e-6)
    assert s.kernel_calls("vqdm_") == 2
    assert s.kernel_seconds("paged_split") == pytest.approx(10e-6)
    assert "outside" not in s.kernels
    gaps = dict((what, sec) for sec, what in s.gaps)
    assert gaps["aten::item"] == pytest.approx(25e-6)   # [150, 175)
    assert gaps["aten::mm"] == pytest.approx(10e-6)      # [100, 110)
    assert gaps["engine.step"] == pytest.approx(10e-6)   # [180, 190)
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "vqdm_tc_kernel"
    assert bd["idle_gaps"][0] == ["aten::item", pytest.approx(25e-6)]


def test_slice_without_bounds_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize({"traceEvents": [_ev("kernel", "k", 0.0, 1.0)]})


@pytest.mark.cuda
def test_profiled_slice_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    with trace.profiled() as sl:
        for _ in range(20):
            a = a @ a
            a = a / a.norm()
    s = sl.summary
    assert 0 < s.busy_s <= s.window_s
    assert sum(n for n, _ in s.kernels.values()) >= 40
