"""A ``torch.profiler`` slice of the measured window, read back from its
Chrome trace: every device operation's interval, and the host's operations
and the harness's own spans around them.

The slice opens and closes on a synchronised boundary of the harness's
loop (each engine tick ends by copying its tokens to the host), inside a
``record_function`` range named ``perfbench.slice``, so the slice's
bounds, the kernels and the host ranges share one clock. The trace is
written under ``TMPDIR`` and deleted once read.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

SLICE = "perfbench.slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Summary:
    """What a slice holds: ``window_s`` its length, ``busy_s`` the time
    some device operation ran, ``kernels`` {name: [calls, seconds]},
    ``gaps`` [(seconds, what the host was doing)] of every idle interval,
    longest first."""

    def __init__(self, window_s, busy_s, kernels, gaps):
        self.window_s, self.busy_s = window_s, busy_s
        self.kernels, self.gaps = kernels, gaps

    def kernel_seconds(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(p in name for p in patterns))

    def kernel_calls(self, *patterns: str) -> int:
        return sum(n for name, (n, _) in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[_short(n), s] for n, (_, s) in ops],
                "idle_gaps": [[what, s] for s, what in self.gaps[:top]]}


def _short(name: str, n: int = 96) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[: n - 3] + "..."


@contextlib.contextmanager
def profiled():
    """Profile the block (CPU and CUDA activities); yields a holder whose
    ``summary`` (and ``trace_bytes``, the Chrome trace's size) are set once
    the block has ended and the trace is read."""
    holder = type("Slice", (), {"summary": None, "trace_bytes": 0})()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        with torch.profiler.record_function(SLICE):
            yield holder
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    holder.summary = summarize(events)


def summarize(trace: dict) -> Summary:
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, host, bounds = [], [], None
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        t0, dur = float(e["ts"]), float(e["dur"])
        if cat in _DEVICE_CATS:
            dev.append((t0, t0 + dur, e.get("name", "?")))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime"):
            if e.get("name") == SLICE and cat == "user_annotation":
                bounds = (t0, t0 + dur)
            else:
                host.append((t0, t0 + dur, e.get("name", "?")))
    if bounds is None:
        raise RuntimeError(f"profiler trace has no {SLICE!r} range")
    lo, hi = bounds
    kernels: dict = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
        clipped.append((a, b))
    clipped.sort()
    busy, gaps = 0.0, []
    end = lo
    for a, b in clipped:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    host.sort()
    starts = [h[0] for h in host]
    labelled = [((b - a) * 1e-6, _host_at(host, starts, (a + b) / 2))
                for a, b in gaps]
    labelled.sort(key=lambda g: -g[0])
    return Summary((hi - lo) * 1e-6, busy * 1e-6, kernels, labelled)


def _host_at(host, starts, t) -> str:
    """The innermost host range open at ``t`` (the latest-starting one that
    covers it), or "host: no operation"."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 4000), -1):
        a, b, name = host[j]
        if b >= t:
            best = name
            break
    return _short(best, 64) if best else "host: no operation"
