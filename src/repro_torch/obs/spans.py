"""Trace spans: context-manager wall-clock timers with nesting (port of
``repro/obs/spans.py``), some of them also on the device's clock.

``SpanTimer.span("decode_tick")`` times a host-side phase and records it
into the owning registry under ``span.<dotted/path>``; nested spans record
their full path (``span.decode_tick/host_prep``), so a snapshot reads as a
flame-graph-shaped breakdown of fixed-bucket latency histograms.

Device alignment: while any ``torch.profiler`` is recording (this timer's
own ``start_trace`` / ``--trace-dir``, or one a caller runs around the
program), every span also enters a ``torch.profiler.record_function``
range named by its path, so host spans line up with the CUDA kernels in
the trace and one phase has one name (the reference uses
``jax.profiler.StepTraceAnnotation``). With no profiler a span costs two
``perf_counter`` calls, one flag read and one histogram observe.

Spans do NOT synchronize the device: CUDA launches are asynchronous, so a
span around a bare launch measures host time only. ``span(name,
device=dev)`` with a CUDA ``dev`` (and an enabled registry) also records a
timing ``torch.cuda.Event`` on the current stream at entry and at exit
(events are reused once collected);
``collect()`` reads every pair whose end event has completed
(``Event.query``, no wait) into ``span_device.<path>`` in seconds, and
keeps the rest for a later call. The span then also holds the device time
of what it launched. On a CPU ``dev`` the device duration is the host
duration, recorded at exit. ``span(name, device=dev, into=rec)`` also adds
the device seconds into ``rec.device_s[<path>]`` when they are read, and
counts the span in ``rec.pending`` until then (``events.TickRecord``: the
engine's record of one tick).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as autograd_profiler

from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry


class SpanTimer:
    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._stack: list[str] = []
        self._profiler = None
        # (path, start event, end event, into) of device spans not yet read,
        # and completed events for reuse (no event is created once warm)
        self._pending: list[tuple] = []
        self._free: list = []

    # -- profiler integration ------------------------------------------------

    def start_trace(self, trace_dir: str):
        """Begin a ``torch.profiler`` trace (CPU, and CUDA where there is a
        card) that writes a TensorBoard/Chrome trace into ``trace_dir`` when
        it stops."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir))
        self._profiler.__enter__()

    def stop_trace(self):
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)

    # -- spans ---------------------------------------------------------------

    @property
    def current_path(self) -> str:
        return "/".join(self._stack)

    @property
    def pending(self) -> int:
        """Device spans recorded and not yet collected."""
        return len(self._pending)

    def _event(self, stream):
        ev = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        ev.record(stream)
        return ev

    @contextmanager
    def span(self, name: str, device: torch.device | None = None,
             into=None):
        """Time the block under this span's path; ``device``: the device
        the block's work runs on, to time it on that device's clock too
        (``span_device.<path>``); ``into``: a record (``device_s``,
        ``pending``) that the device time is added into as well."""
        if "/" in name:
            raise ValueError(f"span names must be single segments: {name!r}")
        self._stack.append(name)
        path = "/".join(self._stack)
        rng = None
        if autograd_profiler._is_profiler_enabled:
            rng = torch.profiler.record_function(path)
            rng.__enter__()
        if not self.registry.enabled:
            into = None
        on_card = (device is not None and device.type == "cuda"
                   and self.registry.enabled)
        if on_card:
            stream = torch.cuda.current_stream(device)
            start = self._event(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if on_card:
                self._pending.append((path, start, self._event(stream), into))
                if into is not None:
                    into.pending += 1
            elif device is not None:
                self._device_time(path, dt, into)
            if rng is not None:
                rng.__exit__(None, None, None)
            popped = self._stack.pop()
            if popped != name:
                raise RuntimeError(f"span stack out of order: {popped!r} "
                                   f"closed as {name!r}")
            self.registry.histogram(f"span.{path}",
                                    LATENCY_BUCKETS_S).observe(dt)

    def collect(self):
        """Record every device span whose end event has completed into
        ``span_device.<path>`` (seconds); the others stay pending. Never
        waits for the device."""
        keep = []
        for pair in self._pending:
            path, start, end, into = pair
            if end.query():
                self._device_time(path, start.elapsed_time(end) * 1e-3, into)
                if into is not None:
                    into.pending -= 1
                self._free += (start, end)
            else:
                keep.append(pair)
        self._pending = keep

    def _device_time(self, path: str, s: float, into):
        self.registry.histogram(f"span_device.{path}",
                                LATENCY_BUCKETS_S).observe(s)
        if into is not None:
            into.device_s[path] = into.device_s.get(path, 0.0) + s

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` under a span; returns its result."""
        with self.span(name):
            return fn(*args, **kwargs)
