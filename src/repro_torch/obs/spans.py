"""Trace spans: context-manager wall-clock timers with nesting (port of
``repro/obs/spans.py``).

``SpanTimer.span("decode_tick")`` times a host-side phase and records it
into the owning registry under ``span.<dotted/path>``; nested spans record
their full path (``span.decode_tick/host_prep``), so a snapshot reads as a
flame-graph-shaped breakdown of fixed-bucket latency histograms.

Device alignment: while a profiler trace is running (``start_trace`` /
``--trace-dir``), every span also enters a
``torch.profiler.record_function`` range named by its path, so host spans
line up with the CUDA kernels in the trace (the reference uses
``jax.profiler.StepTraceAnnotation``). With no trace a span costs two
``perf_counter`` calls and one histogram observe.

Spans do NOT synchronize the device: CUDA launches are asynchronous, so a
span around a bare launch measures host time only. A phase that should
account device time contains its own sync point (the engine's decode tick
does: it copies the sampled tokens to the host before the span closes).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry


class SpanTimer:
    def __init__(self, registry: MetricsRegistry, step_ref=None):
        self.registry = registry
        self._stack: list[str] = []
        self._profiler = None
        # optional 0-arg callable giving the current step number (the
        # engine's tick), appended to each profiler range's label
        self._step_ref = step_ref

    # -- profiler integration ------------------------------------------------

    def start_trace(self, trace_dir: str):
        """Begin a ``torch.profiler`` trace (CPU, and CUDA where there is a
        card) that writes a TensorBoard/Chrome trace into ``trace_dir`` when
        it stops."""
        import torch

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

    @contextmanager
    def span(self, name: str):
        if "/" in name:
            raise ValueError(f"span names must be single segments: {name!r}")
        self._stack.append(name)
        path = "/".join(self._stack)
        rng = None
        if self._profiler is not None:
            import torch

            step = self._step_ref() if self._step_ref is not None else None
            label = path if step is None else f"{path}#{step}"
            rng = torch.profiler.record_function(label)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            popped = self._stack.pop()
            if popped != name:
                raise RuntimeError(f"span stack out of order: {popped!r} "
                                   f"closed as {name!r}")
            self.registry.histogram(f"span.{path}",
                                    LATENCY_BUCKETS_S).observe(dt)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` under a span; returns its result."""
        with self.span(name):
            return fn(*args, **kwargs)
