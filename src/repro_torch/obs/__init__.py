"""Telemetry subsystem (port of ``repro/obs``): metrics registry, trace
spans, JSONL event stream, per-request latency records and dispatch
counters. The serving engine reports into it (obs/telemetry.py is the
facade it owns); ``launch/serve.py`` exposes ``--events-out``,
``--metrics-out`` and ``--trace-dir``. The quantization pipeline's
``telemetry=`` (core/pipeline.quantize_model) adds its stage spans and
``quant_stage`` / ``quant_target`` events, which the quantize launcher's
``--events-out`` and ``--metrics-out`` write. ``obs/work`` is the dry
run's count of kernel work and collective bytes (``launch/dryrun``).
"""
from repro_torch.obs.dispatch import (
    register_dispatch,
    reset_dispatch_counters,
    snapshot_dispatch_counters,
)
from repro_torch.obs.events import (
    EVENT_FIELDS,
    EventLog,
    RequestRecord,
    read_jsonl,
    validate_event,
)
from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    validate_metrics_snapshot,
)
from repro_torch.obs.spans import SpanTimer
from repro_torch.obs.telemetry import Telemetry

__all__ = [
    "COUNT_BUCKETS",
    "Counter",
    "EVENT_FIELDS",
    "EventLog",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "RequestRecord",
    "SpanTimer",
    "Telemetry",
    "read_jsonl",
    "register_dispatch",
    "reset_dispatch_counters",
    "snapshot_dispatch_counters",
    "validate_event",
    "validate_metrics_snapshot",
]
