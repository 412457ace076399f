"""Zero-dependency metrics registry (port of ``repro/obs/metrics.py``;
snapshot schema identical): counters, gauges, fixed-bucket
histograms, JSON-snapshot export.

Design constraints (this is the hot-path measurement layer for the
serving engine, so they are load-bearing):

* **Cheap instruments.** ``Counter.inc`` / ``Gauge.set`` are one python
  attribute update; ``Histogram.observe`` is a ``bisect`` over a short
  static bucket list. No locks (the engine is single-threaded host code),
  no label cardinality machinery, no background threads.
* **Disabled == free.** A registry built with ``enabled=False`` hands out
  a shared null instrument whose methods are no-ops, so
  ``Engine(telemetry=Telemetry(enabled=False))`` measures the true cost
  of the instrumentation itself.
* **Snapshots are plain JSON.** ``snapshot()`` returns nested dicts of
  numbers only — writable with ``json.dump``, diffable across ticks, and
  schema-checked by tests/obs and the CI metrics smoke step.

Instruments are get-or-create by name: ``registry.counter("tokens")``
returns the same object every call, so callers never need to pre-declare.
"""
from __future__ import annotations

import json
from bisect import bisect_right

# Default latency buckets (seconds): log-spaced 100us .. 30s, the range a
# host-side serving phase (upload, tick, prefill chunk) can plausibly take.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# Small-integer buckets (queue depths, chunk widths, page counts).
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1):
        self.value += n

    def to_json(self):
        return self.value


class Gauge:
    """Last-write-wins point-in-time value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def to_json(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram: counts per upper-edge bucket + overflow,
    plus exact sum/count/min/max so means survive the bucketing."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(buckets)
        assert list(self.buckets) == sorted(self.buckets), "unsorted buckets"
        self.counts = [0] * (len(self.buckets) + 1)  # +1 overflow
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        self.counts[bisect_right(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding
        the q-th observation; the overflow bucket reports the exact max)."""
        assert 0.0 <= q <= 1.0
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.max)
        return self.max

    def to_json(self):
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": self.min, "max": self.max, "mean": self.mean,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class _Null:
    """Shared no-op instrument handed out by a disabled registry."""

    __slots__ = ()
    value = 0
    sum = 0.0
    count = 0
    mean = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return 0.0

    def to_json(self):
        return None


_NULL = _Null()


class MetricsRegistry:
    """Flat name -> instrument map with get-or-create accessors."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, factory):
        if not self.enabled:
            return _NULL
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory()
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._get(name, lambda: Histogram(buckets))

    def reset(self):
        self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able {name: value-or-histogram-dict}, sorted by name."""
        return {k: self._metrics[k].to_json()
                for k in sorted(self._metrics)}

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)


def validate_metrics_snapshot(snap: dict):
    """Schema check for a ``snapshot()`` payload (CI metrics smoke +
    tests/obs). Raises ValueError on the first violation."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be a dict, got {type(snap)}")
    for name, v in snap.items():
        if not isinstance(name, str):
            raise ValueError(f"metric name {name!r} is not a string")
        if isinstance(v, (int, float)) or v is None:
            continue
        if isinstance(v, dict):
            missing = {"buckets", "counts", "sum", "count"} - set(v)
            if missing:
                raise ValueError(f"histogram {name!r} missing {missing}")
            if len(v["counts"]) != len(v["buckets"]) + 1:
                raise ValueError(
                    f"histogram {name!r}: counts must have one overflow "
                    f"slot past the bucket edges")
            if sum(v["counts"]) != v["count"]:
                raise ValueError(f"histogram {name!r}: bucket counts do "
                                 f"not sum to count")
            continue
        raise ValueError(f"metric {name!r} has unsupported value {v!r}")
