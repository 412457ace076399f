"""Telemetry facade (port of ``repro/obs/telemetry.py``): one object
bundling the metrics registry, span timer, JSONL event log, and
per-request lifecycle records.

The serving engine owns exactly one of these (constructing its own when
the caller passes none). ``Telemetry(enabled=False)`` hands out null
instruments and a disabled event log, so the instrumentation's own cost
can be measured.

Request lifecycle (engine-facing API)
-------------------------------------
``on_enqueue`` / ``on_admit`` / ``on_token`` / ``on_preempt`` /
``on_finish`` / ``on_reject`` keep a ``RequestRecord`` per rid, emit the
matching JSONL events, and feed the aggregate TTFT / inter-token-latency
histograms. Finished records move to a drain queue:
``drain_finished()`` returns-and-clears them, so a serving loop can
stream completed-request stats without unbounded growth.

Preemption is recompute-style (discard + replay), so a preempt resets
the victim's token count and first-token time; the invariant
``sum(record.tokens) == engine token counter`` holds at every tick and
is fuzz-tested.

Ticks
-----
``on_tick`` keeps the engine's record of each tick (``TickRecord``) in
``RECENT_TICKS``, the process's most recent ticks, which outlive the
engine: a reader picks the ticks of a time window on the host's
``perf_counter`` clock (the benchmark's window, say) and reads their wall
and device times as they were, once their device spans have been read.
"""
from __future__ import annotations

import collections
import json

from repro_torch.obs.dispatch import snapshot_dispatch_counters
from repro_torch.obs.events import EventLog, RequestRecord, TickRecord
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry
from repro_torch.obs.spans import SpanTimer

# the process's most recent engine ticks, oldest first: 32,768 of them
# cover a 50 s window down to 1.5 ms ticks
RECENT_TICKS: collections.deque = collections.deque(maxlen=1 << 15)


class Telemetry:
    def __init__(self, *, enabled: bool = True,
                 events_out: str | None = None,
                 trace_dir: str | None = None):
        self.enabled = enabled
        self.registry = MetricsRegistry(enabled=enabled)
        self.spans = SpanTimer(self.registry)
        self.events = EventLog(events_out, enabled=enabled)
        self.trace_dir = trace_dir
        self.records: dict[int, RequestRecord] = {}
        self._finished: list[RequestRecord] = []
        # pre-bound aggregate instruments (hot-path: no dict lookups)
        self._ttft = self.registry.histogram("serve.ttft_s",
                                             LATENCY_BUCKETS_S)
        self._itl = self.registry.histogram("serve.itl_s",
                                            LATENCY_BUCKETS_S)
        self._tok = self.registry.counter("serve.tokens")

    # -- device profiler -----------------------------------------------------

    def start_trace(self):
        if self.enabled and self.trace_dir:
            self.spans.start_trace(self.trace_dir)

    def stop_trace(self):
        self.spans.stop_trace()

    # -- request lifecycle ---------------------------------------------------

    def on_enqueue(self, rid: int, prompt_len: int, max_new_tokens: int):
        if not self.enabled:
            return
        rec = self.records.get(rid)
        if rec is None:
            rec = self.records[rid] = RequestRecord(
                rid=rid, prompt_len=prompt_len,
                max_new_tokens=max_new_tokens)
        rec.enqueue_ts = self.events.now()
        self.registry.counter("serve.requests_enqueued").inc()
        self.events.emit("enqueue", rid=rid, prompt_len=prompt_len,
                         max_new_tokens=max_new_tokens)

    def on_reject(self, rid: int, error: str):
        if not self.enabled:
            return
        rec = self.records.pop(rid, RequestRecord(rid=rid))
        rec.finish_ts = self.events.now()
        rec.finish_reason = "rejected"
        self._finished.append(rec)
        self.registry.counter("serve.requests_rejected").inc()
        self.events.emit("reject", rid=rid, error=error)

    def on_prefix_hit(self, rid: int, pages: int, tokens: int):
        """An admitted request's prompt prefix was served from shared
        blocks: ``pages`` full pages / ``tokens`` prompt tokens skipped
        prefill entirely."""
        if not self.enabled:
            return
        self.registry.counter("serve.prefix_hits").inc()
        self.registry.counter("serve.prefix_hit_tokens").inc(tokens)
        self.events.emit("prefix_hit", rid=rid, pages=pages, tokens=tokens)

    def on_admit(self, rid: int, slot: int):
        if not self.enabled:
            return
        rec = self.records.get(rid)
        if rec is None:  # direct scheduler.submit callers skip enqueue
            rec = self.records[rid] = RequestRecord(rid=rid)
            rec.enqueue_ts = self.events.now()
        rec.admit_ts = self.events.now()
        self.registry.counter("serve.requests_admitted").inc()
        self.events.emit("admit", rid=rid, slot=slot)

    def on_token(self, rid: int):
        if not self.enabled:
            return
        rec = self.records.get(rid)
        if rec is None:
            return
        now = self.events.now()
        if rec.first_token_ts is None:
            rec.first_token_ts = now
            if rec.enqueue_ts is not None:
                self._ttft.observe(now - rec.enqueue_ts)
                self.events.emit("first_token", rid=rid,
                                 ttft_s=round(now - rec.enqueue_ts, 6))
        elif rec.last_token_ts is not None:
            self._itl.observe(now - rec.last_token_ts)
        rec.last_token_ts = now
        rec.tokens += 1
        self._tok.inc()

    def on_preempt(self, rid: int):
        if not self.enabled:
            return
        rec = self.records.get(rid)
        if rec is None:
            return
        discarded = rec.tokens
        self._tok.inc(-discarded)
        rec.on_preempt()
        self.registry.counter("serve.preemptions").inc()
        self.events.emit("preempt", rid=rid, tokens_discarded=discarded)

    def on_finish(self, rid: int, reason: str):
        if not self.enabled:
            return
        rec = self.records.pop(rid, None)
        if rec is None:
            return
        rec.finish_ts = self.events.now()
        rec.finish_reason = reason
        self._finished.append(rec)
        self.registry.counter("serve.requests_finished").inc()
        self.events.emit(
            "finish", rid=rid, tokens=rec.tokens, reason=reason,
            ttft_s=rec.ttft_s, itl_mean_s=rec.itl_mean_s,
            preemptions=rec.preemptions)

    def on_tick(self, rec: TickRecord):
        """A tick ended: keep its record in ``RECENT_TICKS`` (its device
        spans may still be pending)."""
        if self.enabled:
            RECENT_TICKS.append(rec)

    # -- drain / export ------------------------------------------------------

    def request_token_total(self) -> int:
        """Tokens currently credited across live + finished records (the
        fuzz-tested twin of the engine's token counter)."""
        return (sum(r.tokens for r in self.records.values())
                + sum(r.tokens for r in self._finished))

    def drain_finished(self) -> list[RequestRecord]:
        out, self._finished = self._finished, []
        return out

    def metrics_snapshot(self) -> dict:
        """Registry metrics + kernel dispatch counters, JSON-able."""
        return {"metrics": self.registry.snapshot(),
                "dispatch": snapshot_dispatch_counters()}

    def write_metrics(self, path: str):
        with open(path, "w") as f:
            json.dump(self.metrics_snapshot(), f, indent=2)

    def close(self):
        self.stop_trace()
        self.events.close()
