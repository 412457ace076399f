"""JSONL event stream + per-request lifecycle records (port of
``repro/obs/events.py``; schemas identical).

Events are flat JSON objects, one per line, each carrying ``ts`` (host
``perf_counter`` seconds relative to the log's epoch — monotonic,
subtraction-safe) and ``event`` (the type). The engine emits the request
lifecycle (enqueue -> admit -> first_token -> finish, plus preempt /
reject) and the quantization pipeline emits per-stage/per-target rows;
``EVENT_FIELDS`` is the schema the CI metrics smoke step and tests/obs
validate against.

``RequestRecord`` is the accumulated per-request view of those events:
TTFT (enqueue -> first sampled token), mean inter-token latency, token
count, preemption count, and finish reason. Preemption is recompute-style
in this engine (generated tokens are discarded and regenerated), so a
preempt RESETS the record's token count and first-token time — the
record describes the attempt that actually delivered tokens, and the sum
of record token counts stays equal to the engine's token counter (a
fuzz-tested invariant).
"""
from __future__ import annotations

import dataclasses
import json
import time

# event type -> required fields (beyond ts/event). Extra fields are
# allowed; missing ones fail validation.
EVENT_FIELDS: dict[str, tuple] = {
    "enqueue": ("rid", "prompt_len", "max_new_tokens"),
    "admit": ("rid", "slot"),
    "first_token": ("rid", "ttft_s"),
    "token": ("rid",),          # optional per-token stream (off by default)
    "preempt": ("rid", "tokens_discarded"),
    "finish": ("rid", "tokens", "reason", "ttft_s", "itl_mean_s",
               "preemptions"),
    "reject": ("rid", "error"),
    "prefix_hit": ("rid", "pages", "tokens"),
    "quant_stage": ("stage", "block", "seconds"),
    "quant_target": ("name", "action", "seconds"),
}

FINISH_REASONS = ("length", "eos", "rejected", "aborted")


def validate_event(ev: dict):
    """Raise ValueError unless ``ev`` matches the schema."""
    if not isinstance(ev, dict):
        raise ValueError(f"event must be a dict, got {type(ev)}")
    etype = ev.get("event")
    if etype not in EVENT_FIELDS:
        raise ValueError(f"unknown event type {etype!r}")
    if not isinstance(ev.get("ts"), (int, float)):
        raise ValueError(f"event {etype!r} missing numeric ts")
    missing = [f for f in EVENT_FIELDS[etype] if f not in ev]
    if missing:
        raise ValueError(f"event {etype!r} missing fields {missing}")
    if etype == "finish" and ev["reason"] not in FINISH_REASONS:
        raise ValueError(f"finish reason {ev['reason']!r} not in "
                         f"{FINISH_REASONS}")


class EventLog:
    """Append-only event sink: an in-memory ring (tests / drain API) plus
    an optional JSONL file. Disabled logs are free (emit returns at once).
    """

    def __init__(self, path: str | None = None, enabled: bool = True,
                 keep: int = 4096):
        self.enabled = enabled
        self.path = path
        self.keep = keep
        self.events: list[dict] = []
        self._fh = open(path, "w") if (enabled and path) else None
        self._epoch = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def emit(self, event: str, **fields):
        if not self.enabled:
            return
        ev = {"ts": round(self.now(), 6), "event": event, **fields}
        self.events.append(ev)
        if len(self.events) > self.keep:
            del self.events[: -self.keep]
        if self._fh is not None:
            self._fh.write(json.dumps(ev) + "\n")

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> list[dict]:
    """Load and validate a JSONL event file (CI smoke / tests)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            validate_event(ev)
            out.append(ev)
    return out


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle accumulator (timestamps in EventLog time)."""

    rid: int
    prompt_len: int = 0
    max_new_tokens: int = 0
    enqueue_ts: float | None = None
    admit_ts: float | None = None
    first_token_ts: float | None = None
    last_token_ts: float | None = None
    finish_ts: float | None = None
    tokens: int = 0
    preemptions: int = 0
    finish_reason: str | None = None

    @property
    def ttft_s(self) -> float | None:
        """Enqueue -> first token of the attempt that delivered (resets
        on preempt, matching the recompute-style discard)."""
        if self.first_token_ts is None or self.enqueue_ts is None:
            return None
        return self.first_token_ts - self.enqueue_ts

    @property
    def itl_mean_s(self) -> float | None:
        if self.tokens < 2 or self.first_token_ts is None:
            return None
        return ((self.last_token_ts - self.first_token_ts)
                / (self.tokens - 1))

    def on_preempt(self):
        self.preemptions += 1
        self.tokens = 0
        self.first_token_ts = None
        self.last_token_ts = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ttft_s"] = self.ttft_s
        d["itl_mean_s"] = self.itl_mean_s
        return d


@dataclasses.dataclass
class TickRecord:
    """One serving-engine tick (``Engine.step``): ``t`` the host
    ``perf_counter`` at its end, ``wall_s`` its wall time, ``chunks`` its
    prefill chunk forwards, ``device_s`` the device seconds of its
    device-clocked spans by path, added as ``SpanTimer.collect`` reads
    them, and ``pending`` those not read yet."""

    t: float = 0.0
    wall_s: float = 0.0
    chunks: int = 0
    device_s: dict = dataclasses.field(default_factory=dict)
    pending: int = 0
