"""Straggler detection for the training loop (port of
``repro/runtime/straggler.py``; host logic, unchanged).

At >256 hosts, slow hosts (thermal throttling, failing HBM, noisy
neighbours) stretch every synchronous step. The monitor keeps a rolling
window of per-step (and per-host, when the launcher reports them) timings
and flags outliers; the launcher quarantines flagged hosts at the next
checkpoint boundary and triggers an elastic re-mesh (``runtime/elastic``:
``plan_mesh`` / ``degrade_plan`` for the smaller mesh, ``reshard`` to
place the restored state on it).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    threshold: float
    is_straggler: bool
    host: int | None = None


class StragglerMonitor:
    def __init__(self, window: int = 64, k_mad: float = 5.0,
                 min_samples: int = 8):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.k_mad = k_mad
        self.min_samples = min_samples
        self.flagged: list[StragglerReport] = []
        self.host_counts: dict[int, int] = collections.defaultdict(int)

    def record(self, step: int, duration: float,
               host: int | None = None) -> StragglerReport:
        if len(self.window) >= self.min_samples:
            med = statistics.median(self.window)
            mad = statistics.median(abs(x - med) for x in self.window) or 1e-9
            thr = med + self.k_mad * mad
        else:
            med, thr = duration, float("inf")
        rep = StragglerReport(step, duration, med, thr, duration > thr, host)
        if rep.is_straggler:
            self.flagged.append(rep)
            if host is not None:
                self.host_counts[host] += 1
        else:
            self.window.append(duration)
        return rep

    def quarantine_candidates(self, repeat_threshold: int = 3) -> list[int]:
        """Hosts flagged repeatedly -> candidates for removal at next ckpt."""
        return [h for h, c in self.host_counts.items() if c >= repeat_threshold]
