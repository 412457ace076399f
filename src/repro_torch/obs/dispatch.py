"""Dispatch-counter registry (port of ``repro/obs/dispatch.py``).

Each site that picks between implementations registers a counts dict here
once at import and bumps it where it dispatches: ``models/attention``
("paged": gather / fused) and ``core/vq_linear`` ("vq": gather / fused).
The port runs eagerly, so a count is one per call (the reference counts at
trace time). The surface:

* ``register_dispatch(source, impls)`` — get-or-create the live counts dict
  of ``source``; its identity survives ``reset_dispatch_counters()``.
* ``snapshot_dispatch_counters()`` — deep copy, {source: {impl: n}}, fed
  into telemetry metric snapshots.
* ``reset_dispatch_counters()`` — zero every count in place.

This module imports nothing, so any layer can import it.
"""
from __future__ import annotations

_COUNTERS: dict[str, dict[str, int]] = {}


def register_dispatch(source: str, impls) -> dict[str, int]:
    """Get-or-create the live counts dict for ``source``. Idempotent:
    re-registration (module reload) returns the existing dict so every
    holder keeps bumping the same object."""
    d = _COUNTERS.get(source)
    if d is None:
        d = _COUNTERS[source] = {impl: 0 for impl in impls}
    else:
        for impl in impls:
            d.setdefault(impl, 0)
    return d


def snapshot_dispatch_counters() -> dict[str, dict[str, int]]:
    """Deep copy of every registered source's counts."""
    return {src: dict(counts) for src, counts in _COUNTERS.items()}


def reset_dispatch_counters() -> None:
    """Zero every registered counter IN PLACE (dict identities survive)."""
    for counts in _COUNTERS.values():
        for impl in counts:
            counts[impl] = 0
