"""Stand-ins for reference functions this slice of the port leaves out.

Each raises ``NotImplementedError`` naming the ROADMAP.md queue entry that
will port it, so a caller learns where the work stands instead of meeting
an ``AttributeError``.
"""
from __future__ import annotations


def not_ported(name: str, entry: str):
    """A function that raises for the reference's ``name``."""
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md queue 1, {entry!r})")

    stub.__name__ = stub.__qualname__ = name.rsplit(".", 1)[-1]
    stub.__doc__ = f"Not ported yet: ROADMAP.md queue 1, {entry!r}."
    return stub
