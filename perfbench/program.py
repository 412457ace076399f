"""The program's own records of the window's ticks: the engine's
``TickRecord`` of each tick (``repro_torch.obs.telemetry.RECENT_TICKS``),
picked by the host's clock at the tick's end, which falls inside the
window (``ServeRun.in_window``) exactly for the window's ticks. A program
that keeps no such records reads None, and so does a run whose window the
records do not cover whole."""
import sys


def window_ticks(run):
    """The records of the window's ticks whose device spans have all been
    read, or None."""
    tel = sys.modules.get("repro_torch.obs.telemetry")
    recent = getattr(tel, "RECENT_TICKS", None)
    if recent is None:
        return None
    got = [t for t in list(recent) if run.in_window(t.t)]
    if len(got) != len(run.ticks):
        return None
    return [t for t in got if not t.pending] or None
