"""engine.tick_ms.serve: the window's seconds over its engine ticks
(``Engine.step`` calls), in milliseconds, on the host's clock."""


def read(run):
    return run.window_s / len(run.ticks) * 1e3 if run.ticks else None
