"""engine.occupancy.serve: decoding slots a tick over the engine's slots
(``max_batch``), averaged over the window's ticks, in percent, as the
harness counts the tokens each tick's decode returned."""


def read(run):
    if not run.ticks:
        return None
    rows = sum(t.decode_rows for t in run.ticks)
    return 100.0 * rows / (len(run.ticks) * run.max_batch)
