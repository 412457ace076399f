"""engine.prefill_chunk_ms.serve: the device time of the window's prefill
forwards over their chunks, in milliseconds: the engine's ``prefill`` span
on the device's clock (CUDA events at its entry and exit), summed over the
window's ticks, over the chunk forwards those ticks ran."""
from perfbench import program


def read(run):
    ticks = program.window_ticks(run)
    chunks = sum(t.chunks for t in ticks or ())
    if not chunks:
        return None
    return sum(t.device_s.get("prefill", 0.0) for t in ticks) / chunks * 1e3
