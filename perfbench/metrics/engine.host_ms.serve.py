"""engine.host_ms.serve: the part of an engine tick in which the device
ran none of the tick's spans, in milliseconds: each window tick's wall
time (``Engine.step`` on the host's clock) less the device time of its
four device-clocked spans (``admit``, ``prefill``, ``prompt_sample``,
``decode_tick/device``), which follow one another on one stream, averaged
over the window's ticks. Read with no profiler running. It counts the
host's time between those spans (with the decode's small uploads in
``host_prep``), not the launch gaps inside them."""
from perfbench import program

SPANS = ("admit", "prefill", "prompt_sample", "decode_tick/device")


def read(run):
    ticks = program.window_ticks(run)
    if not ticks:
        return None
    host = sum(t.wall_s - sum(t.device_s.get(s, 0.0) for s in SPANS)
               for t in ticks)
    return host / len(ticks) * 1e3
