"""engine.decode_ms.serve: the device time of one decode forward, in
milliseconds: the engine's ``decode_tick/device`` span on the device's
clock (CUDA events from the launch of the forward to the end of the token
download), the mean over the window's ticks that decoded."""
from perfbench import program

SPAN = "decode_tick/device"


def read(run):
    ticks = program.window_ticks(run)
    dev = [t.device_s[SPAN] for t in ticks or () if SPAN in t.device_s]
    if not dev:
        return None
    return sum(dev) / len(dev) * 1e3
