"""device_idle.quant: the share of the profiled slice (one expert stack's
GPTVQ, 128 matrices, in the block after the window) in which no operation
ran on the device, in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
