"""itl_p95_ms: the 95th percentile (linear interpolation) of every gap
between two consecutive tokens of a request whose later token arrived in
the window, in milliseconds. A token's arrival is the end of the
``Engine.step`` that produced it, on the host's clock."""
import numpy as np


def read(run):
    gaps = [b - a for r in run.reqs for a, b in zip(r.times, r.times[1:])
            if run.in_window(b)]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
