"""ttft_p90_ms: the 90th percentile (linear interpolation), in
milliseconds, of submit to first token over the requests whose first
token arrived in the window; a client submits as its previous request's
last token comes back."""
import numpy as np


def read(run):
    ttft = [r.times[0] - r.t_submit for r in run.reqs
            if r.times and run.in_window(r.times[0])]
    return float(np.percentile(ttft, 90)) * 1e3 if ttft else None
