"""quant_weights_per_s: the weights of every block the pipeline finished
in the window (its matrices' ``quant_target`` events, an expert stack
counting all its experts, then its ``advance`` stage's end), over the
seconds from the window's opening to the last such block's end, on the
host's clock. Whole blocks, so that where a window closes in a block (in
its capture, or after a 200 M-weight expert stack) does not move the
rate."""


def read(run):
    ends = [t for t, *_ in run.window_stages("advance")]
    if not ends:
        return None
    t_last = max(ends)
    return sum(w for t, _, w in run.targets if run.t_open < t <= t_last) \
        / (t_last - run.t_open)
