"""decode_tokens_per_s: every token served in the window (a first token
or a decoded one), over the window's seconds on the host's clock."""


def read(run):
    served = sum(1 for r in run.reqs for t in r.times if run.in_window(t))
    return served / run.window_s
