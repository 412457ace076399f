"""quant.codebook_update_share: the seconds of the pipeline's ``codebook_update`` stage (its
``quant_stage`` events, each stage synchronising the device on exit)
that ended in the window, over the window's seconds, in percent."""


def read(run):
    return 100.0 * sum(s for *_, s in run.window_stages("codebook_update")) \
        / run.window_s
