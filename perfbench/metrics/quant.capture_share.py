"""quant.capture_share: the seconds of the pipeline's ``hessian_capture`` stage (its
``quant_stage`` events, each stage synchronising the device on exit)
that ended in the window, over the window's seconds, in percent."""


def read(run):
    return 100.0 * sum(s for *_, s in run.window_stages("hessian_capture")) \
        / run.window_s
