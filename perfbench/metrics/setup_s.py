"""setup_s: seconds from the process's start to the window's opening:
imports, the kernels' build (the first run in a checkout) or load, the
inputs made from the seed, the program's objects, warm-up. The harness
prints the parts on standard error (``setup_s`` in its notes) and in the
result line's ``setup_parts``, the build apart."""


def read(run):
    return run.setup_s
