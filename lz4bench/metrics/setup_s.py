"""setup_s: seconds from the start of the process to the window: imports
and the card, the corpus, the inputs, the warm-up pass (and, in a
checkout's first run, the build of the kernels)."""


def read(run):
    return run.setup_s
