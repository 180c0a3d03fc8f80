"""setup_s: seconds from the process's start to the window's first call:
imports, inputs from the seed, the kernels' build (the first run of a
checkout) and the warm-up calls."""
UNIT = "s"


def read(run):
    return run.setup_s
