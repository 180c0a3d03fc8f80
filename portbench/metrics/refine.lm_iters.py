"""refine.lm_iters: the program's LM iterations per valid cluster over
the window's calls (all refit rounds), as the driver read them from the
solver's per-lane output or the dispatch records."""
UNIT = "iterations"


def read(run):
    return run.records.get("lm_iters")
