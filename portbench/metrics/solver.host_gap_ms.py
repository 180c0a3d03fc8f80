"""solver.host_gap_ms: ms of device idle a call charged to the bucket
solver's host ranges (``solver.setup``, ``solver.round``, ``solver.kernel``,
``solver.finish``): the traced window's idle gaps whose range starts with
``solver.``, summed, over the window's calls."""
UNIT = "ms"


def read(run):
    if run.trace is None:
        return None
    idle = sum(s for label, s in run.trace["idle_gaps"]
               if label.startswith("solver."))
    return 1e3 * idle / len(run.calls)
