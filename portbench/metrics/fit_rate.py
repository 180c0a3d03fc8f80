"""fit_rate: clusters fitted by the calls of the window, over the whole
window (its first call's start to the device synchronize that closes
it)."""
UNIT = "clusters/s"


def read(run):
    done = sum(c[2]["clusters"] for c in run.calls)
    return done / run.window_s
