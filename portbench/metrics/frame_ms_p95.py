"""frame_ms_p95: the 95th percentile of the window's per-call latency,
each call timed from its start until its DataFrame is returned."""
import numpy as np

UNIT = "ms"


def read(run):
    return 1e3 * float(np.quantile([c[1] - c[0] for c in run.calls], 0.95))
