"""Shared by the ``<kernel>_roofline`` readers: the least time the card
could take for the work the driver counted for a kernel (from the inputs
and the reference), over that kernel's device time by name in the traced
window."""
from roofline import lm_ops


def share(run, kernel):
    if run.trace is None or kernel not in run.records.get("work", {}):
        return None
    seconds = sum(v for k, v in run.trace["ops"].items() if kernel in k)
    if seconds <= 0.0:
        return None
    ops, nbytes = run.records["work"][kernel]
    return 100.0 * lm_ops.least_seconds(ops, nbytes) / seconds
