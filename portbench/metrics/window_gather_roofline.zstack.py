"""window_gather_roofline.zstack: the least time an H100 could take for the
window gathers of the traced window (a read and a write of each window the
reference's rounds solve, its origin and stack index, at the memory rate)
over ``window_gather_kernel``'s device time there."""
from metrics import _roofline

UNIT = "%"


def read(run):
    return _roofline.share(run, "window_gather_kernel")
