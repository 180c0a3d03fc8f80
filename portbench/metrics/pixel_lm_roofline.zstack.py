"""pixel_lm_roofline.zstack: the least time an H100 could take for the
gathered 3D solves of the traced window (the reference's sweeps and solves
on the same inputs; ops at the FP32 peak or bytes at the memory rate,
whichever is longer) over ``pixel_lm_kernel``'s device time there."""
from metrics import _roofline

UNIT = "%"


def read(run):
    return _roofline.share(run, "pixel_lm_kernel")
