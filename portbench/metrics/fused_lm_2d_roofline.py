"""fused_lm_2d_roofline: the least time an H100 could take for the fused
2D solves of the traced window (the reference's sweeps and solves on the
same inputs; ops at the FP32 peak or bytes at the memory rate, whichever
is longer) over ``fused_lm_2d_kernel``'s device time there."""
from metrics import _roofline

UNIT = "%"


def read(run):
    return _roofline.share(run, "fused_lm_2d_kernel")
