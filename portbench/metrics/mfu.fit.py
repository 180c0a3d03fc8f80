"""mfu.fit: the whole fit's share of the card's FP32 peak: the LM
operations the window's calls needed (from the inputs and the reference's
iterations) over the traced window at 67 TFLOP/s.  It bounds every
kernel's share of its roofline from below: a change that moves work off a
kernel still has to raise this."""
from roofline import lm_ops

UNIT = "%"


def read(run):
    if run.trace is None or "lm_ops" not in run.records:
        return None
    return 100.0 * run.records["lm_ops"] / (
        run.trace["window_s"] * lm_ops.PEAKS["fp32_flops_per_s"])
