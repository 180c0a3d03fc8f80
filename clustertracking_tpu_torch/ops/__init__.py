"""Device compute ops: residuals, LM solver, gather, the fused LM kernel."""
from .fused_lm import fused_lm_2d, fused_lm_2d_reference, kernel_available
from .lm import LMResult, lm_solve
from .residual import make_model_fns, window_offsets

__all__ = [
    "LMResult",
    "fused_lm_2d",
    "fused_lm_2d_reference",
    "kernel_available",
    "lm_solve",
    "make_model_fns",
    "window_offsets",
]
