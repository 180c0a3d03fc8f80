"""Device compute ops: residuals, LM solver, gather, the LM kernels."""
from .block_lm import block_lm, block_lm_reference
from .fused_lm import fused_lm_2d, fused_lm_2d_reference
from .lm import LMResult, lm_solve, lm_solve_global
from .pixel_lm import pixel_lm, pixel_lm_reference
from .residual import make_model_fns, window_offsets
from . import synth  # noqa: F401  (render_frames, frames_from_df)
from .tied_lm import tied_lm, tied_lm_reference
from .window_gather import window_gather

__all__ = [
    "LMResult",
    "block_lm",
    "block_lm_reference",
    "fused_lm_2d",
    "fused_lm_2d_reference",
    "lm_solve",
    "lm_solve_global",
    "make_model_fns",
    "pixel_lm",
    "pixel_lm_reference",
    "tied_lm",
    "tied_lm_reference",
    "window_gather",
    "window_offsets",
]
