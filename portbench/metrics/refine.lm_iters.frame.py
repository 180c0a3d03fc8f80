"""refine.lm_iters.frame: ``refine.lm_iters``'s quantity, in the cells whose end-to-end
metric is frame_ms_p95 (a per-layer metric moves one end-to-end metric)."""
import core

UNIT = "iterations"
read = core.load_module("metrics", "refine.lm_iters").read
