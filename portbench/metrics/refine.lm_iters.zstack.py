"""refine.lm_iters.zstack: ``refine.lm_iters``'s quantity, in the 3D
solver's cell (a name of its own: it is compared with that cell's readings
only)."""
import core

UNIT = "iterations"
read = core.load_module("metrics", "refine.lm_iters").read
