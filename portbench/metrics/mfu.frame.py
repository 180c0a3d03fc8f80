"""mfu.frame: ``mfu.fit``'s quantity, in the cells whose end-to-end
metric is frame_ms_p95 (a per-layer metric moves one end-to-end metric)."""
import core

UNIT = "%"
read = core.load_module("metrics", "mfu.fit").read
