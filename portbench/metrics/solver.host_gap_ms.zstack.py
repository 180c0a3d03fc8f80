"""solver.host_gap_ms.zstack: ``solver.host_gap_ms``'s quantity, in the 3D
solver's cell (a name of its own: it is compared with that cell's readings
only)."""
import core

UNIT = "ms"
read = core.load_module("metrics", "solver.host_gap_ms").read
