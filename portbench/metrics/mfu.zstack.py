"""mfu.zstack: ``mfu.fit``'s quantity, in the 3D
solver's cell (a name of its own: it is compared with that cell's readings
only)."""
import core

UNIT = "%"
read = core.load_module("metrics", "mfu.fit").read
