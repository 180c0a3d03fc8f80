"""device_idle_pct.zstack: ``device_idle_pct.fit``'s quantity, in the 3D
solver's cell (a name of its own: it is compared with that cell's readings
only)."""
import core

UNIT = "%"
read = core.load_module("metrics", "device_idle_pct.fit").read
