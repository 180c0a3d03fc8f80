"""device_idle_pct.video: ``device_idle_pct.fit``'s quantity, in the
tracking cell (a name of its own: it is compared with that cell's readings
only)."""
import core

UNIT = "%"
read = core.load_module("metrics", "device_idle_pct.fit").read
