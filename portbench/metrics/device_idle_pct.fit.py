"""device_idle_pct.fit: share of the traced window in which no kernel or
copy ran on the card."""
from metrics import _idle

UNIT = "%"


def read(run):
    return _idle.idle_pct(run)
