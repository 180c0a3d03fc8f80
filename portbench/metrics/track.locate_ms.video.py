"""track.locate_ms.video: the median over the window's calls of ``track``'s
``locate_s``, the locate stage's wall as the port's loss ledger
(``diagnostics.collect``) keeps it, in ms."""
from metrics import _ledger

UNIT = "ms"


def read(run):
    return _ledger.median_ms(run, "locate_s")
