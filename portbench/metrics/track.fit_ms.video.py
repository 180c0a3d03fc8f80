"""track.fit_ms.video: the median over the window's calls of ``track``'s
``fit_s``, the fit stage's wall as the port's loss ledger
(``diagnostics.collect``) keeps it, in ms."""
from metrics import _ledger

UNIT = "ms"


def read(run):
    return _ledger.median_ms(run, "fit_s")
