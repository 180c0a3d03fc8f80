"""link.auction_rounds.video: the device auction's rounds a call, summed
over the video's frames (the port's ledger ``link_rounds``), the mean over
the window's calls; None where the ledger does not count them."""
from metrics import _ledger

UNIT = "rounds"


def read(run):
    vals = _ledger.per_call(run, "link_rounds")
    return None if vals is None else float(vals.mean())
