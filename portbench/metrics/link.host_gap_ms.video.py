"""link.host_gap_ms.video: ms of device idle a call charged to the
``track.link`` range (the linking of the accepted rows: the auction's
host syncs and the host work between its launches), over the traced
window's calls; None where no idle gap fell in such a range."""
UNIT = "ms"


def read(run):
    if run.trace is None:
        return None
    idle = [s for label, s in run.trace["idle_gaps"] if label == "track.link"]
    return 1e3 * sum(idle) / len(run.calls) if idle else None
