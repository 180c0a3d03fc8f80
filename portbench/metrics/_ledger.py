"""Shared by the readers of ``track``'s loss ledger: the driver's
``records[key]``, one entry a call."""
import numpy as np


def per_call(run, key):
    """The window's per-call values of ``key``, or None where a call's
    ledger lacks it (a program that does not count it)."""
    vals = run.records.get(key)
    if not vals or any(v is None for v in vals):
        return None
    return np.asarray(vals, float)


def median_ms(run, key):
    vals = per_call(run, key)
    return None if vals is None else 1e3 * float(np.median(vals))
