"""The readings that a cell's limits are set from: the program's gaps to
the plain reference over many seeds, and the control's.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <k>] [--tables <m>]

For each seed, one process: the cell's set-up, a short window at the
cell's own load, then the numbers the cell compares, for the program and,
on the first ``--control-seeds`` seeds, for the control: the reference
itself in the precisions below the configuration's ('tf32', 'bfloat16')
put in the program's place.  One JSON line a seed.  The benchmark's own
runs never run this.
"""
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import core  # noqa: E402


def readings(workload, seed, seconds, controls, tables=None, device=None,
             traffic=None):
    """{"seed", "program": numbers[, precision: numbers]} of one seed."""
    import torch

    cell, config = core.load_cell(workload, traffic)
    device = torch.device(device or "cuda:0")
    driver = core.load_module("drivers", cell["driver"]).make(
        cell, config, seed, device)
    core.window(driver, seconds, device)
    driver.close()
    keys = sorted(driver.out)[:tables]
    ref = driver.reference(keys, "float32")
    fits = driver.program_fits()
    row = {"seed": seed,
           "program": driver.gaps({k: fits[k] for k in keys}, ref)}
    for prec in controls:
        row[prec] = driver.gaps(driver.as_fits(driver.reference(keys, prec)),
                                ref)
    return row


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--tables", type=int, default=None)
    args = ap.parse_args()
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        controls = ("tf32", "bfloat16") if i < args.control_seeds else ()
        row = readings(args.workload, seed, args.seconds, controls,
                       args.tables)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
