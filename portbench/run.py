"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the comparison's numbers beside their limits on standard
error and one JSON line last on standard output; exits non-zero, with no
result, without a card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc builds land in build/kernels)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
