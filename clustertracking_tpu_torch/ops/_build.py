"""Build-on-first-use loader for the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["build_dir", "load_kernel_library", "build_log"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# -fmad=false: no FMA contraction, so each product and sum rounds as the
# plain PyTorch version's separate elementwise ops do.  Near a fit's noise
# floor the cost is a difference of nearly equal float32 numbers, and
# contraction alone moved it by up to 5.7e-3 relative on an H100 (16,384
# dimers), against 1.2e-4 without it, for ~14% more kernel time.  No
# --use_fast_math: expf accuracy moves accept decisions.
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (ctypes.CDLL, seconds spent building, nvcc's report); the loaded
# library stays referenced for the life of the process.
_LOADED: dict = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        if path is None and os.path.exists(os.path.join(root, "bin", "nvcc")):
            path = os.path.join(root, "bin", "nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ on first "
            "use and need the CUDA toolkit (CUDA_HOME/bin on PATH)"
        )
    return path


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, load
    it and return the ``ctypes.CDLL``."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"{name}-{digest}.so"
    seconds, report = 0.0, ""
    if not lib_path.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src.name} "
                    f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            report = proc.stderr
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, seconds, report)
    return lib


def build_log(name: str) -> tuple:
    """(build seconds, nvcc's -Xptxas -v report) of a loaded library;
    (0.0, "") when it was loaded from an earlier build."""
    _, seconds, report = _LOADED[name]
    return seconds, report
