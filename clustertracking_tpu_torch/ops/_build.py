"""Build-on-first-use loader for the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of its source, every ``csrc/*.cuh``
header and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  ``build_kernels`` starts one ``nvcc``
per missing library, all at once.  Nothing here runs at import time.
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

__all__ = ["build_dir", "build_kernels", "load_kernel_library", "build_log"]

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


def _lib_path(name: str) -> Path:
    """The hashed library path of ``csrc/<name>.cu``."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names) -> None:
    """Build the missing libraries of ``names`` with one nvcc each, all
    started together, and load every one of them."""
    names = [nm for nm in names if nm not in _LOADED]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            lib_path = _lib_path(name)
            if lib_path.exists():
                _LOADED[name] = (ctypes.CDLL(str(lib_path)), 0.0, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True,
            )
            jobs[name] = (proc, tmp, lib_path, time.perf_counter())
        for name, (proc, tmp, lib_path, t0) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name}.cu "
                    f"(rc={proc.returncode}):\n{err[-4000:]}"
                )
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
            _LOADED[name] = (ctypes.CDLL(str(lib_path)),
                             time.perf_counter() - t0, err)
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, load
    it and return the ``ctypes.CDLL``."""
    if name not in _LOADED:
        build_kernels([name])
    return _LOADED[name][0]


def build_log(name: str) -> tuple:
    """(build seconds, nvcc's -Xptxas -v report) of a loaded library;
    (0.0, "") when it was loaded from an earlier build."""
    _, seconds, report = _LOADED[name]
    return seconds, report
