"""clustertracking_tpu_torch — the PyTorch + CUDA port of clustertracking_tpu.

The port runs the bucketed cluster fit — window gather, fit mask,
parameter packing, Levenberg–Marquardt and refit-on-shift — on an NVIDIA
GPU, with the 2D fused solve in a hand-written CUDA kernel
(``csrc/fused_lm_2d.cu``).  The JAX package ``clustertracking_tpu`` stays
beside it as the reference the port is held against.

Public API of this slice::

    find_clusters, refine_leastsq          (DataFrame in / out; need pandas)
    entry, example_batch                   (the main path at array level)
    artificial, diagnostics, models, ops, utils

Importing the package imports neither JAX nor pandas, and does no CUDA
work; kernels are built on their first launch.
"""
from . import artificial, diagnostics, models, ops, utils  # noqa: F401
from .entry import entry, example_batch
from .find import Clusters, find_clusters
from .refine import refine_leastsq

__version__ = "0.1.0"

__all__ = [
    "Clusters",
    "artificial",
    "diagnostics",
    "entry",
    "example_batch",
    "find_clusters",
    "models",
    "ops",
    "refine_leastsq",
    "utils",
]
