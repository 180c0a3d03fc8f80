"""clustertracking_tpu_torch — the PyTorch + CUDA port of clustertracking_tpu.

The port runs the bucketed cluster fit — window gather, fit mask,
parameter packing, Levenberg–Marquardt and refit-on-shift — on an NVIDIA
GPU, in hand-written CUDA kernels: the fused 2D solve
(``csrc/fused_lm_2d.cu``), and for 3D and large 2D windows the window
gather (``csrc/window_gather.cu``) then the LM on gathered pixels
(``csrc/pixel_lm.cu``).  The JAX package ``clustertracking_tpu`` stays
beside it as the reference the port is held against.

Public API of this slice::

    find_clusters, refine_leastsq          (DataFrame in / out; need pandas)
    entry, example_batch                   (the main path at array level)
    entry_3d, example_batch_3d             (config 4, 3D z-stacks)
    artificial, diagnostics, models, ops, utils

Importing the package imports neither JAX nor pandas, and does no CUDA
work; kernels are built on their first launch.
"""
from . import artificial, diagnostics, models, ops, utils  # noqa: F401
from .entry import entry, entry_3d, example_batch, example_batch_3d
from .find import Clusters, find_clusters
from .refine import refine_leastsq

__version__ = "0.1.0"

__all__ = [
    "Clusters",
    "artificial",
    "diagnostics",
    "entry",
    "entry_3d",
    "example_batch",
    "example_batch_3d",
    "find_clusters",
    "models",
    "ops",
    "refine_leastsq",
    "utils",
]
