"""clustertracking_tpu_torch — the PyTorch + CUDA port of clustertracking_tpu.

The port runs the bucketed cluster fit — window gather, fit mask,
parameter packing, Levenberg–Marquardt and refit-on-shift — on an NVIDIA
GPU, in hand-written CUDA kernels: the fused 2D solve
(``csrc/fused_lm_2d.cu``), and for 3D and large 2D windows the window
gather (``csrc/window_gather.cu``) then the LM on gathered pixels
(``csrc/pixel_lm.cu``); every built-in profile, and rigid constraints as
a pose fitted inside the same kernels.  Around it, in plain torch on the
same device: candidate location, device cluster finding, the auction
linkers, the frame renderer (``ops.synth``) and the ``track``
pipeline with its recovery passes.  The JAX package
``clustertracking_tpu`` stays beside it as the reference the port is
held against.

Public API::

    track                                  (locate → find_clusters →
                                            refine_leastsq → link over a
                                            video; checkpoint_dir resumes;
                                            recover_passes re-locate the
                                            residual; transfer_dtype)
    locate, find_clusters, refine_leastsq  (DataFrame in / out; need pandas)
    link, link_df, filter_stubs, Linker    (trajectories: host Hungarian,
                                            device auctions)
    train_leastsq                          (learns 'global' parameters)
    dimer, trimer, tetramer, dimer_global  (constraints=; dimer_global()
                                            fits one distance per video)
    motion                                 (orientation, MSD, diffusion)
    entry, example_batch                   (the main path at array level)
    entry_3d, example_batch_3d             (config 4, 3D z-stacks)
    entry_rigid, example_batch_rigid       (configs 3, 3b, 3c: rigid)
    artificial, constraints, diagnostics, models, ops, utils

Importing the package imports neither JAX nor pandas, and does no CUDA
work; kernels are built on their first launch.
"""
from . import (  # noqa: F401
    artificial, constraints, diagnostics, models, motion, ops, utils)
from .constraints import dimer, dimer_global, tetramer, trimer
from .entry import (
    entry, entry_3d, entry_rigid, example_batch, example_batch_3d,
    example_batch_rigid)
from .find import Clusters, find_clusters
from .link import Linker, filter_stubs, link, link_df
from .pipeline import locate, track
from .refine import refine_leastsq, train_leastsq

__version__ = "0.1.0"

__all__ = [
    "Clusters",
    "Linker",
    "artificial",
    "constraints",
    "diagnostics",
    "dimer",
    "dimer_global",
    "entry",
    "entry_3d",
    "entry_rigid",
    "example_batch",
    "example_batch_3d",
    "example_batch_rigid",
    "filter_stubs",
    "find_clusters",
    "link",
    "link_df",
    "locate",
    "models",
    "motion",
    "ops",
    "refine_leastsq",
    "tetramer",
    "track",
    "train_leastsq",
    "trimer",
    "utils",
]
