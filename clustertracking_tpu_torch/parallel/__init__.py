"""Multi-device fits and linking over a mesh of torch devices.

Counterpart of ``clustertracking_tpu/parallel/``: ``sharding`` (the mesh,
``sharded_fit``) and ``linking`` (``link_sharded``).  The mesh and its
all-reduce, which GSPMD inserts in the reference, live in
``ops/collectives.py``, below ``refine``, and are re-exported here.
"""
from ..ops.collectives import Mesh, all_reduce, join_lanes, split_lanes
from .linking import link_sharded
from .sharding import fit_step_spec, make_mesh, sharded_fit

__all__ = ["Mesh", "all_reduce", "fit_step_spec", "join_lanes",
           "link_sharded", "make_mesh", "sharded_fit", "split_lanes"]
