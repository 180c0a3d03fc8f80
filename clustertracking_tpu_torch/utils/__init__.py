"""Small validation / DataFrame-convention helpers.

Copy of ``clustertracking_tpu/utils/__init__.py`` (numpy only);
tests/test_torch_copies.py holds it to the original.

TPU-native rebuild of the utility layer of caspervdw/clustertracking
(reference: clustertracking/utils.py — validate_tuple, position/size column
guessing; see SURVEY.md §2 "Utilities").  The column-name conventions here ARE
the public API contract of the whole framework:

- positions: ``['y', 'x']`` in 2D, ``['z', 'y', 'x']`` in 3D
- sizes: ``['size']`` (isotropic) or ``['size_z', 'size_y', 'size_x']``
- time: ``'frame'``; cluster id: ``'cluster'``; cluster size: ``'cluster_size'``
- trajectory id (after linking): ``'particle'``
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "validate_tuple",
    "guess_pos_columns",
    "default_pos_columns",
    "default_size_columns",
    "is_isotropic",
    "ClusterError",
]


class ClusterError(Exception):
    """Raised for malformed cluster/feature inputs."""


def validate_tuple(value, ndim: int) -> tuple:
    """Broadcast a scalar to an ``ndim``-tuple; validate tuple length.

    Mirrors the semantics of clustertracking/utils.py::validate_tuple:
    scalars are repeated per dimension, sequences must have length ``ndim``.
    """
    if not hasattr(value, "__iter__"):
        return (value,) * ndim
    value = tuple(value)
    if len(value) != ndim:
        raise ValueError(
            f"Expected a scalar or a length-{ndim} sequence, got {value!r}"
        )
    return value


def default_pos_columns(ndim: int) -> list:
    """['y', 'x'] for 2D, ['z', 'y', 'x'] for 3D (row-major image order)."""
    if ndim == 2:
        return ["y", "x"]
    if ndim == 3:
        return ["z", "y", "x"]
    raise ValueError(f"Only 2D and 3D are supported, got ndim={ndim}")


def default_size_columns(ndim: int, isotropic: bool) -> list:
    """['size'] when isotropic, else per-axis size columns."""
    if isotropic:
        return ["size"]
    return ["size_" + c for c in default_pos_columns(ndim)]


def guess_pos_columns(f) -> list:
    """Infer position columns from a features DataFrame.

    Follows the reference convention: presence of a ``'z'`` column means 3D.
    """
    cols = set(f.columns)
    if not {"y", "x"} <= cols:
        raise ClusterError(
            "Features DataFrame must have 'y' and 'x' columns "
            f"(got {sorted(cols)})"
        )
    return ["z", "y", "x"] if "z" in cols else ["y", "x"]


def is_isotropic(value) -> bool:
    """True if a per-dim tuple has all-equal entries (or is scalar)."""
    if not hasattr(value, "__iter__"):
        return True
    arr = np.asarray(value)
    return bool(np.all(arr == arr.ravel()[0]))
