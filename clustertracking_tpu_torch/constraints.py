"""Rigid-geometry constraints for constrained cluster fits.

The port's own copy of ``clustertracking_tpu/constraints.py`` (the JAX
package cannot be imported here), with ``pose_to_positions`` on torch
tensors.  Built-in rigid constraints are handled exactly by fitting a
rigid-body pose instead of free positions:

- ``dimer(dist, ndim)``   — two features at center distance ``dist``:
  pose = center + orientation (2D: one angle; 3D: polar + azimuth).
- ``trimer(dist, ndim)``  — equilateral triangle with edge ``dist``:
  pose = center + angle (2D) or center + rotation vector (3D).
- ``tetramer(dist)``      — regular tetrahedron with edge ``dist`` (3D):
  pose = center + rotation vector.
- ``dimer_global()``      — a dimer whose bond length is itself fitted:
  ``mode='global'`` (default) shares one length across all clusters of
  the fit, ``mode='cluster'`` fits one per cluster.

Reference-style dicts ``{'type': 'eq', 'fun': f, 'cluster_size': n}``
become weighted penalty residual rows (weight ``sqrt(residual_factor)``);
their ``fun`` takes torch positions [n, D].

``pose_to_positions`` is differentiable under ``torch.func`` (the bucket
solver takes its per-lane ``jacfwd``); ``positions_to_pose`` is host numpy
(initialization only: centroid plus a Procrustes fit of the orientation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "Constraint",
    "dimer",
    "trimer",
    "tetramer",
    "dimer_global",
    "base_vertices",
    "circumradius_factor",
    "pose_dim",
    "pose_to_positions",
    "positions_to_pose",
    "wrap_constraint_dicts",
]


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A rigid-geometry constraint on clusters of a given size.

    kind: 'rigid' (reparameterized pose) or 'generic' (penalty rows).
    dist: fixed characteristic distance (edge / bond length); None when
      the distance itself is fitted (dimer_global).
    dist_mode: 'cluster' or 'global' — how a fitted distance is shared.
    fun: for kind='generic': callable(positions[n, D]) -> residuals [...],
      zero when satisfied.
    """

    kind: str
    cluster_size: int
    ndim: int
    dist: Optional[float] = None
    dist_mode: str = "cluster"
    fun: Optional[Callable] = None
    name: str = ""

    @property
    def fit_dist(self) -> bool:
        return self.kind == "rigid" and self.dist is None


def dimer(dist: float, ndim: int = 2) -> Constraint:
    """Two features at fixed center-to-center distance ``dist``."""
    return Constraint("rigid", 2, ndim, float(dist), name="dimer")


def trimer(dist: float, ndim: int = 2) -> Constraint:
    """Equilateral triangle with edge length ``dist``."""
    return Constraint("rigid", 3, ndim, float(dist), name="trimer")


def tetramer(dist: float, ndim: int = 3) -> Constraint:
    """Regular tetrahedron with edge length ``dist`` (3D only)."""
    if ndim != 3:
        raise ValueError("tetramer requires ndim=3")
    return Constraint("rigid", 4, ndim, float(dist), name="tetramer")


def dimer_global(ndim: int = 2, mode: str = "global") -> Constraint:
    """Dimer whose bond length is itself fitted: ``mode='global'`` shares
    one length across all clusters, ``mode='cluster'`` fits one per
    cluster."""
    if mode not in ("global", "cluster"):
        raise ValueError("mode must be 'global' or 'cluster'")
    return Constraint(
        "rigid", 2, ndim, None, dist_mode=mode, name="dimer_global"
    )


# ---------------------------------------------------------------------------
# Pose parameterization
# ---------------------------------------------------------------------------
def circumradius_factor(n: int, ndim: int) -> float:
    """Circumradius per unit edge length of the rigid base shape."""
    if n == 2:
        return 0.5
    if n == 4 and ndim == 3:
        return float(np.sqrt(3.0 / 8.0))  # regular tetrahedron
    return float(1.0 / (2.0 * np.sin(np.pi / n)))  # regular n-gon


def base_vertices(n: int, ndim: int) -> np.ndarray:
    """Unit-circumradius base geometry [n, ndim] (before the pose)."""
    if ndim == 2:
        a = 2 * np.pi * np.arange(n) / n
        return np.stack([np.sin(a), np.cos(a)], axis=-1)  # (y, x)
    if n == 2:
        return np.array([[1.0, 0, 0], [-1.0, 0, 0]])  # along z
    if n == 4:
        return (
            np.array(
                [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                dtype=float,
            )
            / np.sqrt(3.0)
        )
    a = 2 * np.pi * np.arange(n) / n
    return np.stack(
        [np.zeros(n), np.sin(a), np.cos(a)], axis=-1
    )  # planar n-gon in the (y, x) plane


def pose_dim(con: Constraint) -> int:
    """Number of pose parameters per cluster (excluding a fitted dist)."""
    if con.ndim == 2:
        return 3  # center (2) + angle
    if con.cluster_size == 2:
        return 5  # center (3) + polar + azimuth
    return 6  # center (3) + rotation vector


def _rodrigues(rotvec):
    """Rotation matrices [B, 3, 3] from rotation vectors [B, 3]."""
    theta = torch.linalg.vector_norm(rotvec, dim=-1, keepdim=True)
    axis = rotvec / torch.clamp(theta, min=1e-12)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zero, -kz, ky], -1),
            torch.stack([kz, zero, -kx], -1),
            torch.stack([-ky, kx, zero], -1),
        ],
        -2,
    )
    t = theta[..., None]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def pose_to_positions(pose, con: Constraint, dist=None):
    """pose [B, Q(+1 if fit_dist)] → positions [B, n, D] (torch).

    ``dist`` overrides the constraint's distance (a [B] tensor)."""
    n, D = con.cluster_size, con.ndim
    if dist is None:
        if con.fit_dist:
            dist = pose[:, -1]
        else:
            dist = torch.full(pose.shape[:1], con.dist, dtype=pose.dtype,
                              device=pose.device)
    R_c = circumradius_factor(n, D) * dist                   # [B]
    center = pose[:, :D]
    if D == 2:
        alphas = torch.as_tensor(2 * math.pi * np.arange(n) / n,
                                 dtype=pose.dtype, device=pose.device)
        ang = pose[:, 2:3] + alphas[None]
        offs = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    elif n == 2:
        th, ph = pose[:, 3], pose[:, 4]
        u = torch.stack(
            [torch.cos(th), torch.sin(th) * torch.sin(ph),
             torch.sin(th) * torch.cos(ph)],
            dim=-1,
        )  # (z, y, x)
        offs = torch.stack([u, -u], dim=1)
    else:
        rot = _rodrigues(pose[:, 3:6])
        base = torch.as_tensor(base_vertices(n, D), dtype=pose.dtype,
                               device=pose.device)
        offs = torch.einsum("bij,nj->bni", rot, base)
    return center[:, None, :] + R_c[:, None, None] * offs


def positions_to_pose(positions: np.ndarray, con: Constraint) -> np.ndarray:
    """Initial pose [B, Q] (+ a fitted dist column) from approximate
    positions [B, n, D] — host numpy: the centroid plus the best-fit
    orientation (Procrustes for 3D rotations)."""
    positions = np.asarray(positions, dtype=float)
    B, n, D = positions.shape
    center = positions.mean(axis=1)
    rel = positions - center[:, None, :]
    base = base_vertices(n, D)
    factor = circumradius_factor(n, D)
    cur_R = np.linalg.norm(rel, axis=-1).mean(axis=1)  # mean circumradius
    dist = cur_R / factor

    if D == 2:
        v0 = rel[:, 0, :]
        theta = np.arctan2(v0[:, 0], v0[:, 1])  # (y, x) convention
        pose = np.concatenate([center, theta[:, None]], axis=1)
    elif n == 2:
        u = rel[:, 0, :]
        u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
        th = np.arccos(np.clip(u[:, 0], -1, 1))
        ph = np.arctan2(u[:, 1], u[:, 2])
        pose = np.concatenate([center, th[:, None], ph[:, None]], axis=1)
    else:
        from scipy.spatial.transform import Rotation

        rotvecs = np.zeros((B, 3))
        for b in range(B):
            rot, _ = Rotation.align_vectors(rel[b], base * cur_R[b])
            rotvecs[b] = rot.as_rotvec()
        pose = np.concatenate([center, rotvecs], axis=1)

    if con.fit_dist:
        pose = np.concatenate([pose, dist[:, None]], axis=1)
    return pose


def wrap_constraint_dicts(constraints, ndim: int):
    """Reference-style constraint dicts / Constraint objects as a
    {cluster_size: Constraint} map.  Dicts ``{'type': 'eq', 'fun': f,
    'args': a, 'cluster_size': n}`` become generic (penalty) constraints
    whose ``fun`` receives torch positions [n, D]."""
    if constraints is None:
        return {}
    if isinstance(constraints, (Constraint, dict)):
        constraints = [constraints]
    out = {}
    for con in constraints:
        if isinstance(con, dict):
            n = int(con["cluster_size"])
            fun = con["fun"]
            args = tuple(con.get("args", ()))
            out[n] = Constraint(
                "generic",
                n,
                ndim,
                fun=(lambda pos, _f=fun, _a=args: torch.atleast_1d(
                    _f(pos, *_a)
                )),
                name=con.get("name", "eq"),
            )
        elif isinstance(con, Constraint):
            if con.ndim != ndim:
                raise ValueError(
                    f"Constraint {con.name} built for ndim={con.ndim}, "
                    f"fit is {ndim}D"
                )
            out[con.cluster_size] = con
        else:
            raise TypeError(f"Cannot interpret constraint {con!r}")
    return out
