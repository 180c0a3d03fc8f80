"""Cluster kinematics: orientation, body-frame displacements, diffusion.

A copy of ``clustertracking_tpu/motion.py`` (numpy; pandas imported by the
functions that build DataFrames), held to it bit for bit, but for one
fault it repairs (``_SAME_MEMBERS``).  It implements
the paper's analysis (van der Wel & Kraft 2016, arXiv:1607.08819):
per-frame rigid-cluster orientation from member positions, displacement
decomposition into body-frame translation + rotation, and short-time
translational/rotational diffusion estimation from mean-square
displacements.

Workflow: after refine + link, each cluster member carries a ``particle``
trajectory id.  ``cluster_trajectories`` groups members into persistent
clusters (by their member sets frame to frame), producing one row
per (cluster, frame) with center and orientation;
``diffusion_constants`` estimates D_trans (lab and body frame) and D_rot
from lag-1..max MSDs.

2D angles are unwrapped along trajectories so rotational MSD is linear in
lag; 3D orientation uses the principal member direction with quaternion
alignment between consecutive frames.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .utils import guess_pos_columns

if TYPE_CHECKING:
    import pandas as pd

__all__ = [
    "orientation",
    "cluster_trajectories",
    "body_frame_displacements",
    "msd",
    "diffusion_constants",
]

# A cluster trajectory continues only while its member set stays the same:
# a merge with a neighbouring cluster (find_clusters joins two dimers that
# come within the separation), a split, or a member relinked under a new
# particle id starts a new one, since the changed set's centre and
# orientation (centre → lowest particle id) are not the old body's.  False
# continues through any change that keeps at least half the members, as
# the reference does, for comparisons with it: on config 2's video its
# merged dimers read D_rot at ~3× the drawn value.
_SAME_MEMBERS = True


def orientation(positions: np.ndarray) -> float:
    """Orientation angle (2D) of a rigid cluster from member positions.

    Defined as the angle (atan2(y, x) convention) of the vector from the
    cluster center to member 0 — consistent member ordering is the
    caller's job (cluster_trajectories orders by particle id)."""
    center = positions.mean(axis=0)
    v = positions[0] - center
    return float(np.arctan2(v[0], v[1]))  # (y, x) columns


def cluster_trajectories(
    f: pd.DataFrame,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    particle_col: str = "particle",
    max_gap: int = 2,
) -> pd.DataFrame:
    """One row per (cluster instance, frame): center, orientation, size.

    Cluster-trajectory identity (``cluster_traj``): a cluster continues
    the trajectory whose most recent member set is its own
    (``_SAME_MEMBERS``; the reference, and ``_SAME_MEMBERS = False``,
    continue by MAJORITY MEMBER OVERLAP: the trajectory whose most recent
    member set shares at least half its members).  Perfectly linked
    input gives the same ids either way.  ``max_gap`` frames of absence
    are tolerated before a trajectory retires."""
    import pandas as pd

    if pos_columns is None:
        pos_columns = guess_pos_columns(f)
    ndim = len(pos_columns)
    rows = []
    for (t, cid), grp in f.groupby([t_column, "cluster"], sort=True):
        grp = grp.sort_values(particle_col)
        members = tuple(int(p) for p in grp[particle_col])
        pos = grp[pos_columns].to_numpy(dtype=float)
        center = pos.mean(axis=0)
        row = {
            t_column: t,
            "members": members,
            "cluster_size": len(grp),
        }
        for c, v in zip(pos_columns, center):
            row[c] = v
        if ndim == 2 and len(grp) > 1:
            row["angle"] = orientation(pos)
        elif ndim == 3 and len(grp) > 1:
            # 3D orientation: unit vector center -> member 0 (the body
            # axis); rotational diffusion comes from its autocorrelation
            u = pos[0] - center
            nrm = np.linalg.norm(u)
            if nrm > 1e-12:
                u = u / nrm
            for c, v in zip(("u_z", "u_y", "u_x"), u):
                row[c] = v
        rows.append(row)
    out = pd.DataFrame(rows)
    if not len(out):
        out["cluster_traj"] = pd.Series([], dtype=np.int64)
        return out
    # majority-overlap trajectory matching (see docstring); greedy
    # best-overlap-first assignment, one trajectory per frame
    out = out.sort_values(t_column, kind="stable").reset_index(drop=True)
    traj_ids = np.full(len(out), -1, dtype=np.int64)
    active: dict = {}  # traj_id -> {"members": set, "last": frame}
    next_id = 0
    for t, idx in out.groupby(t_column, sort=True).indices.items():
        cands = []
        for row in idx:
            mem = set(out.at[row, "members"])
            for tid, st in active.items():
                ov = len(mem & st["members"])
                if _SAME_MEMBERS:
                    keep = mem == st["members"]
                else:
                    # at least half the members persist (>= so a dimer
                    # with one relinked member still continues)
                    keep = ov and 2 * ov >= max(len(mem), len(st["members"]))
                if keep:
                    cands.append((-ov, tid, row))
        cands.sort()
        used_t: set = set()
        for negov, tid, row in cands:
            if tid in used_t or traj_ids[row] >= 0:
                continue
            used_t.add(tid)
            traj_ids[row] = tid
            active[tid] = {
                "members": set(out.at[row, "members"]), "last": t,
            }
        for row in idx:
            if traj_ids[row] < 0:
                traj_ids[row] = next_id
                active[next_id] = {
                    "members": set(out.at[row, "members"]), "last": t,
                }
                next_id += 1
        active = {
            tid: st for tid, st in active.items()
            if t - st["last"] <= max_gap
        }
    out["cluster_traj"] = traj_ids
    return out


def _unwrap_angles(a: np.ndarray, symmetry_fold: int = 1) -> np.ndarray:
    """Unwrap angles with an optional n-fold symmetry period (a trimer is
    2π/3-periodic in its member-0 orientation definition)."""
    period = 2 * np.pi / max(symmetry_fold, 1)
    return np.unwrap(a, period=period)


def body_frame_displacements(
    traj: pd.DataFrame,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
) -> pd.DataFrame:
    """Per-step displacement decomposed in the body frame.

    2D (``angle`` column): adds ``d_par`` (along the body x-axis at the
    step start), ``d_perp``, and ``d_angle``.

    3D (``u_z/u_y/u_x`` body-axis columns): adds ``d_par`` (along the
    body axis at the step start), ``d_perp`` (magnitude of the
    perpendicular component), and ``d_angle`` (angle between consecutive
    body axes) — the axisymmetric decomposition of the paper's cluster
    kinematics for 3D dimers/rods."""
    import pandas as pd

    if pos_columns is None:
        pos_columns = [
            c for c in ("z", "y", "x") if c in traj.columns
        ]
    ndim = len(pos_columns)
    is3d = ndim == 3 and "u_z" in traj.columns
    rows = []
    for cid, grp in traj.groupby("cluster_traj", sort=False):
        grp = grp.sort_values(t_column)
        t = grp[t_column].to_numpy()
        pos = grp[pos_columns].to_numpy(dtype=float)
        if is3d:
            u = grp[["u_z", "u_y", "u_x"]].to_numpy(dtype=float)
        else:
            ang = _unwrap_angles(
                grp["angle"].to_numpy(dtype=float)
            ) if "angle" in grp else np.zeros(len(grp))
        for i in range(len(grp) - 1):
            if t[i + 1] != t[i] + 1:
                continue
            if is3d:
                d = pos[i + 1] - pos[i]
                d_par = float(d @ u[i])
                d_perp = float(np.linalg.norm(d - d_par * u[i]))
                c = float(np.clip(u[i] @ u[i + 1], -1.0, 1.0))
                d_angle = float(np.arccos(c))
            else:
                dy, dx = pos[i + 1] - pos[i]
                th = ang[i]
                # body x-axis = orientation direction (cos, sin) in (x, y)
                d_par = dx * np.cos(th) + dy * np.sin(th)
                d_perp = -dx * np.sin(th) + dy * np.cos(th)
                d_angle = ang[i + 1] - ang[i]
            rows.append(
                {
                    "cluster_traj": cid,
                    t_column: t[i],
                    "d_par": d_par,
                    "d_perp": d_perp,
                    "d_angle": d_angle,
                }
            )
    return pd.DataFrame(rows)


def msd(
    traj: pd.DataFrame,
    columns,
    t_column: str = "frame",
    max_lagtime: int = 10,
    traj_col: str = "cluster_traj",
) -> pd.DataFrame:
    """Ensemble mean-square displacement of the given columns vs lag."""
    import pandas as pd

    lags = range(1, max_lagtime + 1)
    acc = {lag: [] for lag in lags}
    for _, grp in traj.groupby(traj_col, sort=False):
        grp = grp.sort_values(t_column)
        t = grp[t_column].to_numpy()
        x = grp[list(columns)].to_numpy(dtype=float)
        index = {int(ti): i for i, ti in enumerate(t)}
        for lag in lags:
            for ti, i in index.items():
                j = index.get(ti + lag)
                if j is not None:
                    d = x[j] - x[i]
                    acc[lag].append(np.sum(d * d))
    rows = []
    for lag in lags:
        if not acc[lag]:
            continue
        a = np.asarray(acc[lag], dtype=float)
        rows.append({
            "lagt": lag,
            "msd": float(a.mean()),
            # stderr of the ensemble-mean MSD at this lag (overlapping
            # windows correlate samples, so this slightly underestimates;
            # the diffusion-constant stderr degrades gracefully with it)
            "msd_std": float(a.std(ddof=1) / np.sqrt(len(a)))
            if len(a) > 1 else np.nan,
            "n": len(a),
        })
    return pd.DataFrame(rows)


def _slope_through_origin(tt, y, w):
    """Weighted LS slope of y = slope·t through the origin:
    slope = Σ w t y / Σ w t²."""
    return float(np.sum(w * tt * y) / np.sum(w * tt * tt))


def _point_estimates(
    traj, pos_columns, ndim, t_column, max_lagtime, fps, symmetry_fold
):
    """(D_trans, D_rot, n_steps) from a cluster-trajectory table."""
    m = msd(traj, pos_columns, t_column, max_lagtime)
    if not len(m):
        return np.nan, np.nan, 0
    # slope through origin, weighted by sample count
    w = m["n"].to_numpy(dtype=float)
    tt = m["lagt"].to_numpy(dtype=float) / fps
    slope = _slope_through_origin(tt, m["msd"].to_numpy(), w)
    d_trans = slope / (2.0 * ndim)

    d_rot = np.nan
    if ndim == 3 and "u_z" in traj.columns:
        # 3D: <u(t)·u(t+τ)> = exp(-2 D_r τ)  (rotational decorrelation of
        # a body axis); estimate from lag-resolved direction correlations
        num = {lag: [] for lag in range(1, max_lagtime + 1)}
        for cid, grp in traj.groupby("cluster_traj", sort=False):
            grp = grp.sort_values(t_column)
            t = grp[t_column].to_numpy()
            u = grp[["u_z", "u_y", "u_x"]].to_numpy(dtype=float)
            ok = np.isfinite(u).all(axis=1)
            index = {int(ti): i for i, ti in enumerate(t)}
            for lag in num:
                for ti, i in index.items():
                    j = index.get(ti + lag)
                    if j is not None and ok[i] and ok[j]:
                        num[lag].append(float(u[i] @ u[j]))
        lags, logs, ws = [], [], []
        for lag, vals in num.items():
            if vals:
                c = float(np.mean(vals))
                if c > 1e-6:
                    lags.append(lag / fps)
                    logs.append(-np.log(c))
                    ws.append(len(vals))
        if lags:
            slope = _slope_through_origin(
                np.asarray(lags), np.asarray(logs),
                np.asarray(ws, dtype=float),
            )
            d_rot = slope / 2.0
    elif "angle" in traj.columns and traj["angle"].notna().any():
        # single-member clusters carry no orientation — drop their NaN
        # rows or they poison every MSD sum they appear in
        ang = traj[traj["angle"].notna()].copy()
        ang["angle_unwrapped"] = np.nan
        for cid, grp in ang.groupby("cluster_traj", sort=False):
            order = grp.sort_values(t_column).index
            ang.loc[order, "angle_unwrapped"] = _unwrap_angles(
                grp.sort_values(t_column)["angle"].to_numpy(dtype=float),
                symmetry_fold,
            )
        mr = msd(ang, ["angle_unwrapped"], t_column, max_lagtime)
        if len(mr):
            slope = _slope_through_origin(
                mr["lagt"].to_numpy(dtype=float) / fps,
                mr["msd"].to_numpy(),
                mr["n"].to_numpy(dtype=float),
            )
            d_rot = slope / 2.0

    return float(d_trans), float(d_rot), int(m["n"].sum())


def diffusion_constants(
    f_linked: pd.DataFrame,
    pos_columns: Optional[list] = None,
    t_column: str = "frame",
    max_lagtime: int = 4,
    fps: float = 1.0,
    symmetry_fold: int = 1,
    n_blocks: int = 8,
) -> dict:
    """Estimate D_trans and D_rot of rigid clusters, with uncertainties.

    Input: linked, refined features (particle + cluster columns).  Returns
    ``{'D_trans', 'D_trans_std', 'D_rot', 'D_rot_std', 'n_steps'}`` with D
    in pixel²/time (time = frames/fps), via the MSD slope over lags
    1..max_lagtime: MSD_trans = 2·ndim·D·t, MSD_rot = 2·D_rot·t (2D angle
    MSD; 3D from body-axis decorrelation <u·u'> = exp(-2 D_r τ)).

    Uncertainty (SURVEY.md §2 motion row: estimates "with statistical
    uncertainty"): the ``_std`` values are block standard errors — the
    time range is split into ``n_blocks`` contiguous blocks, the full
    estimator runs on each, and the stderr is the block scatter /
    sqrt(n_blocks).  Blocking respects the serial correlation of
    overlapping-window MSD samples that a naive per-lag error propagation
    ignores (which underestimates by ~2-3x, measured).
    """
    if pos_columns is None:
        pos_columns = guess_pos_columns(f_linked)
    ndim = len(pos_columns)
    traj = cluster_trajectories(f_linked, pos_columns, t_column)
    if not len(traj):
        return {"D_trans": np.nan, "D_trans_std": np.nan,
                "D_rot": np.nan, "D_rot_std": np.nan, "n_steps": 0}

    d_trans, d_rot, n_steps = _point_estimates(
        traj, pos_columns, ndim, t_column, max_lagtime, fps, symmetry_fold
    )

    # block stderr: contiguous time blocks, the estimator per block
    t_all = traj[t_column].to_numpy(dtype=float)
    t_lo, t_hi = t_all.min(), t_all.max()
    span = max(t_hi - t_lo, 1.0)
    block_t, block_r = [], []
    for k in range(n_blocks):
        lo = t_lo + span * k / n_blocks
        hi = t_lo + span * (k + 1) / n_blocks
        sel = traj[(t_all >= lo) & (t_all < hi if k + 1 < n_blocks
                                    else t_all <= hi)]
        if len(sel) <= max_lagtime + 1:
            continue
        dt_k, dr_k, n_k = _point_estimates(
            sel, pos_columns, ndim, t_column, max_lagtime, fps,
            symmetry_fold,
        )
        if n_k > 0 and np.isfinite(dt_k):
            block_t.append(dt_k)
        if np.isfinite(dr_k):
            block_r.append(dr_k)

    def _block_std(vals):
        if len(vals) < 2:
            return np.nan
        return float(np.std(vals, ddof=1) / np.sqrt(len(vals)))

    return {
        "D_trans": d_trans,
        "D_trans_std": _block_std(block_t),
        "D_rot": d_rot,
        "D_rot_std": _block_std(block_r),
        "n_steps": n_steps,
    }
