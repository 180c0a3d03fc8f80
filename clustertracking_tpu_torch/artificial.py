"""Synthetic ground-truth image generation (test oracle + fake backend).

Copy of ``clustertracking_tpu/artificial.py`` (numpy only; the JAX package
cannot be imported without JAX).  The one change: pandas is imported where
a DataFrame is built, so that importing the port does not need pandas.
tests/test_torch_copies.py holds this copy to the original.

Rebuild of clustertracking/artificial.py (SURVEY.md §2, §3.5): draw single
features and rigid clusters with chosen radial profiles, generate random
(non-overlapping) location sets, and wrap a coordinate DataFrame as a
frame reader that renders frames on demand (``CoordinateReader``) — the
framework's fake video backend, used exactly as the reference uses it: run
the full pipeline on synthesized video and assert recovered parameters
against the generating coordinates.

Conventions match models/registry.py: a feature with ``signal`` s, position
p, per-axis sigma ``size`` contributes ``s * fun(sum_d((x_d-p_d)/size_d)^2)``
with ``fun`` the radial profile (default Gaussian ``exp(-r2/2)``).  Pixel
centers sit at integer coordinates.

This module is deliberately host-side numpy (the oracle must be independent
of the device code it validates).  An on-device variant for benchmark data
generation lives in ops/synth.py.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional, Sequence

import numpy as np

from .utils import default_pos_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

__all__ = [
    "feat_gauss",
    "feat_ring",
    "feat_hat",
    "feat_disc",
    "draw_feature",
    "draw_cluster",
    "draw_spots",
    "draw_array",
    "gen_random_locations",
    "gen_nonoverlapping_locations",
    "gen_cluster_locations",
    "crop_pad",
    "CoordinateReader",
    "SimulatedImage",
]


# --- radial profiles (numpy mirrors of models/registry.py) ----------------
def feat_gauss(r2):
    return np.exp(-0.5 * r2)


def feat_ring(r2, thickness=0.2):
    r = np.sqrt(r2 + 1e-12)
    return np.exp(-0.5 * ((r - 1.0) / thickness) ** 2)


def feat_hat(r2, disc_size=0.5):
    r = np.sqrt(r2 + 1e-12)
    edge = np.maximum(r - disc_size, 0.0)
    sigma = max(1.0 - disc_size, 1e-3)
    return np.exp(-0.5 * (edge / sigma) ** 2)


def feat_disc(r2):
    r = np.sqrt(r2 + 1e-12)
    return 1.0 / (1.0 + np.exp(-(1.0 - r) / 0.1))


_PROFILES = {
    "gauss": feat_gauss,
    "ring": feat_ring,
    "hat": feat_hat,
    "disc": feat_disc,
}


def _resolve_profile(feat_func, **kwargs) -> Callable:
    if callable(feat_func):
        f = feat_func
    else:
        f = _PROFILES[feat_func]
    if kwargs:
        return lambda r2: f(r2, **kwargs)
    return f


def draw_feature(
    image: np.ndarray,
    position: Sequence,
    size,
    signal: float = 1.0,
    feat_func="gauss",
    cutoff_sigmas: float = 5.0,
    **kwargs,
) -> np.ndarray:
    """Add one feature to ``image`` in place (and return it).

    ``size`` is the per-axis sigma (scalar → isotropic).  Only a local
    window of ±cutoff_sigmas·size pixels is evaluated.
    """
    ndim = image.ndim
    position = np.asarray(position, dtype=float)
    size = np.asarray(validate_tuple(size, ndim), dtype=float)
    fun = _resolve_profile(feat_func, **kwargs)

    lo = np.maximum(np.floor(position - cutoff_sigmas * size), 0).astype(int)
    hi = np.minimum(
        np.ceil(position + cutoff_sigmas * size) + 1, image.shape
    ).astype(int)
    if np.any(hi <= lo):
        return image
    grids = np.meshgrid(
        *[np.arange(l, h) for l, h in zip(lo, hi)], indexing="ij"
    )
    r2 = sum(
        ((g - p) / s) ** 2 for g, p, s in zip(grids, position, size)
    )
    region = tuple(slice(l, h) for l, h in zip(lo, hi))
    image[region] += signal * fun(r2)
    return image


def gen_cluster_locations(
    center: Sequence,
    n: int,
    hard_radius: float,
    ndim: int = 2,
    angle: float = 0.0,
) -> np.ndarray:
    """Positions of a rigid n-cluster: regular polygon (2D) / polyhedron
    (3D: n<=4 → simplex vertices) with center-to-vertex distance
    ``hard_radius``, rotated by ``angle`` (2D) about the center."""
    center = np.asarray(center, dtype=float)
    if n == 1:
        return center[None, :]
    if ndim == 2:
        angles = angle + 2 * np.pi * np.arange(n) / n
        offs = hard_radius * np.stack(
            [np.sin(angles), np.cos(angles)], axis=-1
        )  # (y, x)
        return center[None, :] + offs
    # 3D: dimer along z-rotated axis; trimer planar; tetramer simplex
    if n == 2:
        offs = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    elif n == 3:
        a = 2 * np.pi * np.arange(3) / 3
        offs = np.stack([np.zeros(3), np.sin(a), np.cos(a)], axis=-1)
    elif n == 4:
        offs = np.array(
            [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], dtype=float
        ) / np.sqrt(3.0)
    else:
        # ring in the (y, x) plane
        a = 2 * np.pi * np.arange(n) / n
        offs = np.stack([np.zeros(n), np.sin(a), np.cos(a)], axis=-1)
    if angle != 0.0:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=float)
        offs = offs @ rot.T
    return center[None, :] + hard_radius * offs


def draw_cluster(
    image: np.ndarray,
    center: Sequence,
    size,
    separation: float,
    n: int,
    signal: float = 1.0,
    angle: float = 0.0,
    feat_func="gauss",
    **kwargs,
) -> np.ndarray:
    """Draw a rigid cluster of ``n`` features with pairwise nearest-neighbor
    distance ``separation`` (center-to-vertex radius derived per shape),
    returning the per-feature positions used."""
    ndim = image.ndim
    if n == 1:
        hard_radius = 0.0
    elif ndim == 2 or n > 4:
        # polygon: edge s = 2 R sin(pi/n)
        hard_radius = separation / (2 * np.sin(np.pi / max(n, 2)))
    elif n == 2:
        hard_radius = separation / 2.0
    elif n == 3:
        hard_radius = separation / np.sqrt(3.0)
    else:  # regular tetrahedron: edge = R * sqrt(8/3)
        hard_radius = separation / np.sqrt(8.0 / 3.0)
    pos = gen_cluster_locations(center, n, hard_radius, ndim, angle)
    for p in pos:
        draw_feature(image, p, size, signal, feat_func, **kwargs)
    return pos


def draw_spots(
    shape: Sequence,
    positions: np.ndarray,
    size,
    signal=1.0,
    noise_level: float = 0.0,
    bitdepth: Optional[int] = None,
    feat_func="gauss",
    rng=None,
    **kwargs,
) -> np.ndarray:
    """Render an image of ``shape`` with features at ``positions``.

    ``signal`` may be scalar or per-feature; Gaussian noise of std
    ``noise_level`` is added if nonzero.  If ``bitdepth`` is given the
    image is scaled and quantized to unsigned integers (the reference's
    camera-model knob)."""
    image = np.zeros(tuple(shape), dtype=float)
    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    signal = np.broadcast_to(
        np.asarray(signal, dtype=float), (len(positions),)
    )
    for p, s in zip(positions, signal):
        draw_feature(image, p, size, s, feat_func, **kwargs)
    if noise_level > 0:
        rng = np.random.default_rng(rng)
        image = image + rng.normal(0.0, noise_level, image.shape)
    if bitdepth is not None:
        maxval = 2 ** bitdepth - 1
        image = np.clip(image, 0, None)
        scale = maxval / max(image.max(), 1e-12)
        dt = np.uint8 if bitdepth <= 8 else np.uint16
        image = (image * scale).astype(dt)
    return image


def draw_array(
    n: int,
    shape: Sequence,
    size,
    spacing: Optional[float] = None,
    signal=1.0,
    **kwargs,
) -> tuple:
    """Regular grid of n features — convenience for throughput tests."""
    ndim = len(shape)
    per_axis = int(np.ceil(n ** (1.0 / ndim)))
    axes = [
        np.linspace(s * 0.15, s * 0.85, per_axis) for s in shape
    ]
    grid = np.stack(
        [g.ravel() for g in np.meshgrid(*axes, indexing="ij")], axis=-1
    )[:n]
    return draw_spots(shape, grid, size, signal, **kwargs), grid


def gen_random_locations(shape, count, margin=0, rng=None) -> np.ndarray:
    """Uniform random positions inside ``shape`` with a border margin."""
    rng = np.random.default_rng(rng)
    margin = np.asarray(validate_tuple(margin, len(shape)), dtype=float)
    lo = margin
    hi = np.asarray(shape, dtype=float) - 1 - margin
    return rng.uniform(lo, hi, size=(count, len(shape)))


def gen_nonoverlapping_locations(
    shape, count, separation, margin=0, max_attempts=200, rng=None
) -> np.ndarray:
    """Random positions with pairwise distance ≥ separation (dart
    throwing; may return fewer than ``count`` if space runs out)."""
    rng = np.random.default_rng(rng)
    accepted = []
    for _ in range(max_attempts):
        cand = gen_random_locations(
            shape, count - len(accepted), margin, rng
        )
        for p in cand:
            if len(accepted) >= count:
                break
            if all(
                np.sum((p - q) ** 2) >= separation ** 2 for q in accepted
            ):
                accepted.append(p)
        if len(accepted) >= count:
            break
    return np.asarray(accepted)


def crop_pad(image: np.ndarray, origin, shape) -> np.ndarray:
    """Crop ``image`` at integer ``origin`` to ``shape``, zero-padding out
    of bounds — host mirror of the device window gather."""
    origin = np.asarray(origin, dtype=int)
    shape = tuple(shape)
    out = np.zeros(shape, dtype=image.dtype)
    src = []
    dst = []
    for o, s, im_s in zip(origin, shape, image.shape):
        s0 = max(o, 0)
        s1 = min(o + s, im_s)
        if s1 <= s0:
            return out
        src.append(slice(s0, s1))
        dst.append(slice(s0 - o, s1 - o))
    out[tuple(dst)] = image[tuple(src)]
    return out


class CoordinateReader:
    """Render video frames on demand from a coordinate DataFrame.

    Pims-free rebuild of artificial.py::CoordinateReader (SURVEY.md §3.5):
    ``reader[t]`` selects the rows with ``frame == t`` and rasterizes them.
    Satisfies the framework's reader protocol: ``__getitem__``, ``__len__``,
    ``frame_shape``, iteration.
    """

    def __init__(
        self,
        f: pd.DataFrame,
        shape: Sequence,
        size,
        signal_col: str = "signal",
        noise_level: float = 0.0,
        feat_func="gauss",
        pos_columns: Optional[list] = None,
        t_column: str = "frame",
        seed: int = 0,
        **kwargs,
    ):
        self.f = f
        self.shape = tuple(shape)
        self.size = size
        self.signal_col = signal_col
        self.noise_level = noise_level
        self.feat_func = feat_func
        self.kwargs = kwargs
        self.t_column = t_column
        if pos_columns is None:
            pos_columns = default_pos_columns(len(self.shape))
        self.pos_columns = pos_columns
        self.seed = seed
        self._n_frames = (
            int(f[t_column].max()) + 1 if len(f) else 0
        )

    @property
    def frame_shape(self):
        return self.shape

    def __len__(self):
        return self._n_frames

    def __getitem__(self, t: int) -> np.ndarray:
        rows = self.f[self.f[self.t_column] == t]
        positions = rows[self.pos_columns].to_numpy(dtype=float)
        if self.signal_col in rows:
            signal = rows[self.signal_col].to_numpy(dtype=float)
        else:
            signal = 1.0
        return draw_spots(
            self.shape,
            positions,
            self.size,
            signal,
            noise_level=self.noise_level,
            feat_func=self.feat_func,
            rng=self.seed + t if self.noise_level > 0 else None,
            **self.kwargs,
        )

    def __iter__(self):
        for t in range(len(self)):
            yield self[t]


class SimulatedImage:
    """Incremental image builder used by tests (reference parity helper)."""

    def __init__(self, shape, size, signal=1.0, feat_func="gauss", **kwargs):
        self.shape = tuple(shape)
        self.size = size
        self.signal = signal
        self.feat_func = feat_func
        self.kwargs = kwargs
        self.image = np.zeros(self.shape, dtype=float)
        self.coords = []

    def clear(self):
        self.image = np.zeros(self.shape, dtype=float)
        self.coords = []

    def draw_feature(self, position, signal=None):
        self.coords.append(np.asarray(position, dtype=float))
        draw_feature(
            self.image,
            position,
            self.size,
            self.signal if signal is None else signal,
            self.feat_func,
            **self.kwargs,
        )

    def draw_cluster(self, center, separation, n, angle=0.0):
        pos = draw_cluster(
            self.image,
            center,
            self.size,
            separation,
            n,
            self.signal,
            angle,
            self.feat_func,
            **self.kwargs,
        )
        self.coords.extend(list(pos))
        return pos

    def add_noise(self, noise_level, seed=0):
        rng = np.random.default_rng(seed)
        self.image = self.image + rng.normal(0, noise_level, self.shape)

    def coords_df(self) -> pd.DataFrame:
        import pandas as pd

        ndim = len(self.shape)
        cols = default_pos_columns(ndim)
        df = pd.DataFrame(np.asarray(self.coords), columns=cols)
        df["frame"] = 0
        return df

    def __call__(self):
        return self.image
