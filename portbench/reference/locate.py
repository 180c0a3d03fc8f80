"""Plain reference of candidate location: one frame at a time, numpy,
float32.

trackpy's ``locate`` without its sub-pixel centroid: integer-pixel local
maxima above a noise-robust threshold, brightest first, each with a size
estimate that seeds the fit.  Written from the semantics the port states
in its docstrings (``pipeline.locate`` / ``_locate_frames``,
``ops/locate.py::feature_sizes``, ``pipeline._shrink_sizes``); this
imports nothing of the port.

- The statistics sample: every 4th pixel along each axis, or every pixel
  where that sample would hold fewer than 4,096 (frames under 256²).
- The threshold: the larger of the sample's ``percentile`` (numpy's
  linear interpolation) and median + ``noise_k``·1.4826·MAD; where the MAD
  is 0, the noise scale is (q90 − median)/1.2816, floored at 0.
- Candidates: pixels above the threshold that equal the maximum of the
  box of ``separation`` px a side (made odd) around them, the box cut at
  the frame's edges; among equal candidates within one box only the one
  of the lowest flat index stays.  Brightest first (ties: the lower flat
  index), at most ``max_features``.  A candidate's signal is its pixel.
- Size: in the disc of radius 0.4·radius (radius = diameter / 2) about
  the candidate's pixel, the weights max(I − median − noise, 0) give the
  intensity centroid and the radius of gyration about it; the size is
  the σ of a Gaussian centred on the pixel whose weights, over the same
  disc, give that second moment (bisection over [0.3, 1.5·0.4·radius], 24
  halvings), times each axis's shape factor sqrt(D·m2_axis / rg²),
  clipped to [0.5, radius].  Each axis's sizes are then clipped, frame by
  frame, to median ± max(0.15·median, 3·1.4826·MAD) of the frame's own,
  and the isotropic size is the geometric mean of the axes.

Departures from trackpy: no sub-pixel centroid (the fit refines), no
mass or eccentricity, the threshold is robust statistics (trackpy takes a
percentile alone), and the size is the truncation-corrected Gaussian σ
(trackpy reports the raw radius of gyration).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
FULL_STATS_BELOW = 4096
SIZE_HALVINGS = 24


def sample(frame):
    """The threshold statistics' pixels, flattened."""
    sub = frame[(slice(None, None, 4),) * frame.ndim]
    return (frame if sub.size < FULL_STATS_BELOW else sub).reshape(-1)


def _median(x):
    """Median, the mean of the two middle values, in float32."""
    xs = np.sort(x)
    n = len(xs)
    lo = xs[(n - 1) // 2]
    return lo if n % 2 else F32((lo + xs[n // 2]) * F32(0.5))


def statistics(frame, percentile=64.0, noise_k=6.0):
    """(threshold, median, noise) of one frame, float32."""
    x = sample(frame).astype(F32)
    med = _median(x)
    mad = _median(np.abs(x - med))
    if mad > 0:
        noise = F32(F32(1.4826) * mad)
    else:
        q90 = np.percentile(x, 90.0).astype(F32)
        noise = F32(max(F32((q90 - med) / F32(1.2816)), F32(0.0)))
    pct = np.percentile(x, percentile).astype(F32)
    return F32(max(pct, F32(med + F32(noise_k) * noise))), med, noise


def _box_max(img, half):
    """Each pixel's maximum over the box of ±``half`` per axis, cut at the
    frame's edges."""
    out = img.copy()
    for ax, h in enumerate(half):
        if h == 0:
            continue
        pad = [(0, 0)] * img.ndim
        pad[ax] = (h, h)
        p = np.pad(out, pad, constant_values=-np.inf)
        n = img.shape[ax]
        acc = out.copy()
        for k in range(2 * h + 1):
            acc = np.maximum(acc, np.take(p, np.arange(k, k + n), axis=ax))
        out = acc
    return out


def maxima(frame, separation, threshold, max_features):
    """(coords [K, D] int, values [K]) of the candidates, brightest
    first."""
    img = frame.astype(F32)
    half = tuple((int(s) | 1) // 2 for s in separation)
    cand = (img >= _box_max(img, half)) & (img > threshold)
    # plateaus: among candidates of one box, the lowest flat index stays
    neg_idx = np.where(cand, -np.arange(img.size, dtype=np.float64)
                       .reshape(img.shape), -np.inf)
    cand &= neg_idx >= _box_max(neg_idx, half)
    flat = np.flatnonzero(cand)
    vals = img.reshape(-1)[flat]
    order = np.argsort(-vals, kind="stable")[:max_features]
    flat = flat[order]
    return np.stack(np.unravel_index(flat, img.shape), axis=1), vals[order]


def _disc(radius, ndim):
    """Offsets [Np, D] of the size disc, and the axis scale [D]."""
    r = np.asarray(radius, np.float64)
    Rm = 0.4 * r.min()
    scale = (r / r.min()).astype(F32)
    reach = np.ceil(Rm * scale).astype(int)
    grids = np.meshgrid(*[np.arange(-h, h + 1) for h in reach],
                        indexing="ij")
    off = np.stack([g.reshape(-1) for g in grids], axis=1)
    d = off.astype(F32) / scale
    keep = (d * d).sum(axis=1) <= F32(Rm * Rm)
    return off[keep], scale, F32(Rm)


def sizes_per_axis(frame, coords, radius, bg, noise):
    """[K, D] sizes of the candidates at ``coords`` (before the frame's
    band)."""
    img = frame.astype(F32)
    K, D = coords.shape
    if K == 0:
        return np.zeros((0, D), F32)
    off, scale, Rm = _disc(radius, D)
    pix = coords[:, None, :] + off[None]                       # [K, Np, D]
    inside = np.all((pix >= 0) & (pix < np.asarray(img.shape)), axis=-1)
    safe = np.where(inside[..., None], pix, 0)
    vals = img[tuple(safe[..., a] for a in range(D))]
    d = np.broadcast_to(off.astype(F32) / scale, pix.shape)
    r2 = (d * d).sum(axis=-1)
    mass = np.maximum(vals - bg - noise, F32(0.0)) * inside
    m0 = np.maximum(mass.sum(axis=1), F32(1e-6))
    m1 = (mass[..., None] * d).sum(axis=1) / m0[:, None]
    rg2 = (mass * r2).sum(axis=1) / m0 - (m1 * m1).sum(axis=1)

    def moment(sig):
        w = np.exp(-r2 / np.maximum(F32(2.0) * sig * sig,
                                    F32(1e-12))[:, None]) * inside
        return (w * r2).sum(axis=1) / np.maximum(w.sum(axis=1), F32(1e-9))

    lo = np.full(K, F32(0.3))
    hi = np.full(K, F32(1.5) * Rm)
    for _ in range(SIZE_HALVINGS):
        mid = F32(0.5) * (lo + hi)
        small = moment(mid) < rg2
        lo = np.where(small, mid, lo)
        hi = np.where(small, hi, mid)
    sig = F32(0.5) * (lo + hi)
    m2 = (mass[..., None] * d * d).sum(axis=1) / m0[:, None] - m1 * m1
    shape_r = np.sqrt(np.maximum(
        D * m2 / np.maximum(rg2, F32(1e-9))[:, None], F32(1e-6)))
    s = sig[:, None] * shape_r * scale[None]
    return np.minimum(np.maximum(s, F32(0.5)),
                      np.asarray(radius, F32)[None]).astype(F32)


def band(s):
    """One axis's sizes clipped to the frame's band."""
    if not len(s):
        return s
    m = float(np.median(s))
    half = max(0.15 * m, 3.0 * 1.4826 * float(np.median(np.abs(s - m))))
    return np.clip(s, m - half, m + half)


def locate(frame, diameter, separation, percentile=64.0, max_features=4096,
           noise_k=6.0):
    """One frame's candidates: dict of ``coords`` [K, D] (float), ``signal``
    [K] and ``size`` [K] (the isotropic size), brightest first.
    ``diameter`` and ``separation`` per axis."""
    frame = np.asarray(frame, F32)
    thr, med, noise = statistics(frame, percentile, noise_k)
    coords, vals = maxima(frame, separation, thr, max_features)
    radius = tuple(float(d) / 2.0 for d in diameter)
    s = sizes_per_axis(frame, coords, radius, med, noise)
    for ax in range(s.shape[1]):
        s[:, ax] = band(s[:, ax])
    size = np.exp(np.mean(np.log(np.maximum(s, F32(1e-9))), axis=1))
    return dict(coords=coords.astype(np.float64), signal=vals.astype(F32),
                size=size.astype(F32))
