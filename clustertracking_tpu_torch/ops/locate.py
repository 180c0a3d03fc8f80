"""Candidate feature location on the device: filters, threshold maps,
local maxima and per-candidate sizes.

Counterpart of ``clustertracking_tpu/ops/locate.py``, which the reference
computes in XLA; here in plain torch on the device of the frames:

- ``gaussian_blur`` and ``boxcar_background`` are separable 1-D filters
  with reflect padding, written as sums of shifted copies (one product
  and one add per tap, in tap order), so no convolution library and no
  TF32 path is involved and a CUDA and a CPU run round alike;
  ``bandpass`` is their difference;
- ``tile_threshold_map``: per-tile median and MAD, bilinearly upsampled;
- ``local_maxima`` / ``local_maxima_topk``: a ``max_pool`` dilation, the
  plateau tie-break toward the lowest flat index, and a compaction to a
  fixed-size, brightest-first list (stable sorts, so ties resolve as the
  reference's ``argsort(stable=True)`` and ``lax.top_k`` do);
- ``feature_sizes``: the truncation-corrected radius of gyration.

Medians average the two middle values and percentiles interpolate
linearly, as numpy's do (``np_median``, ``np_percentile``).  Every function
takes a batch of frames ``[T, *S]`` (``local_maxima`` and
``local_maxima_topk`` also a single frame).  Candidates are integer
pixel positions; sub-pixel refinement is refine_leastsq's job.
"""
from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .gather import clamp_origins, gather_stack
from .residual import window_offsets

__all__ = ["bandpass", "boxcar_background", "feature_sizes",
           "gaussian_blur", "grey_dilation", "local_maxima",
           "local_maxima_topk", "np_median", "np_percentile",
           "tile_threshold_map"]


def np_median(x, dim=-1):
    """Median along ``dim``: the mean of the two middle values for an even
    count (numpy's and jnp's, where ``torch.median`` takes the lower)."""
    xs = torch.sort(x, dim=dim).values
    n = xs.shape[dim]
    lo = xs.select(dim, (n - 1) // 2)
    if n % 2:
        return lo
    return (lo + xs.select(dim, n // 2)) * 0.5


def np_percentile(x, q, dim=-1):
    """``np.percentile(x, q, axis=dim)`` of float32 ``x`` (linear method),
    with numpy's float32 arithmetic: the index and weight are float32
    scalars, and the interpolation takes the nearer end."""
    xs = torch.sort(x, dim=dim).values
    n = xs.shape[dim]
    virtual = np.float32(n - 1) * (np.float32(q) / np.float32(100))
    prev = int(np.floor(virtual))
    nxt = prev + 1
    if virtual >= n - 1:
        prev = nxt = n - 1
    elif virtual < 0:
        prev = nxt = 0
    gamma = np.float32(virtual - np.float32(prev))
    a, b = xs.select(dim, prev), xs.select(dim, nxt)
    diff = b - a
    if gamma >= 0.5:
        return b - diff * float(np.float32(1) - gamma)
    return a + diff * float(gamma)


def _reflect_index(n, before, after, device):
    """Indices of numpy's 'reflect' padding of a length-n axis."""
    idx = np.pad(np.arange(n), (before, after), mode="reflect")
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _filter_1d(x, axis, taps):
    """Correlate axis ``axis`` of ``x`` with the float32 ``taps`` (odd
    length), reflect-padded to the same length."""
    r = len(taps) // 2
    n = x.shape[axis]
    xp = x.index_select(axis, _reflect_index(n, r, r, x.device))
    out = None
    for j, k in enumerate(taps):
        term = xp.narrow(axis, j, n) * float(k)
        out = term if out is None else out + term
    return out


def gaussian_blur(stack, sigmas: Tuple[float, ...]):
    """Separable Gaussian smoothing of a frame stack [T, *S] (float32).

    Per spatial axis with σ > 0: a normalized kernel truncated at
    max(1, ceil(3σ)) px, reflect padding.  The matched filter for
    Gaussian features in white noise."""
    out = stack.to(torch.float32)
    for ax, sig in enumerate(sigmas):
        if sig <= 0:
            continue
        r = max(1, int(np.ceil(3.0 * sig)))
        x = np.arange(-r, r + 1, dtype=np.float32)
        k = np.exp(-0.5 * (x / sig) ** 2)
        out = _filter_1d(out, 1 + ax, k / k.sum())
    return out


def boxcar_background(stack, sizes: Tuple[int, ...]):
    """Separable boxcar average of a frame stack [T, *S] over odd per-axis
    lengths ``sizes`` (even ones are made odd), reflect-padded: the
    background estimate of ``bandpass``."""
    out = stack.to(torch.float32)
    for ax, n in enumerate(sizes):
        n = int(n) | 1
        if n <= 1:
            continue
        out = _filter_1d(out, 1 + ax, np.full((n,), 1.0 / n, np.float32))
    return out


def bandpass(stack, noise_size: Tuple[float, ...],
             boxcar_size: Tuple[int, ...], clip: bool = True):
    """trackpy-style bandpass: Gaussian smoothing at ``noise_size`` minus
    the boxcar background at ``boxcar_size``, clipped at zero.

    ``clip=False`` returns the difference unclipped: thresholds are taken
    from it, since after the clip most background pixels are exactly 0
    and their median and MAD collapse."""
    out = gaussian_blur(stack, noise_size) - boxcar_background(
        stack, boxcar_size)
    return torch.clamp(out, min=0.0) if clip else out


def _per_tile(x, tile: int):
    """[T, *S] -> ([T, *nt, tile**D] tile pixels, nt), reflect-padded at
    the far edges."""
    T = x.shape[0]
    spatial = tuple(x.shape[1:])
    D = len(spatial)
    nt = tuple(-(-s // tile) for s in spatial)
    for d, (n, s) in enumerate(zip(nt, spatial)):
        x = x.index_select(1 + d, _reflect_index(s, 0, n * tile - s,
                                                 x.device))
    shp = (T,)
    for n in nt:
        shp += (n, tile)
    x = x.reshape(shp)
    perm = (0,) + tuple(1 + 2 * d for d in range(D)) + tuple(
        2 + 2 * d for d in range(D))
    return x.permute(perm).reshape((T,) + nt + (tile ** D,)), nt


def tile_threshold_map(stack, tile: int = 64, k: float = 6.0,
                       bg_sigma: float = 2.0):
    """Locally adaptive threshold map [T, *S]: per-tile background (the
    median of the tile's raw pixels) plus ``k``·1.4826·per-tile noise (the
    MAD of a copy high-passed at ``bg_sigma`` px), bilinearly upsampled
    from the tile centers (half-pixel centers, edges clamped).

    The high pass keeps the tile's own background gradient out of the
    noise term; features hold few pixels of a tile, so the median and MAD
    are robust to them."""
    spatial = tuple(stack.shape[1:])
    D = len(spatial)
    x = stack.to(torch.float32)
    hp = x - gaussian_blur(x, (float(bg_sigma),) * D)
    xt, nt = _per_tile(x, tile)
    ht, _ = _per_tile(hp, tile)
    med = np_median(xt)
    hmed = np_median(ht)
    mad = np_median(torch.abs(ht - hmed[..., None]))
    thr = med + k * 1.4826 * mad                          # [T, *nt]
    mode = "bilinear" if D == 2 else "trilinear"
    out = F.interpolate(thr[:, None], size=tuple(n * tile for n in nt),
                        mode=mode, align_corners=False)[:, 0]
    return out[(slice(None),) + tuple(slice(0, s) for s in spatial)]


def _dilate(x, window):
    """Grey dilation of [T, *S] by an odd box, -inf outside the frame."""
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(x[:, None], kernel_size=window, stride=1,
                padding=tuple(w // 2 for w in window))[:, 0]


def _candidate_mask(stack, separation, threshold):
    """Strict local maxima of [T, *S] above ``threshold`` ([T] or [T, *S])
    with grey_dilation's tie-break: among equal values within a window,
    only the lowest flat index wins (-index as float32 is exact below
    2²⁴ pixels a frame)."""
    window = tuple(int(s) | 1 for s in separation)
    img = stack.to(torch.float32)
    T = img.shape[0]
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    if thr.dim() == 1:
        thr = thr.reshape((T,) + (1,) * (img.dim() - 1))
    cand = (img >= _dilate(img, window)) & (img > thr)
    n_total = int(np.prod(img.shape[1:]))
    neg_idx = -torch.arange(n_total, dtype=torch.float32,
                            device=img.device).reshape(img.shape[1:])
    neg_idx = torch.where(cand, neg_idx, -torch.inf)
    return img, cand & (neg_idx >= _dilate(neg_idx, window))


def _unravel(flat_idx, shape):
    """[..., K] flat indices -> [..., K, D] int32 coordinates."""
    coords = []
    for s in reversed(shape):
        coords.append(flat_idx % s)
        flat_idx = torch.div(flat_idx, s, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=-1).to(torch.int32)


def _batched(fn):
    """Let ``fn(stack [T, *S], ..., threshold [T] | [T, *S])`` take one
    frame [*S] (with a scalar or [*S] threshold) as well."""

    def wrapper(image, separation, max_features, threshold=0.0):
        image = torch.as_tensor(image)
        if image.dim() == len(separation):
            thr = torch.as_tensor(threshold, dtype=torch.float32,
                                  device=image.device)
            out = fn(image[None], separation, max_features,
                     thr.reshape((1,) + thr.shape))
            return tuple(o[0] for o in out)
        return fn(image, separation, max_features, threshold)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@_batched
def local_maxima(stack, separation: Tuple[int, ...], max_features: int,
                 threshold=0.0):
    """Local maxima per frame, compacted to a fixed-size list,
    brightest first.

    Returns (coords [T, K, D] int32, values [T, K], valid [T, K] bool,
    n_cand [T] int64), K = ``max_features``; padding entries have value
    -inf, coords 0 and valid False.  ``n_cand`` is the total number of
    candidates; where it exceeds K, the list holds the first K in RASTER
    order (a cumsum compaction, no full-frame sort) — re-run such frames
    through ``local_maxima_topk``."""
    img, is_max = _candidate_mask(stack, separation, threshold)
    T = img.shape[0]
    K = int(max_features)
    flags = is_max.reshape(T, -1)
    vals_flat = img.reshape(T, -1)
    rank = torch.cumsum(flags.to(torch.int64), dim=1) - 1
    dest = torch.where(flags & (rank < K), rank, K)
    vals_c = torch.full((T, K + 1), -torch.inf, device=img.device)
    vals_c = vals_c.scatter(1, dest, vals_flat)[:, :K]
    n_total = flags.shape[1]
    idx_c = torch.zeros((T, K + 1), dtype=torch.int64, device=img.device)
    idx_c = idx_c.scatter(1, dest, torch.arange(
        n_total, device=img.device).expand(T, n_total))[:, :K]
    # brightest first; ties toward the lower flat index (a stable sort of
    # the raster-ordered list)
    order = torch.argsort(-vals_c, dim=1, stable=True)
    vals = torch.gather(vals_c, 1, order)
    flat_idx = torch.gather(idx_c, 1, order)
    coords = _unravel(flat_idx, tuple(img.shape[1:]))
    return coords, vals, torch.isfinite(vals), flags.sum(dim=1)


@_batched
def local_maxima_topk(stack, separation: Tuple[int, ...], max_features: int,
                      threshold=0.0):
    """The brightest ``max_features`` candidates of each frame, by a
    stable descending sort of the whole frame (among equal values the
    lower flat index first, as ``lax.top_k``).  Same contract as
    ``local_maxima``, but exact on a frame with more candidates than
    K."""
    img, is_max = _candidate_mask(stack, separation, threshold)
    T = img.shape[0]
    key = torch.where(is_max, img, -torch.inf).reshape(T, -1)
    vals, flat_idx = torch.sort(key, dim=1, descending=True, stable=True)
    K = int(max_features)
    vals, flat_idx = vals[:, :K], flat_idx[:, :K]
    coords = _unravel(flat_idx, tuple(img.shape[1:]))
    return (coords, vals, torch.isfinite(vals),
            is_max.reshape(T, -1).sum(dim=1))


def grey_dilation(image, separation, percentile: float = 64.0,
                  max_features: int = 1024, threshold=None):
    """trackpy.grey_dilation-compatible wrapper for one frame: the
    threshold defaults to the ``percentile`` of the image.  Returns
    (coords, signal, valid); a frame with more than ``max_features``
    candidates is re-run through ``local_maxima_topk`` (and a warning
    logged), so the result is the globally brightest."""
    image = torch.as_tensor(image)
    if threshold is None:
        threshold = float(np.percentile(image.cpu().numpy(), percentile))
    sep = separation if hasattr(separation, "__len__") else (
        (separation,) * image.dim())
    sep = tuple(int(round(s)) for s in sep)
    coords, vals, valid, n_cand = local_maxima(image, sep, max_features,
                                               threshold)
    if int(n_cand) > max_features:
        logging.getLogger(__name__).warning(
            "grey_dilation: %d candidates exceed max_features=%d; "
            "keeping the brightest (raise max_features or threshold)",
            int(n_cand), max_features)
        coords, vals, valid, _ = local_maxima_topk(image, sep, max_features,
                                                   threshold)
    return coords, vals, valid


def feature_sizes(stack, coords, valid, window_shape, radius, bg,
                  noise=None, per_axis: bool = False):
    """Per-candidate size (trackpy.locate's 'size'): the radius of
    gyration of the background-subtracted intensity about the candidate's
    intensity centroid, in a mask of radius 0.4·min(radius) (scaled per
    axis by radius/min(radius)), corrected for the mask's truncation by
    inverting the discrete masked moment of a Gaussian by bisection.

    stack [T, *S] f32; coords [T, K, D] int; valid [T, K] bool; bg [T]
    (per-frame background); noise [T] or None (the weight floors at
    bg + noise).  Returns [T, K] sizes, or [T, K, D] with ``per_axis``,
    clipped to [0.5, radius] and 0 where not valid."""
    T, K, D = coords.shape
    device = stack.device
    frame_shape = tuple(stack.shape[1:])
    w = torch.as_tensor(window_shape, dtype=torch.int32, device=device)
    offsets = window_offsets(window_shape, torch.float32, device)  # [D, Np]
    r_np = np.asarray(radius, dtype=np.float32)
    Rm = 0.40 * float(np.min(r_np))
    Rm2 = Rm * Rm
    axis_ratio = torch.as_tensor(r_np / np.min(r_np), device=device)
    if noise is None:
        noise = torch.zeros((T,), dtype=torch.float32, device=device)

    pos = coords.reshape(T * K, D).to(torch.int32)
    frame_idx = torch.arange(T, dtype=torch.int32,
                             device=device).repeat_interleave(K)
    origin = clamp_origins(pos - torch.div(w - 1, 2, rounding_mode="floor"),
                           window_shape, frame_shape)
    win = gather_stack(stack, frame_idx, origin, window_shape)  # [TK, Np]
    rel = (pos - origin).to(torch.float32)
    d = (offsets[None] - rel[..., None]) / axis_ratio[None, :, None]
    r2_px = torch.sum(d * d, dim=1)                             # [TK, Np]
    inmask = (r2_px <= Rm2).to(torch.float32)
    bg_l = bg.to(torch.float32).repeat_interleave(K)[:, None]
    ns_l = noise.to(torch.float32).repeat_interleave(K)[:, None]
    mass = torch.clamp(win - bg_l - ns_l, min=0.0) * inmask
    m0 = torch.clamp(torch.sum(mass, dim=1), min=1e-6)
    m1 = torch.sum(mass[:, None, :] * d, dim=2) / m0[:, None]
    rg2 = torch.sum(mass * r2_px, dim=1) / m0 - torch.sum(m1 * m1, dim=1)

    def m_disc(sig):
        wgt = torch.exp(
            -r2_px / torch.clamp(2.0 * sig * sig, min=1e-12)[:, None]
        ) * inmask
        w0 = torch.clamp(torch.sum(wgt, dim=1), min=1e-9)
        return torch.sum(wgt * r2_px, dim=1) / w0

    lo_s = torch.full_like(rg2, 0.3)
    hi_s = torch.full_like(rg2, 1.5 * Rm)
    for _ in range(24):
        mid = 0.5 * (lo_s + hi_s)
        too_small = m_disc(mid) < rg2
        lo_s = torch.where(too_small, mid, lo_s)
        hi_s = torch.where(too_small, hi_s, mid)
    sig_iso = 0.5 * (lo_s + hi_s)
    if not per_axis:
        sizes = torch.clamp(sig_iso.reshape(T, K), 0.5, float(np.min(r_np)))
        return torch.where(valid, sizes, 0.0)
    # per-axis: the corrected size carries the truncation fix, the
    # per-axis central moments the shape, axis_ratio the pixel units
    m2 = (torch.sum(mass[:, None, :] * (d * d), dim=2) / m0[:, None]
          - m1 * m1)                                            # [TK, D]
    shape_r = torch.sqrt(torch.clamp(
        D * m2 / torch.clamp(rg2, min=1e-9)[:, None], min=1e-6))
    sizes = (sig_iso[:, None] * shape_r * axis_ratio[None, :]).reshape(
        T, K, D)
    sizes = torch.minimum(torch.clamp(sizes, min=0.5),
                          torch.as_tensor(r_np, device=device))
    return torch.where(valid[..., None], sizes, 0.0)
