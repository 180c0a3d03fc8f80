"""End-to-end video tracking: locate → find → refine → link.

Counterpart of ``clustertracking_tpu/pipeline.py``.  ``locate`` and
``_locate_frames`` find integer-pixel local maxima above a noise-robust
threshold, with a per-candidate size estimate, to seed ``find_clusters``
and ``refine_leastsq``: frames are stacked ``stack_chunk`` at a time onto
the device, where the filters, the threshold statistics, the maxima and
the sizes are computed (``ops/locate.py``); the per-frame size band and
the DataFrame are built on the host.  ``track`` composes locate,
``find_clusters``, ``refine_leastsq`` and ``link`` over a video, in one
shot or in checkpointed chunks, every stage on one device, with optional
residual re-locate recovery passes after the fit
(``_refine_with_recovery``): the accepted fits are rendered on the device
(``ops/synth.py``), subtracted from the frames (``_ResidualReader``), the
residual is located again, and the candidates it yields are refitted
with their clusters and kept only where the gates below accept them.
Frames are read from the reader by every stage; ``transfer_dtype``
quantizes them on the host first (``_TransferReader``).
"""
from __future__ import annotations

import numbers
import time
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from . import diagnostics
from .find import find_clusters
from .link import link as _link
from .ops.locate import (
    bandpass, feature_sizes, gaussian_blur, local_maxima_topk, np_median,
    np_percentile, tile_threshold_map)
from .refine import _mesh_device, _stack_frames, refine_leastsq
from .utils import default_pos_columns, default_size_columns, validate_tuple
from .utils.device import _resolve_device

if TYPE_CHECKING:
    import pandas as pd

# The recovery passes' gates, the reference's values (pipeline.py:28-109,
# where each was swept at config 5's full scale); module-level so an
# experiment can flip them, as the reference's tests do.
# mirror an original across a residual lobe near it (blend split)
_BLEND_SPLIT = True
# px a recovered candidate may move in the refit; None disables
# (track(recover_disp_gate=...) overrides per call)
_DISP_GATE = 3.5
# residual candidates closer to an accepted fit than this fraction of
# locate_separation are fit-imperfection lobes, dropped
_ON_TOP_FRAC = 0.5
# a cluster's joint refit rms must beat its footprint's previous residual
# rms by this factor (track(recover_accept_ratio=...))
_ACCEPT_RATIO = 0.9
# recovered rows fitted below this fraction of the accepted median signal
# (capped at 0.8x the accepted 2nd percentile) are shoulder lobes
# (track(recover_min_signal_frac=...))
_MIN_SIGNAL_FRAC = 0.25
# ...and the old footprint rms must exceed the residual noise floor by
# this factor where the noise-evidence gate applies
_NOISE_EVIDENCE = 6.0
# experiment hooks: a list collects (joint rms, old footprint rms, noise,
# candidates) per touched cluster; a dict collects each pass's located
# candidates and every recovered row's gate (and, in the port, the fitted
# rows before the first pass and after each, under 'passes'); True tags
# the output rows with the pass that accepted them (``recovered_pass``)
_DEBUG_ACCEPT = None
_DEBUG_STASH = None
_TAG_RECOVERED = False
# rows of clusters that gained no candidate keep their accepted position
# and signal; False emits them as the reference does (its
# pipeline.py:802-810), moved and halved where a mirror or split-probe
# whose candidate was dropped over the cap left them so, for comparisons
# with it
_KEEP_REST_FITS = True
# the threshold statistics (median, MAD, percentile) come from every 4th
# pixel along each axis; a frame whose sample would hold fewer than this
# many pixels (2D under 256², 3D under 64³) takes all of its pixels.  None
# subsamples every frame, as the reference does (its pipeline.py:1489-
# 1493), for comparisons with it: on a 32² frame its floors come from 64
# pixels and `percentile` is not the frame's percentile
_FULL_STATS_BELOW = 4096
# the joint refit's iteration budget (None = the caller's lm_max_iter /
# max_iter): warm-started near the answer, a capped budget reaches the
# same accept decisions
_REFIT_LM_MAX_ITER = 16
_REFIT_MAX_ITER = 2
# matched-filter residual locate (smoothed with the fitted PSF width)
_MATCH_FILTER = True
# the residual locate's noise gate in robust sigmas above the median
_RECOVERY_NOISE_K = 6.0
# originals above this multiple of the accepted median signal are split
# along their residual's quadrupole axis; None/0 disables
# (track(recover_split_excess=...))
_SPLIT_SIG_EXCESS = 1.2
_SPLIT_WINDOW = 9
# an accepted recovered candidate closer than this fraction of
# min(locate_separation) to another accepted feature is a duplicate
_DUP_R_FRAC = 0.35
# device bytes the residual frames of one pass may hold in their cache;
# frames past it are rendered again when read again
_RESIDUAL_CACHE_BYTES = 2 << 30

__all__ = ["locate", "track"]


def locate(
    image,
    diameter,
    separation=None,
    threshold=None,
    percentile: float = 64.0,
    max_features: int = 4096,
    pos_columns: Optional[list] = None,
    preprocess: Optional[str] = None,
    noise_size=1.0,
    threshold_tile: Optional[int] = None,
    device=None,
) -> "pd.DataFrame":
    """Candidate features of one frame (integer-pixel local maxima), the
    trackpy.locate stand-in that seeds find_clusters.

    ``threshold=None`` takes the ``percentile`` of the frame floored at
    median + 6 robust sigma (1.4826·MAD; where the MAD is 0, as on
    quantized frames, (q90 − median)/1.2816), both from a 4×-strided
    subsample (every pixel of a frame under 256², 3D under 64³; the
    reference subsamples those too, ``_FULL_STATS_BELOW``).
    ``preprocess='bandpass'`` smooths at ``noise_size`` px and
    subtracts a diameter-scale boxcar background first (frames with
    uneven illumination); ``threshold_tile`` (px) makes the default floor
    a per-tile median + MAD map.  ``device``: None is 'cuda', and raises
    ``RuntimeError`` where no CUDA device exists; pass ``device='cpu'``
    to run on the host.  Returns a DataFrame with the position columns,
    'signal' (the peak value), 'size' and, in 3D, per-axis sizes."""
    if not isinstance(image, torch.Tensor):
        image = np.asarray(image)
    ndim = image.ndim
    if pos_columns is None:
        pos_columns = default_pos_columns(ndim)
    if separation is None:
        separation = diameter
    separation = validate_tuple(separation, ndim)

    class _One:
        def __getitem__(self, t):
            return image

        def __len__(self):
            return 1

    f = _locate_frames(
        _One(), [0], validate_tuple(diameter, ndim), separation,
        threshold, percentile, max_features, "frame",
        preprocess=preprocess, noise_size=noise_size,
        threshold_tile=threshold_tile, device=device,
    ).drop(columns=["frame"])
    default_cols = default_pos_columns(ndim)
    if list(pos_columns) != default_cols:
        f = f.rename(columns=dict(zip(default_cols, pos_columns)))
    return f


def _shrink_sizes(sizes, valid):
    """Clip per-candidate size estimates to a robust per-frame band,
    ``median ± max(0.15·median, 3·1.4826·MAD)`` of the frame's own
    estimates: on a monodisperse frame that is ±15% of the median (a
    blended blob's moment reads the pair's extent, not the PSF), on a
    polydisperse one the spread widens the band so every mode survives."""
    out = sizes.copy()
    for j in range(sizes.shape[0]):
        ok = valid[j]
        if not ok.any():
            continue
        s = sizes[j][ok]
        m = float(np.median(s))
        half = max(0.15 * m, 3.0 * 1.4826 * float(np.median(np.abs(s - m))))
        out[j][ok] = np.clip(s, m - half, m + half)
    return out


def _subsample(x, T):
    """[T, *S] -> [T, n] flattened statistics sample: every 4th pixel
    along each axis, n = N/4^D (an exact median sorts every pixel; ~16k
    samples of a 512² frame estimate the floors to ~1% of sigma), or all
    N pixels where that sample would hold fewer than
    ``_FULL_STATS_BELOW``."""
    ix = (slice(None),) + (slice(None, None, 4),) * (x.dim() - 1)
    sub = x[ix]
    if _FULL_STATS_BELOW is not None and sub[0].numel() < _FULL_STATS_BELOW:
        return x.reshape(T, -1)
    return sub.reshape(T, -1)


def _locate_frames(
    reader, frame_numbers, diameter, locate_separation, threshold,
    percentile, max_features, t_column, stack_chunk: int = 64,
    match_sigma=None, preprocess=None, noise_size=1.0,
    threshold_tile=None, noise_k: float = 6.0, device=None,
):
    """Candidate features of many frames, ``stack_chunk`` frames per batch
    on ``device`` (None: 'cuda', as ``locate``); frames of differing shapes
    go one by one through ``locate``.

    ``match_sigma`` (px, per axis or scalar) turns on matched-filter
    detection: peaks are found on a Gaussian-smoothed copy, thresholded
    against that copy's own median + ``noise_k``·MAD (an explicit
    ``threshold`` is in raw-amplitude units), and their values scaled back
    to amplitude assuming features of width ≈ match_sigma; sizes still
    come from the unsmoothed frames.  ``preprocess='bandpass'``: the
    thresholds, peaks and sizes all run on the bandpassed stack, the
    statistics on its unclipped copy, and the sizes are deconvolved from
    the ``noise_size`` smoothing.  A frame with more candidates than
    ``max_features`` keeps the brightest (``local_maxima_topk``)."""
    import pandas as pd

    if preprocess not in (None, "raw", "bandpass"):
        raise ValueError(
            f"Unknown preprocess={preprocess!r}; use None or 'bandpass'"
        )
    device = _resolve_device(device, "locate")
    frame_numbers = list(frame_numbers)
    out = []
    for i in range(0, len(frame_numbers), stack_chunk):
        chunk = frame_numbers[i:i + stack_chunk]
        images = [reader[t] for t in chunk]
        if len({tuple(im.shape) for im in images}) != 1:
            for t, im in zip(chunk, images):
                f_t = locate(
                    im, diameter, locate_separation, threshold=threshold,
                    percentile=percentile, max_features=max_features,
                    preprocess=preprocess, noise_size=noise_size,
                    threshold_tile=threshold_tile, device=device,
                )
                f_t[t_column] = t
                out.append(f_t)
            continue
        T = len(chunk)
        stack = _stack_frames(dict(zip(map(int, chunk), images)), chunk,
                              device)
        ndim = stack.dim() - 1
        nsz = tuple(float(s) for s in validate_tuple(noise_size, ndim))
        if preprocess == "bandpass":
            bsz = tuple(int(round(d)) | 1
                        for d in validate_tuple(diameter, ndim))
            # statistics from the UNCLIPPED difference (see bandpass)
            stat_src = bandpass(stack, nsz, bsz, clip=False)
            stack = torch.clamp(stat_src, min=0.0)
        else:
            stat_src = stack
        flat = _subsample(stat_src, T)
        med = np_median(flat, dim=1)
        mad = np_median(torch.abs(flat - med[:, None]), dim=1)
        # A quantized frame's MAD is exactly 0 when more than half its
        # pixels share the median (uint8 background clipped at 0, say):
        # then the scale is (q90 − median)/1.2816, which stays 0 on a truly
        # flat noiseless background.
        q90 = np_percentile(flat, 90.0, dim=1)
        noise = torch.where(mad > 0, 1.4826 * mad,
                            torch.clamp((q90 - med) / 1.2816, min=0.0))
        if threshold is not None:
            thr = torch.full((T,), threshold, dtype=torch.float32,
                             device=device)
        elif threshold_tile:
            thr = tile_threshold_map(stat_src, int(threshold_tile))
        else:
            thr = torch.maximum(np_percentile(flat, percentile, dim=1),
                                med + noise_k * noise)
        sep = tuple(int(round(s)) for s in locate_separation)

        loc_stack = stack
        amp_corr = 1.0
        if match_sigma is not None:
            sig = tuple(float(s) for s in validate_tuple(match_sigma, ndim))
            loc_stack = gaussian_blur(stack, sig)
            sflat = _subsample(loc_stack, T)
            smed = np_median(sflat, dim=1)
            snoise = 1.4826 * np_median(torch.abs(sflat - smed[:, None]),
                                        dim=1)
            # a matched Gaussian's peak drops by σ/√(σ² + σ_k²) per axis,
            # 2^{-D/2} for σ ≈ σ_k
            att = 2.0 ** (-0.5 * len(sig))
            amp_corr = 1.0 / att
            if threshold is not None:
                thr = torch.full((T,), threshold * att, dtype=torch.float32,
                                 device=device)
            elif threshold_tile:
                thr = tile_threshold_map(loc_stack, int(threshold_tile))
            else:
                thr = torch.maximum(np_percentile(sflat, percentile, dim=1),
                                    smed + noise_k * snoise)

        diam = validate_tuple(diameter, ndim)
        wshape = tuple(int(round(d)) | 1 for d in diam)
        radius = tuple(d / 2.0 for d in diam)
        # brightest first, exact on a frame with more than max_features
        # candidates: the same valid entries as the reference's compaction
        # (local_maxima) with its re-run of such frames through
        # local_maxima_topk, on one path
        coords_d, vals_d, valid_d, _ = local_maxima_topk(
            loc_stack, sep, max_features, thr)
        sizes_d = feature_sizes(stack, coords_d, valid_d, wshape, radius,
                                med, noise=noise, per_axis=True)
        coords = coords_d.cpu().numpy()
        vals = vals_d.cpu().numpy() * amp_corr
        valid = valid_d.cpu().numpy()
        sizes_ax = sizes_d.cpu().numpy()
        if preprocess == "bandpass":
            # the noise_size smoothing widens the moment estimate to
            # sqrt(σ² + noise_size²): deconvolve
            nsz_ax = np.asarray(nsz, np.float32)
            sizes_ax = np.sqrt(np.maximum(
                sizes_ax ** 2 - nsz_ax[None, None, :] ** 2, 0.25))
        for ax in range(sizes_ax.shape[-1]):
            sizes_ax[..., ax] = _shrink_sizes(sizes_ax[..., ax], valid)
        # the isotropic size: the geometric mean of the axes
        with np.errstate(divide="ignore"):
            sizes = np.exp(np.mean(np.log(np.maximum(sizes_ax, 1e-9)),
                                   axis=-1)) * (valid > 0)
        pos_columns = default_pos_columns(ndim)
        aniso_cols = default_size_columns(ndim, False)
        for j, t in enumerate(chunk):
            ok = valid[j]
            f_t = pd.DataFrame(coords[j][ok].astype(float),
                               columns=pos_columns)
            f_t["signal"] = vals[j][ok]
            f_t["size"] = sizes[j][ok]
            if ndim == 3:
                # per-axis size columns select refine's anisotropic model
                for ax, c in enumerate(aniso_cols):
                    f_t[c] = sizes_ax[j, ok, ax]
            f_t[t_column] = t
            out.append(f_t)
    return pd.concat(out, ignore_index=True)


def track(
    reader,
    diameter,
    separation=None,
    search_range: Optional[float] = None,
    memory: int = 0,
    n_frames: Optional[int] = None,
    locate_separation=None,
    threshold=None,
    percentile: float = 64.0,
    max_features: int = 4096,
    preprocess: Optional[str] = None,
    noise_size=1.0,
    threshold_tile: Optional[int] = None,
    link_backend: Optional[str] = None,
    find_backend: str = "auto",
    t_column: str = "frame",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 16,
    recover_passes: int = 0,
    recover_min_signal_frac: Optional[float] = None,
    recover_accept_ratio: Optional[float] = None,
    recover_disp_gate=-1.0,
    recover_split_excess=-1.0,
    transfer_dtype=None,
    mesh=None,
    device=None,
    **refine_kwargs,
) -> "pd.DataFrame":
    """Full pipeline over a video reader: returns refined, linked features.

    Stages: ``_locate_frames`` (candidates), ``find_clusters``
    (``find_backend``), ``refine_leastsq`` (``refine_kwargs``; clusters
    over ``max_cluster_size`` spill to the host scipy fit), the recovery
    passes, and ``link`` (``link_backend``, None meaning 'auto' here).
    Under ``diagnostics.collect()`` the loss ledger counts each stage's
    features and keeps the stage walls (``locate_s``, ``find_s``,
    ``fit_s`` with the recovery passes in it, ``link_s``), the resolved
    ``link_backend``, after a device auction its rounds and host syncs
    over the frames (``link_rounds``, ``link_syncs``), and each recovery
    stage's counts and walls
    (``residual_candidates``, ``recovered_candidates``, the per-gate
    drops and prunes, ``recovery_*_s``).

    ``recover_passes``: overlapping features whose peaks merge are
    invisible to a local-maxima locator.  Each pass renders the accepted
    fits on the device, subtracts them from the frames, locates the
    residual (matched filter) — where the missed partner of a blended
    pair stands alone — and refits every cluster that gained a candidate,
    warm-started from the previous fits.  A candidate is kept only if its
    cluster's refit beats the previous model's rms on the same footprint
    by ``recover_accept_ratio`` (default 0.9) and it passes the
    zero-signal, shoulder-lobe (``recover_min_signal_frac``, default
    0.25 of the accepted median signal), displacement
    (``recover_disp_gate`` px, default 3.5; None disables) and duplicate
    gates; originals whose signal exceeds ``recover_split_excess`` (default
    1.2) times the accepted median are split along their residual's
    quadrupole axis (None disables).  A gate argument left at -1 (any real
    number equal to -1) takes its default.  Passes stop early when a
    residual sweep finds nothing new.

    ``transfer_dtype`` (e.g. 'float16'): every frame is cast to it on the
    host and back to float32 on the device, and every stage reads those
    frames; a frame with a value the dtype cannot hold (above 65504 for
    float16) raises ``ValueError`` before any stage runs.

    ``reader[t]`` must yield frames (numpy arrays or tensors).
    ``locate_separation`` defaults to half the separation per axis (at
    least 2 px), ``search_range`` to the mean diameter;
    ``preprocess='bandpass'`` makes the background a fitted per-cluster
    parameter unless ``param_mode`` names it.

    ``checkpoint_dir``: process the video in ``checkpoint_every``-frame
    chunks, persisting the accumulated results (``results.pkl``) and the
    host ``Linker``'s state (``state.json``) after each chunk, atomically;
    the same call resumes after the last complete chunk.  Recovery passes
    run within each chunk, so their population statistics are the
    chunk's; with a chunk that spans the video the result equals a
    single-shot run with ``link_backend='host'`` (the device linkers have
    no serializable incremental form, so another ``link_backend`` raises
    ``ValueError``).  The layout is the reference's, so a checkpoint it
    wrote resumes here.

    ``device``: every stage runs there; None is 'cuda', and raises
    ``RuntimeError`` where no CUDA device exists; pass ``device='cpu'`` to
    run on the host.

    ``mesh`` (a ``parallel.sharding.make_mesh`` mesh): the main fit and
    the recovery refits split their lanes over its devices, and the
    single-shot run links frame-sharded (``link(mesh=...)``, the backend
    'auto' unless ``link_backend`` names an auction); locate and find run
    on ``device``, which defaults to the mesh's first, as in the
    reference.  A checkpointed run links with the host ``Linker``.  Any
    other ``mesh`` raises ``TypeError``.
    """
    device = _mesh_device(mesh, device, "track")
    if mesh is not None:
        refine_kwargs["mesh"] = mesh
    if n_frames is None:
        n_frames = len(reader)
    if transfer_dtype is not None:
        reader = _TransferReader(reader, transfer_dtype, device)
        reader.check(range(n_frames))
    if preprocess == "bandpass":
        # bandpass means the background is uneven, and refine fits the
        # RAW frames: fit the background per cluster unless the caller
        # chose a mode
        pm = dict(refine_kwargs.get("param_mode") or {})
        pm.setdefault("background", "cluster")
        refine_kwargs["param_mode"] = pm
    ndim0 = reader[0].ndim
    sep = separation if separation is not None else diameter
    if locate_separation is None:
        # cluster members sit CLOSER than `separation` by definition, so
        # peak suppression must use a tighter window or overlapping
        # features merge into one candidate
        locate_separation = tuple(
            max(2, int(round(s / 2))) for s in validate_tuple(sep, ndim0)
        )
    if search_range is None:
        search_range = float(np.mean(validate_tuple(diameter, ndim0)))
    locate_kw = dict(preprocess=preprocess, noise_size=noise_size,
                     threshold_tile=threshold_tile, device=device)
    recover_kw = dict(
        recover_passes=recover_passes,
        min_signal_frac=recover_min_signal_frac,
        accept_ratio=recover_accept_ratio,
        disp_gate=recover_disp_gate,
        split_excess=recover_split_excess,
    )
    if checkpoint_dir is not None:
        if link_backend not in (None, "host"):
            raise ValueError(
                "checkpointed track() links with the serializable host "
                "Linker; link_backend='device' is not resumable — omit "
                "link_backend or pass 'host'"
            )
        return _track_checkpointed(
            reader, diameter, sep, search_range, memory, n_frames,
            locate_separation, threshold, percentile, max_features,
            find_backend, t_column, checkpoint_dir, checkpoint_every,
            refine_kwargs, locate_kw, recover_kw,
        )
    t0 = time.perf_counter()
    with diagnostics.stage("track.locate", {"frames": n_frames}):
        f = _locate_frames(
            reader, range(n_frames), diameter, locate_separation, threshold,
            percentile, max_features, t_column, **locate_kw,
        )
    t1 = time.perf_counter()
    with diagnostics.stage("track.find", {"features": len(f)}):
        f = find_clusters(f, sep, t_column=t_column, backend=find_backend,
                          device=device)
    t2 = time.perf_counter()
    with diagnostics.stage("track.refine"):
        f, n_spill = _refine_with_recovery(
            f, reader, diameter, sep, range(n_frames), locate_separation,
            threshold, percentile, max_features, find_backend, t_column,
            default_pos_columns(ndim0), refine_kwargs, locate_kw,
            **recover_kw,
        )
    t3 = time.perf_counter()
    ok = f["cost"].notna()
    # loss ledger: every feature between locate and the linked output is
    # accounted for (spilled features are still fit, on the host scipy
    # path, so they are a slow bucket, not a loss)
    diagnostics.record_ledger(
        frames=n_frames,
        candidates_located=len(f),
        clusters=int(f["cluster"].nunique()),
        features_spilled_to_scipy=n_spill,
        fit_accepted=int(ok.sum()),
        fit_rejected=int((~ok).sum()),
    )
    f = f[ok].reset_index(drop=True)
    t4 = time.perf_counter()
    backend = link_backend if link_backend is not None else "auto"
    with diagnostics.stage("track.link",
                           {"backend": backend, "features": len(f)}):
        out = _link(f, search_range, memory=memory, t_column=t_column,
                    backend=backend, mesh=mesh, device=device)
    if len(f):  # an empty table runs no auction: last_stats is older
        _record_auction(out.attrs.get("link_backend"))
    diagnostics.record_ledger(
        linked=len(out),
        locate_s=round(t1 - t0, 4),
        find_s=round(t2 - t1, 4),
        fit_s=round(t3 - t2, 4),
        link_s=round(time.perf_counter() - t4, 4),
        link_backend=out.attrs.get("link_backend", "?"),
    )
    return out


def _record_auction(backend):
    """After a device auction (``link`` on one device, dense or binned):
    its rounds and host syncs over every frame, from the linker's
    ``last_stats``, as the ledger's ``link_rounds`` and ``link_syncs``."""
    from .ops.link import link_on_device, link_on_device_binned

    linker = {"device": link_on_device,
              "device-binned": link_on_device_binned}.get(backend)
    stats = linker.last_stats if linker is not None else None
    if stats is not None:
        diagnostics.record_ledger(link_rounds=sum(stats["rounds"]),
                                  link_syncs=sum(stats["syncs"]))


def _gate_arg(value, default):
    """A recovery gate argument: ``default`` for the -1 sentinel, given
    as any real number equal to -1 (-1, -1.0, np.float32(-1)); else the
    value itself (None disables the gate)."""
    if isinstance(value, numbers.Real) and float(value) == -1.0:
        return default
    return value


def _refine_with_recovery(
    f, reader, diameter, sep, frame_numbers, locate_separation,
    threshold, percentile, max_features, find_backend, t_column,
    pos_columns, refine_kwargs, locate_kw, recover_passes=0,
    min_signal_frac=None, accept_ratio=None, disp_gate=-1.0,
    split_excess=-1.0,
):
    """refine_leastsq, then ``recover_passes`` residual re-locate passes
    (shared by the single-shot and checkpointed track paths).  Returns
    (refined DataFrame, the count of features spilled to scipy).

    The reference's steps and ledger keys (clustertracking_tpu/pipeline.py
    :342-1045), with its statistics, iteration orders and stable sorts,
    since each decides which candidate claims a mirror or survives a gate.
    One difference, a fix: rows of clusters that gained no candidate keep
    their accepted positions and signal (``_pre_*``) — the reference emits
    an original moved and halved by a mirror or split-probe whose
    candidate was then dropped over the cluster cap (its :802-810)."""
    from scipy.spatial import cKDTree
    import pandas as pd

    device = locate_kw["device"]
    accept_ratio = (_ACCEPT_RATIO if accept_ratio is None
                    else float(accept_ratio))
    disp_gate = _gate_arg(disp_gate, _DISP_GATE)
    split_excess = _gate_arg(split_excess, _SPLIT_SIG_EXCESS)
    max_cluster = int(refine_kwargs.get("max_cluster_size", 8))
    n_spill = int((f["cluster_size"] > max_cluster).sum())
    f = refine_leastsq(f, reader, diameter, sep, t_column=t_column,
                       device=device, **refine_kwargs)
    if _DEBUG_STASH is not None:
        _DEBUG_STASH.setdefault("passes", []).append(f.copy())
    for pass_idx in range(recover_passes):
        t_pass = time.perf_counter()
        dup_r = _DUP_R_FRAC * float(min(locate_separation))
        on_top_r = _ON_TOP_FRAC * float(min(locate_separation))
        acc = f[f["cost"].notna()]
        rreader = _ResidualReader(
            reader, acc, refine_kwargs.get("fit_function", "gauss"),
            t_column, pos_columns, device,
        )
        # matched-filter residual locate: smooth with the fitted PSF width
        msig = None
        if _MATCH_FILTER:
            size_cols = [c for c in ("size_z", "size_y", "size_x")
                         if c in acc.columns]
            if size_cols:
                msig = tuple(float(acc[c].median()) for c in size_cols)
            elif "size" in acc.columns:
                msig = float(acc["size"].median())
        new = _locate_frames(
            rreader, frame_numbers, diameter, locate_separation, threshold,
            percentile, max_features, t_column, match_sigma=msig,
            noise_k=_RECOVERY_NOISE_K, **locate_kw,
        )
        diagnostics.record_ledger(
            residual_candidates=len(new),
            recovery_locate_s=round(time.perf_counter() - t_pass, 4),
        )
        t_mark = time.perf_counter()
        if len(new):
            # drop residual candidates ON TOP of an accepted fit (an
            # imperfect fit's small residual peaks); the radius stays well
            # below the blend distance, where the hidden partner sits
            kept = []
            for t, g in new.groupby(t_column):
                at = acc[acc[t_column] == t]
                if len(at):
                    tree = cKDTree(at[pos_columns].to_numpy())
                    d, _ = tree.query(g[pos_columns].to_numpy(), k=1)
                    kept.append(g[d >= on_top_r])
                else:
                    kept.append(g)
            n0 = len(new)
            new = pd.concat(kept, ignore_index=True) if kept else new
            diagnostics.record_ledger(
                recovery_dropped_on_top_of_fit=n0 - len(new)
            )
        if not len(new):
            break
        if _DEBUG_STASH is not None:
            _DEBUG_STASH.setdefault("located", []).append(new.copy())
            _DEBUG_STASH.setdefault("rreader", []).append(rreader)
            _DEBUG_STASH.setdefault("match_sigma", []).append(msig)
        # every fitted parameter column of the accepted features is the
        # warm start and the fallback; candidates take the accepted
        # medians where they lack a column
        carry = [
            c for c in acc.columns
            if c not in ("cluster", "cluster_size", "cost",
                         "fit_converged", "fit_n_iter", "particle")
            and not c.endswith("_std")
        ]
        new_f = new.copy()
        for c in carry:
            if c not in new_f.columns:
                new_f[c] = float(acc[c].median())
        combined = pd.concat([acc[carry], new_f[carry]], ignore_index=True)
        combined["_recovered"] = np.concatenate(
            [np.zeros(len(acc), bool), np.ones(len(new), bool)])
        combined["_acc_row"] = np.concatenate(
            [np.arange(len(acc)), np.full(len(new), -1)])
        # each original's previous cost: the likelihood accept's reference
        combined["_old_cost"] = np.concatenate(
            [acc["cost"].to_numpy(dtype=float), np.full(len(new), np.nan)])
        # blend split: a residual candidate near an accepted fit usually
        # means that fit sits at the midpoint of a blended pair; mirror it
        # to the far side (o' = 2o − c) and halve its signal between the
        # two, so the refit starts near the pair.  0.45·sep keeps the
        # mirrored pair within one cluster.
        blend_r = (0.45 * float(min(np.atleast_1d(sep))) if _BLEND_SPLIT
                   else -1.0)
        # the pre-split snapshot: originals of a rejected cluster roll
        # back to these values
        for c in (*pos_columns, "signal"):
            combined[f"_pre_{c}"] = combined[c].to_numpy(dtype=float)
        # a copy: the columns may share one block, whose view is read-only
        pos_np = combined[pos_columns].to_numpy(copy=True)
        sig_np0 = combined["signal"].to_numpy().copy()
        rec_np = combined["_recovered"].to_numpy()
        oc_np = combined["_old_cost"].to_numpy()
        tcol_np = combined[t_column].to_numpy()
        # only an original with an elevated cost can be a blend
        med_cost = float(np.nanmedian(oc_np[~rec_np]))
        cost_gate = max(1.2 * med_cost, 1e-12)
        drop_dup = np.zeros(len(combined), bool)
        used_orig: set = set()
        claiming: set = set()
        for t in np.unique(tcol_np[rec_np]):
            in_t = np.nonzero(tcol_np == t)[0]
            orig_t = in_t[~rec_np[in_t]]
            new_t = in_t[rec_np[in_t]]
            if not len(orig_t) or not len(new_t):
                continue
            tree = cKDTree(pos_np[orig_t])
            # each original fires at most one mirror and is queried
            # before it moves: every lookup batches up front
            dq, kq = tree.query(pos_np[new_t])
            dq_of = dict(zip(new_t, dq))
            kq_of = dict(zip(new_t, kq))
            if len(orig_t) > 1:
                d2o_all = tree.query(pos_np[orig_t], k=2)[0][:, 1]
                d2o_of = dict(zip(orig_t, d2o_all))
            ctree = cKDTree(pos_np[new_t])
            # brightest candidates claim their blended partner first
            for j in new_t[np.argsort(-sig_np0[new_t])]:
                if drop_dup[j]:
                    continue
                d, k = dq_of[j], kq_of[j]
                o = orig_t[k]
                if d > blend_r or o in used_orig:
                    continue
                if not (oc_np[o] > cost_gate):
                    continue  # o's fit is clean: not a blend
                # a second original nearly on top of o: the refit already
                # has the spare feature it needs
                if len(orig_t) > 1 and d2o_of[o] < max(dup_r, 1.0):
                    continue
                used_orig.add(o)
                claiming.add(j)
                pos_np[o] = 2.0 * pos_np[o] - pos_np[j]
                half = 0.5 * sig_np0[o]
                sig_np0[o] = half
                sig_np0[j] = half
                for j2_idx in ctree.query_ball_point(
                        pos_np[o], max(dup_r, 1.0)):
                    j2 = new_t[j2_idx]
                    # strictly inside the radius (the ball is closed)
                    if (np.sum((pos_np[j2] - pos_np[o]) ** 2)
                            >= max(dup_r, 1.0) ** 2):
                        continue
                    # a candidate that fired a mirror stays
                    if j2 != j and j2 not in claiming:
                        drop_dup[j2] = True
        combined[pos_columns] = pos_np
        combined["signal"] = sig_np0
        diagnostics.record_ledger(
            recovery_blend_mirrors=len(claiming),
            recovery_dropped_redundant_lobe=int(drop_dup.sum()),
            recovery_prep_mirror_s=round(time.perf_counter() - t_mark, 4),
        )
        t_sub = time.perf_counter()
        if drop_dup.any():
            combined = combined[~drop_dup].reset_index(drop=True)
        combined, res_host, n_split = _split_probes(
            combined, acc, rreader, split_excess, pos_columns, t_column,
            sep)
        diagnostics.record_ledger(
            recovery_prep_split_s=round(time.perf_counter() - t_sub, 4)
        )
        t_sub = time.perf_counter()
        combined = find_clusters(combined, sep, t_column=t_column,
                                 backend=find_backend, device=device)
        # a candidate that pushes its cluster past the bucket cap would
        # send the whole group to the serial scipy spill: keep the
        # originals there
        over = combined["cluster_size"] > max_cluster
        drop = over & combined["_recovered"]
        diagnostics.record_ledger(recovery_dropped_over_cap=int(drop.sum()))
        if drop.any():
            if _DEBUG_STASH is not None:
                oc = combined[drop].copy()
                oc["gate"] = "over_cap"
                _DEBUG_STASH.setdefault("gated", []).append(oc)
            combined = combined.drop(columns=["cluster", "cluster_size"])[
                ~drop]
            combined = find_clusters(combined, sep, t_column=t_column,
                                     backend=find_backend, device=device)
        n_recovered = int(len(new) + n_split - drop_dup.sum() - drop.sum())
        if n_recovered == 0:
            break
        diagnostics.record_ledger(recovered_candidates=n_recovered)
        n_spill += int((combined["cluster_size"] > max_cluster).sum())
        sig_floor = 0.05 * float(acc["signal"].median())
        # only clusters that gained a candidate refit; the rest pass
        # through with their accepted fits
        in_refit = combined["cluster"].isin(
            combined.loc[combined["_recovered"], "cluster"]).to_numpy()
        rest = combined[~in_refit].copy()
        combined = combined[in_refit].reset_index(drop=True)
        diagnostics.record_ledger(
            recovery_prep_find_s=round(time.perf_counter() - t_sub, 4),
            recovery_prep_s=round(time.perf_counter() - t_mark, 4),
        )
        t_mark = time.perf_counter()
        # the previous model's residual rms on each refit cluster's own
        # footprint: the likelihood accept's reference
        old_ref, old_noise = _old_rms_on_footprint(
            combined, rreader, diameter, pos_columns, t_column,
            host_frames=res_host,
        )
        rreader.drop_cache()
        diagnostics.record_ledger(
            recovery_footprint_s=round(time.perf_counter() - t_mark, 4)
        )
        t_mark = time.perf_counter()
        # the refit rejects nothing on max_rms_dev (the accept below has
        # the right reference) and runs on a capped budget
        max_rms_dev = float(refine_kwargs.get("max_rms_dev", 1.0))
        rk_refit = dict(refine_kwargs, max_rms_dev=np.inf)
        if _REFIT_LM_MAX_ITER is not None:
            rk_refit["lm_max_iter"] = min(
                int(refine_kwargs.get("lm_max_iter", 60)),
                _REFIT_LM_MAX_ITER)
        if _REFIT_MAX_ITER is not None:
            rk_refit["max_iter"] = min(
                int(refine_kwargs.get("max_iter", 10)), _REFIT_MAX_ITER)
        f = refine_leastsq(combined, reader, diameter, sep,
                           t_column=t_column, device=device, **rk_refit)
        diagnostics.record_ledger(
            recovery_refit_s=round(time.perf_counter() - t_mark, 4)
        )
        t_mark = time.perf_counter()
        if len(rest):
            # untouched rows keep their accepted fits: every fitted column
            # of acc, their old cost, and their pre-split position and
            # signal (a mirror or split-probe whose candidate was dropped
            # over the cap moved and halved them)
            ar = rest["_acc_row"].to_numpy()
            for c in acc.columns:
                if c not in rest.columns and c != "particle":
                    rest[c] = acc[c].to_numpy()[ar]
            rest["cost"] = rest["_old_cost"]
            if _KEEP_REST_FITS:
                for c in (*pos_columns, "signal"):
                    rest[c] = rest[f"_pre_{c}"]
            f = pd.concat([f, rest], ignore_index=True)
        recovered_col = f["_recovered"].to_numpy()
        old_cost_col = f["_old_cost"].to_numpy()
        pre_cols = [f"_pre_{c}" for c in (*pos_columns, "signal")]
        pre_vals = f[pre_cols].to_numpy()
        f = f.drop(columns=["_recovered", "_old_cost", "_acc_row",
                            *pre_cols])
        if _TAG_RECOVERED:
            prev = (f["recovered_pass"].to_numpy()
                    if "recovered_pass" in f.columns
                    else np.zeros(len(f), np.int32))
            f["recovered_pass"] = np.where(recovered_col, pass_idx + 1, prev)
        f, n_restored, gate_counts = _accept_gates(
            f, acc, recovered_col, old_cost_col, pre_vals, old_ref,
            old_noise, pass_idx, accept_ratio, max_rms_dev, min_signal_frac,
            disp_gate, dup_r, sig_floor, pos_columns, t_column)
        if n_restored:
            diagnostics.record_ledger(refit_failures_restored=n_restored)
        diagnostics.record_ledger(
            recovery_accept_s=round(time.perf_counter() - t_mark, 4)
        )
        if gate_counts is not None:
            diagnostics.record_ledger(**gate_counts)
        if _DEBUG_STASH is not None:
            _DEBUG_STASH.setdefault("passes", []).append(f.copy())
    return f, n_spill


def _split_probes(combined, acc, rreader, split_excess, pos_columns,
                  t_column, sep):
    """Quadrupole split-probes: an original fitted at more than
    ``split_excess`` times the accepted median signal may be a pair whose
    peaks merged (no residual peak betrays it); it is split into two
    halves at ±δ along the axis of its residual's quadrupole tensor (δ
    from its width's excess over the median), the −δ half as a new
    candidate.  Returns (combined, the residual frames fetched on the
    host, as float16 values: the reference fetches them so, and the
    footprint reference reuses them, the count of probes)."""
    import pandas as pd

    res_host: dict = {}
    n_split = 0
    if not split_excess:
        return combined, res_host, n_split
    med_sig_acc = float(acc["signal"].median())
    Dn = len(pos_columns)
    aniso_cols = [c for c in ("size_z", "size_y", "size_x")
                  if c in combined.columns][:Dn]
    size_cols = (aniso_cols if len(aniso_cols) == Dn
                 else (["size"] if "size" in combined.columns else []))
    pos_c = combined[pos_columns].to_numpy(dtype=float)
    sig_c = combined["signal"].to_numpy(dtype=float)
    rec_c = combined["_recovered"].to_numpy()
    tcol_c = combined[t_column].to_numpy()
    # mirrored originals already halved their signal
    sus = np.nonzero(~rec_c & (sig_c > split_excess * med_sig_acc))[0]
    if not (len(sus) and size_cols):
        return combined, res_host, n_split
    med_sz = float(np.mean([float(acc[c].median()) for c in size_cols]))
    szs = combined[size_cols].to_numpy(dtype=float)[sus]
    sz_sc = np.exp(np.log(np.maximum(szs, 1e-6)).mean(axis=1))
    delta = np.sqrt(np.maximum(sz_sc**2 - med_sz**2, 0.0))
    # outside dup_r, inside one cluster
    delta = np.clip(delta, 0.85, 0.45 * float(min(np.atleast_1d(sep))))
    w_half = _SPLIT_WINDOW // 2
    axes = np.zeros((len(sus), Dn))
    for t in np.unique(tcol_c[sus]):
        res = res_host.get(int(t))
        if res is None:
            # the reference rounds these frames through float16 (to halve
            # its transfer); the quadrupole axes and the footprint noise
            # floors read these values, so the port rounds them alike
            res = rreader[int(t)].to(torch.float16).to(
                torch.float32).cpu().numpy()
            res_host[int(t)] = res
        sel = np.nonzero(tcol_c[sus] == t)[0]
        B = len(sel)
        shape = np.asarray(res.shape)
        P = np.round(pos_c[sus[sel]]).astype(int)
        o = np.clip(P - w_half, 0, shape - (2 * w_half + 1))
        ix = []
        for d in range(Dn):
            ar = o[:, d].reshape((B,) + (1,) * Dn) + np.arange(
                2 * w_half + 1).reshape(
                    (1,) * (1 + d) + (-1,) + (1,) * (Dn - 1 - d))
            ix.append(ar)
        win = res[tuple(np.broadcast_arrays(*ix))]
        red = tuple(range(1, 1 + Dn))
        r0 = win - win.mean(axis=red, keepdims=True)
        M = np.zeros((B, Dn, Dn))
        rel = [ix[d] - pos_c[sus[sel], d].reshape((B,) + (1,) * Dn)
               for d in range(Dn)]
        for a in range(Dn):
            for b in range(a, Dn):
                Mab = (r0 * rel[a] * rel[b]).sum(axis=red)
                M[:, a, b] = Mab
                M[:, b, a] = Mab
        _, evecs = np.linalg.eigh(M)
        axes[sel] = evecs[:, :, -1]
    # the original moves to +δv̂ (its snapshot keeps the pre-split
    # values), the candidate appears at −δv̂
    probes = combined.iloc[sus].copy()
    half = 0.5 * sig_c[sus]
    plus = pos_c[sus] + delta[:, None] * axes
    minus = pos_c[sus] - delta[:, None] * axes
    combined.loc[combined.index[sus], pos_columns] = plus
    combined.loc[combined.index[sus], "signal"] = half
    probes[pos_columns] = minus
    probes["signal"] = half
    probes["_recovered"] = True
    probes["_acc_row"] = -1
    probes["_old_cost"] = np.nan
    for c in (*pos_columns, "signal"):
        probes[f"_pre_{c}"] = probes[c].to_numpy(dtype=float)
    n_split = len(probes)
    combined = pd.concat([combined, probes], ignore_index=True)
    diagnostics.record_ledger(recovery_split_probes=n_split)
    return combined, res_host, n_split


def _accept_gates(f, acc, recovered_col, old_cost_col, pre_vals, old_ref,
                  old_noise, pass_idx, accept_ratio, max_rms_dev,
                  min_signal_frac, disp_gate, dup_r, sig_floor, pos_columns,
                  t_column):
    """The accept stage of a recovery pass, on the refit rows ``f`` (with
    the untouched rows after them).  Returns (the surviving rows, the
    count of rows rolled back to their previous fits, the per-gate ledger
    counts or None where nothing was pruned).

    Likelihood accept: a cluster with a candidate keeps its candidates
    only if its joint refit rms beats the previous model's rms on the same
    footprint by ``accept_ratio`` (and, for an all-new cluster or on
    passes after the first, that old rms stands ``_NOISE_EVIDENCE`` times
    above the footprint's noise floor); else its candidates go and its
    originals roll back to their pre-split fits.  Clusters without a
    candidate roll back where the uncapped refit broke ``max_rms_dev`` or
    regressed over 1.2× their old mean cost.  Then recovered rows are
    pruned by zero signal, low signal, displacement and duplication."""
    import pandas as pd
    from scipy.spatial import cKDTree

    ghost = np.zeros(len(f), dtype=bool)
    restore = np.zeros(len(f), dtype=bool)
    cl = f["cluster"].to_numpy()
    costs = f["cost"].to_numpy().copy()
    has_cand = np.zeros(len(f), dtype=bool)
    for cid in np.unique(cl[recovered_col]):
        rows_c = np.nonzero(cl == cid)[0]
        has_cand[rows_c] = True
        new_cost = costs[rows_c[0]]
        ref = old_ref.get(int(cid), np.nan)
        if _DEBUG_ACCEPT is not None:
            _DEBUG_ACCEPT.append({
                "cid": int(cid), "new_cost": float(new_cost),
                "ref": float(ref),
                "noise": float(old_noise.get(int(cid), 0.0)),
                "n_cand": int(recovered_col[rows_c].sum()),
                "all_new": bool(recovered_col[rows_c].all()),
            })
        all_new = bool(recovered_col[rows_c].all())
        # the noise-evidence gate: all-new clusters always; clusters with
        # originals from the second pass on (their real blends were
        # recovered in the first)
        evidence_ok = (
            ref > _NOISE_EVIDENCE * old_noise.get(int(cid), 0.0)
            if (all_new or pass_idx > 0) else True
        )
        if (np.isfinite(new_cost) and np.isfinite(ref)
                and new_cost <= accept_ratio * ref and evidence_ok):
            continue  # accepted: the candidates bought their place
        ghost[rows_c[recovered_col[rows_c]]] = True
        orig = rows_c[~recovered_col[rows_c]]
        good = orig[np.isfinite(old_cost_col[orig])]
        restore[good] = True
        costs[good] = old_cost_col[good]
    # the regression net for candidate-less clusters of the refit
    old_mean = (pd.Series(old_cost_col).groupby(cl).transform("mean")
                .to_numpy())
    bad = ~has_cand & (
        ~np.isfinite(costs)
        | (costs > max_rms_dev)
        | (np.isfinite(old_mean) & (costs > 1.2 * old_mean + 1e-12))
    )
    good = bad & np.isfinite(old_cost_col)
    restore[good] = True
    costs[good] = old_cost_col[good]
    costs[bad & ~good] = np.nan
    f["cost"] = costs
    if restore.any():
        vals = f[[*pos_columns, "signal"]].to_numpy(copy=True)
        vals[restore] = pre_vals[restore]
        f[[*pos_columns, "signal"]] = vals
    # a superfluous candidate converges to ~zero signal
    n_lr = int(ghost.sum())
    lr_mask = ghost.copy()
    zero_mask = (f["cost"].notna() & (f["signal"] < sig_floor)).to_numpy()
    ghost = pd.Series(ghost, index=f.index) | zero_mask
    n_sig = int(ghost.sum()) - n_lr
    # shoulder lobes: recovered rows fitted at a small fraction of the
    # accepted signal; the threshold is capped at 0.8x the accepted 2nd
    # percentile so a dim sub-population keeps its recoveries
    n_lowsig = 0
    sig_frac = (min_signal_frac if min_signal_frac is not None
                else _MIN_SIGNAL_FRAC)
    if sig_frac:
        sig_acc = acc["signal"].to_numpy(dtype=float)
        sig_thr = min(sig_frac * float(np.median(sig_acc)),
                      0.8 * float(np.percentile(sig_acc, 2.0)))
        low = (pd.Series(recovered_col, index=f.index)
               & f["cost"].notna() & (f["signal"] < sig_thr))
        before = int(ghost.sum())
        ghost |= low
        n_lowsig = int(ghost.sum()) - before
    # a candidate the refit dragged far from where it was seen
    n_disp = 0
    if disp_gate is not None:
        disp = np.linalg.norm(
            f[list(pos_columns)].to_numpy() - pre_vals[:, :len(pos_columns)],
            axis=1)
        before = int(ghost.sum())
        ghost |= pd.Series(recovered_col & (disp > disp_gate), index=f.index)
        n_disp = int(ghost.sum()) - before
    # the recovered one of an accepted pair closer than dup_r (the dimmer
    # if both are); originals are never dup-pruned
    gvals = ghost.to_numpy().copy()
    sig_np = f["signal"].to_numpy()
    okv = f["cost"].notna().to_numpy()
    for t, idx in f.groupby(t_column).indices.items():
        live = idx[okv[idx] & ~gvals[idx]]
        if len(live) < 2:
            continue
        tree = cKDTree(f.iloc[live][pos_columns].to_numpy())
        for a, b in tree.query_pairs(dup_r):
            ra, rb = recovered_col[live[a]], recovered_col[live[b]]
            if ra and rb:
                drop_j = (live[a] if sig_np[live[a]] <= sig_np[live[b]]
                          else live[b])
            elif ra:
                drop_j = live[a]
            elif rb:
                drop_j = live[b]
            else:
                continue
            gvals[drop_j] = True
    ghost = pd.Series(gvals, index=f.index)
    if _DEBUG_STASH is not None:
        # first-gate-wins label per recovered row
        lab = np.full(len(f), "accepted", object)
        disp_mask = ((recovered_col & (disp > disp_gate))
                     if disp_gate is not None else None)
        low_mask = low.to_numpy() if sig_frac else None
        dup_mask = gvals & ~np.asarray(
            lr_mask | zero_mask
            | (low_mask if low_mask is not None else False)
            | (disp_mask if disp_mask is not None else False))
        for name, m in (("duplicate", dup_mask),
                        ("displacement", disp_mask),
                        ("low_signal", low_mask),
                        ("zero_signal", zero_mask),
                        ("likelihood", lr_mask)):
            if m is not None:
                lab[np.asarray(m, bool)] = name
        g = f[recovered_col].copy()
        g["gate"] = lab[recovered_col]
        _DEBUG_STASH.setdefault("gated", []).append(g)
    counts = None
    if ghost.any():
        counts = dict(
            ghosts_pruned=int(ghost.sum()),
            recovery_rejected_likelihood=n_lr,
            recovery_pruned_zero_signal=n_sig,
            recovery_pruned_low_signal=n_lowsig,
            recovery_pruned_displacement=n_disp,
            recovery_pruned_duplicate=(
                int(ghost.sum()) - n_lr - n_sig - n_lowsig - n_disp),
        )
        f = f[~ghost]
    return f, int(restore.sum()), counts


def _floor_sample(res):
    """The pixels of a residual frame (numpy) that its noise floor comes
    from: every 4th along each axis, or every pixel where that sample
    would hold fewer than ``_FULL_STATS_BELOW`` (None: the strided sample
    on every frame, the reference's pipeline.py:1076-1081), as
    ``_subsample`` takes the threshold statistics."""
    sub = res[(slice(None, None, 4),) * res.ndim]
    if _FULL_STATS_BELOW is not None and sub.size < _FULL_STATS_BELOW:
        return res
    return sub


def _old_rms_on_footprint(g, rreader, diameter, pos_columns, t_column,
                          host_frames=None):
    """The previous model's residual rms per cluster on the cluster's own
    union-of-spheres footprint, in refine's cost units (rms of
    residual/norm over the mask, norm = max member |signal|), and the
    footprint's noise floor in the same units.

    ``g``: rows of the clusters to evaluate (with cluster and signal);
    ``rreader[t]``: data − previous model; ``host_frames``: residual
    frames already on the host, used instead of ``rreader``.  The noise
    floor is 1.4826·MAD of the window's out-of-footprint pixels (where at
    least 16 lie out of the footprint), floored at the frame's own
    (``_floor_sample``).  Clusters are batched by size, and within a
    size by their window extent rounded up to 8 px.  Host numpy, the
    reference's statistics (clustertracking_tpu/pipeline.py:1048).
    Returns ({cluster id: rms}, {cluster id: noise})."""
    ndim = len(pos_columns)
    radius = np.asarray(validate_tuple(diameter, ndim), float) / 2.0
    out = {}
    out_noise = {}
    for t, gt in g.groupby(t_column):
        res = (host_frames or {}).get(int(t))
        if res is None:
            res = rreader[int(t)]
            res = (res.cpu().numpy() if isinstance(res, torch.Tensor)
                   else np.asarray(res, dtype=np.float32))
        sub = _floor_sample(res)
        med_t = float(np.median(sub))
        noise_t = 1.4826 * float(np.median(np.abs(sub - med_t)))
        shape = np.asarray(res.shape)
        cid_arr = gt["cluster"].to_numpy()
        order = np.argsort(cid_arr, kind="stable")
        cid_s = cid_arr[order]
        pos_s = gt[pos_columns].to_numpy(dtype=float)[order]
        sig_s = np.abs(gt["signal"].to_numpy(dtype=float))[order]
        bounds = np.nonzero(np.diff(cid_s))[0] + 1
        starts = np.concatenate([[0], bounds, [len(cid_s)]])
        sizes = np.diff(starts)
        for n in np.unique(sizes):
            sel_n = np.nonzero(sizes == n)[0]
            idx_n = starts[sel_n][:, None] + np.arange(n)[None, :]
            pos_n = pos_s[idx_n]                      # [Bn, n, D]
            lo_n = np.floor(pos_n.min(axis=1) - radius).astype(int)
            hi_n = np.ceil(pos_n.max(axis=1) + radius).astype(int) + 1
            # every footprint pixel lies in the cluster's bbox ± radius:
            # one window of the sub-bucket's extent holds it
            q_n = np.minimum(-(-(hi_n - lo_n) // 8) * 8, shape)
            for qrow in np.unique(q_n, axis=0):
                sub = np.nonzero((q_n == qrow).all(axis=1))[0]
                sel = sel_n[sub]
                B = len(sel)
                idx = idx_n[sub]
                pos = pos_n[sub]                      # [B, n, D]
                cids = cid_s[starts[sel]]
                norm = np.maximum(sig_s[idx].max(axis=1), 1e-6)
                lo = lo_n[sub]
                W = tuple(int(min(e, s)) for e, s in zip(qrow, shape))
                o = np.clip(lo, 0, shape - np.asarray(W))  # [B, D]
                ix = []
                for d in range(ndim):
                    ar = o[:, d].reshape((B,) + (1,) * ndim) + np.arange(
                        W[d]).reshape(
                            (1,) * (1 + d) + (-1,) + (1,) * (ndim - 1 - d))
                    ix.append(ar)
                window = res[tuple(np.broadcast_arrays(*ix))]  # [B, *W]
                # d² of each pixel to its nearest member, in radii
                d2 = None
                for j in range(n):
                    d2_j = 0.0
                    for d in range(ndim):
                        gd = ix[d] + 0.0
                        dd = (gd - pos[:, j, d].reshape(
                            (B,) + (1,) * ndim)) / radius[d]
                        d2_j = d2_j + dd * dd
                    d2 = d2_j if d2 is None else np.minimum(d2, d2_j)
                mask = d2 <= 1.0
                red = tuple(range(1, 1 + ndim))
                npx = mask.sum(axis=red)
                ss = np.sum((window.astype(np.float64)) ** 2 * mask,
                            axis=red) / np.maximum(norm, 1e-300) ** 2
                rms = np.where(npx > 0, np.sqrt(ss / np.maximum(npx, 1)),
                               np.inf)
                # median and MAD of the out-of-footprint pixels, by row
                # sorts of +inf-masked values
                inv = ~mask
                n_inv = inv.sum(axis=red)
                B_rows = np.arange(B)
                kk = np.maximum(n_inv, 1)
                lo_i, hi_i = (kk - 1) // 2, kk // 2
                P = int(np.prod(W))
                ws = np.sort(np.where(inv, window, np.inf).reshape(B, P),
                             axis=1)
                med_w = 0.5 * (ws[B_rows, lo_i] + ws[B_rows, hi_i])
                med_w = np.where(n_inv > 0, med_w, 0.0)
                adev = np.where(
                    inv, np.abs(window - np.expand_dims(med_w, red)),
                    np.inf).reshape(B, P)
                asort = np.sort(adev, axis=1)
                mad_w = 0.5 * (asort[B_rows, lo_i] + asort[B_rows, hi_i])
                mad_w = np.where(n_inv > 0, mad_w, 0.0)
                noise_w = np.where(n_inv >= 16, 1.4826 * mad_w, noise_t)
                noise_w = np.maximum(noise_w, noise_t)
                for k in range(B):
                    out[int(cids[k])] = float(rms[k])
                    out_noise[int(cids[k])] = (float(noise_w[k])
                                               / float(norm[k]))
    return out, out_noise


class _TransferReader:
    """``reader[t]`` cast to ``dtype`` on the host and back to float32 on
    ``device``: every stage reads the same quantized frames."""

    def __init__(self, reader, dtype, device):
        self._reader = reader
        self._dtype = np.dtype(dtype)
        self._device = device

    def __len__(self):
        return len(self._reader)

    def _host(self, t):
        fr = self._reader[int(t)]
        if isinstance(fr, torch.Tensor):
            fr = fr.cpu().numpy()
        return np.asarray(fr)

    def check(self, frame_numbers):
        """Raise ``ValueError`` naming the first frame with a value that
        ``dtype`` cannot hold (float16: magnitudes above 65504 turn into
        inf)."""
        info = (np.finfo(self._dtype) if self._dtype.kind == "f"
                else np.iinfo(self._dtype))
        for t in frame_numbers:
            fr = self._host(t)
            if fr.size and (np.nanmax(fr) > info.max
                            or np.nanmin(fr) < info.min):
                raise ValueError(
                    f"track(transfer_dtype={self._dtype.name!r}): frame {t} "
                    f"holds values in [{np.nanmin(fr)}, {np.nanmax(fr)}], "
                    f"outside what {self._dtype.name} holds "
                    f"([{info.min}, {info.max}]); pass transfer_dtype=None "
                    "or rescale the frames")

    def __getitem__(self, t):
        fr = self._host(t).astype(self._dtype)
        return torch.as_tensor(fr, device=self._device).to(torch.float32)


class _ResidualReader:
    """``reader[t] → frame − render(the accepted fits of frame t)``, a
    float32 tensor on ``device``: the residual stream a recovery pass
    re-locates on and measures its footprint reference on.  Each frame is
    rendered once per pass and cached (up to ``_RESIDUAL_CACHE_BYTES``)
    until ``drop_cache()``.  A fitted background is not subtracted."""

    def __init__(self, reader, f_acc, fit_function, t_column, pos_columns,
                 device):
        from .models.registry import get_model

        self._reader = reader
        self._model = get_model(fit_function)
        self._device = device
        self._cache = {}
        self._cache_bytes = 0
        ndim = len(pos_columns)
        aniso_cols = default_size_columns(ndim, False)
        size_cols = (aniso_cols
                     if all(c in f_acc.columns for c in aniso_cols)
                     else default_size_columns(ndim, True))
        self._by_frame = {}
        for t, g in f_acc.groupby(t_column):
            pos = g[pos_columns].to_numpy(dtype=np.float32)
            sig = g["signal"].to_numpy(dtype=np.float32)
            sizes = g[size_cols].to_numpy(dtype=np.float32)
            if sizes.shape[1] == 1:
                sizes = np.repeat(sizes, ndim, axis=1)
            extras = tuple(g[e].to_numpy(dtype=np.float32)
                           for e in self._model.extra_params)
            self._by_frame[int(t)] = (pos, sig, sizes, extras)

    def __len__(self):
        return len(self._reader)

    def __getitem__(self, t):
        from .ops.synth import render_frames

        t = int(t)
        if t in self._cache:
            return self._cache[t]
        frame = torch.as_tensor(self._reader[t], dtype=torch.float32,
                                device=self._device)
        entry = self._by_frame.get(t)
        if entry is None:
            self._store(t, frame)
            return frame
        pos, sig, sizes, extras = entry
        shape = tuple(frame.shape)
        # the window from a robust size scale, the reference's: a rogue
        # wide fit renders truncated rather than widening every window;
        # rounded up to 8 px and capped at the frame
        if sizes.size:
            s_ref = float(min(sizes.max(), 4.0 * max(np.median(sizes), 0.5)))
        else:
            s_ref = 1.0
        window = tuple(
            min(-(-(int(np.ceil(10 * s_ref)) + 1) // 8) * 8, int(d))
            for d in shape)
        rendered = render_frames(
            pos, sig, sizes, np.zeros(len(pos), np.int32), 1, shape,
            fit_function=self._model, window=window, extras=extras,
            device=self._device)[0]
        res = frame - rendered
        self._store(t, res)
        return res

    def _store(self, t, res):
        nbytes = res.numel() * res.element_size()
        if self._cache_bytes + nbytes <= _RESIDUAL_CACHE_BYTES:
            self._cache[t] = res
            self._cache_bytes += nbytes

    def drop_cache(self):
        """Release the cached residual frames."""
        self._cache = {}
        self._cache_bytes = 0


def _track_checkpointed(
    reader, diameter, sep, search_range, memory, n_frames,
    locate_separation, threshold, percentile, max_features,
    find_backend, t_column, checkpoint_dir, checkpoint_every,
    refine_kwargs, locate_kw, recover_kw,
):
    """Chunked track with persisted state (resume-safe).

    Layout of ``checkpoint_dir``: ``state.json`` (next frame, linker
    state, running cluster-id offset) + ``results.pkl`` (accumulated
    linked DataFrame).  Writes are atomic (tmp + rename), so a crash
    mid-chunk resumes from the previous complete chunk.  Recovery passes
    run within each chunk.
    """
    import json
    import os
    from pathlib import Path

    import pandas as pd

    from .link import Linker

    device = locate_kw["device"]
    ckpt = Path(checkpoint_dir)
    ckpt.mkdir(parents=True, exist_ok=True)
    state_file = ckpt / "state.json"
    results_file = ckpt / "results.pkl"

    if state_file.exists():
        state = json.loads(state_file.read_text())
        start = int(state["next_frame"])
        linker = Linker.from_state(state["linker"])
        cluster_offset = int(state["cluster_offset"])
        results = pd.read_pickle(results_file) if results_file.exists() \
            else pd.DataFrame()
    else:
        start = 0
        linker = Linker(search_range, memory)
        cluster_offset = 0
        results = pd.DataFrame()

    pos_columns = default_pos_columns(reader[0].ndim)
    for chunk_start in range(start, n_frames, checkpoint_every):
        chunk = range(
            chunk_start, min(chunk_start + checkpoint_every, n_frames)
        )
        with diagnostics.stage("track.locate", {"frames": len(chunk)}):
            f = _locate_frames(
                reader, chunk, diameter, locate_separation, threshold,
                percentile, max_features, t_column, **locate_kw,
            )
        if len(f):
            with diagnostics.stage("track.find", {"features": len(f)}):
                f = find_clusters(f, sep, t_column=t_column,
                                  backend=find_backend, device=device)
            with diagnostics.stage("track.refine"):
                f, _ = _refine_with_recovery(
                    f, reader, diameter, sep, chunk, locate_separation,
                    threshold, percentile, max_features, find_backend,
                    t_column, pos_columns, refine_kwargs, locate_kw,
                    **recover_kw,
                )
            # cluster ids restart at 0 in every chunk (and the recovery
            # passes renumber them): renumber past the previous chunks'
            _, inv = np.unique(
                f["cluster"].to_numpy(), return_inverse=True
            )
            f["cluster"] = cluster_offset + inv
            cluster_offset = int(f["cluster"].max()) + 1
            f = f[f["cost"].notna()].reset_index(drop=True)
            particle = np.full(len(f), -1, dtype=np.int64)
            with diagnostics.stage("track.link",
                                   {"backend": "host", "features": len(f)}):
                for t, idx in f.groupby(t_column,
                                        sort=True).indices.items():
                    particle[idx] = linker.advance(
                        int(t),
                        f.iloc[idx][pos_columns].to_numpy(dtype=float))
            f["particle"] = particle
            results = pd.concat([results, f], ignore_index=True)

        # atomic persist: results first, then the state pointing at them
        tmp = ckpt / "results.pkl.tmp"
        results.to_pickle(tmp)
        os.replace(tmp, results_file)
        tmp = ckpt / "state.json.tmp"
        tmp.write_text(json.dumps({
            "next_frame": int(chunk.stop),
            "linker": linker.state(),
            "cluster_offset": cluster_offset,
        }))
        os.replace(tmp, state_file)

    return results
