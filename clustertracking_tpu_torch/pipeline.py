"""End-to-end video tracking: locate → find → refine → link.

Counterpart of ``clustertracking_tpu/pipeline.py``.  ``locate`` and
``_locate_frames`` find integer-pixel local maxima above a noise-robust
threshold, with a per-candidate size estimate, to seed ``find_clusters``
and ``refine_leastsq``: frames are stacked ``stack_chunk`` at a time onto
the device, where the filters, the threshold statistics, the maxima and
the sizes are computed (``ops/locate.py``); the per-frame size band and
the DataFrame are built on the host.  ``track`` composes locate,
``find_clusters``, ``refine_leastsq`` and ``link`` over a video, in one
shot or in checkpointed chunks, every stage on one device.  The
reference's recovery passes and reduced-precision frame transfer are not
ported (ROADMAP queue 1 item 11); frames are read from the reader by
locate and again by refine.
"""
from __future__ import annotations

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
from .refine import _resolve_device, _stack_frames, refine_leastsq
from .utils import default_pos_columns, default_size_columns, validate_tuple

if TYPE_CHECKING:
    import pandas as pd

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
    subsample.  ``preprocess='bandpass'`` smooths at ``noise_size`` px and
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
    """[T, *S] -> [T, N/4^D] flattened: the 4×-strided statistics sample
    (an exact median sorts every pixel; ~16k samples of a 512² frame
    estimate the floors to ~1% of sigma)."""
    ix = (slice(None),) + (slice(None, None, 4),) * (x.dim() - 1)
    return x[ix].reshape(T, -1)


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
    transfer_dtype=None,
    mesh=None,
    device=None,
    **refine_kwargs,
) -> "pd.DataFrame":
    """Full pipeline over a video reader: returns refined, linked features.

    Stages: ``_locate_frames`` (candidates), ``find_clusters``
    (``find_backend``), ``refine_leastsq`` (``refine_kwargs``; clusters
    over ``max_cluster_size`` spill to the host scipy fit) and ``link``
    (``link_backend``, None meaning 'auto' here).  Under
    ``diagnostics.collect()`` the loss ledger counts each stage's
    features and keeps the stage walls (``locate_s``, ``find_s``,
    ``fit_s``, ``link_s``) and the resolved ``link_backend``.

    ``reader[t]`` must yield frames (numpy arrays or tensors).
    ``locate_separation`` defaults to half the separation per axis (at
    least 2 px), ``search_range`` to the mean diameter;
    ``preprocess='bandpass'`` makes the background a fitted per-cluster
    parameter unless ``param_mode`` names it.

    ``checkpoint_dir``: process the video in ``checkpoint_every``-frame
    chunks, persisting the accumulated results (``results.pkl``) and the
    host ``Linker``'s state (``state.json``) after each chunk, atomically;
    the same call resumes after the last complete chunk, and the result
    equals a single-shot run with ``link_backend='host'`` (the device
    linkers have no serializable incremental form, so another
    ``link_backend`` raises ``ValueError``).  The layout is the
    reference's, so a checkpoint it wrote resumes here.

    ``device``: every stage runs there; None is 'cuda', and raises
    ``RuntimeError`` where no CUDA device exists; pass ``device='cpu'`` to
    run on the host.  Not ported, and refused with
    ``NotImplementedError``: ``recover_passes > 0`` and
    ``transfer_dtype`` (ROADMAP queue 1 item 11; the reference's
    ``recover_*`` gate arguments come with the passes), ``mesh=``
    (item 13).
    """
    if recover_passes:
        raise NotImplementedError(
            "track(recover_passes > 0) (residual re-locate recovery passes) "
            "is not ported yet (ROADMAP queue 1 item 11)"
        )
    if transfer_dtype is not None:
        raise NotImplementedError(
            "track(transfer_dtype=...) is not ported yet (ROADMAP queue 1 "
            "item 11)"
        )
    if mesh is not None:
        raise NotImplementedError(
            "track(mesh=...) (multi-device tracking) is not ported yet "
            "(ROADMAP queue 1 item 13)"
        )
    device = _resolve_device(device, "track")
    if n_frames is None:
        n_frames = len(reader)
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
            refine_kwargs, locate_kw,
        )
    t0 = time.perf_counter()
    f = _locate_frames(
        reader, range(n_frames), diameter, locate_separation, threshold,
        percentile, max_features, t_column, **locate_kw,
    )
    t1 = time.perf_counter()
    f = find_clusters(f, sep, t_column=t_column, backend=find_backend,
                      device=device)
    t2 = time.perf_counter()
    max_cluster = int(refine_kwargs.get("max_cluster_size", 8))
    n_spill = int((f["cluster_size"] > max_cluster).sum())
    f = refine_leastsq(f, reader, diameter, sep, t_column=t_column,
                       device=device, **refine_kwargs)
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
    out = _link(
        f, search_range, memory=memory, t_column=t_column,
        backend=link_backend if link_backend is not None else "auto",
        device=device,
    )
    diagnostics.record_ledger(
        linked=len(out),
        locate_s=round(t1 - t0, 4),
        find_s=round(t2 - t1, 4),
        fit_s=round(t3 - t2, 4),
        link_s=round(time.perf_counter() - t4, 4),
        link_backend=out.attrs.get("link_backend", "?"),
    )
    return out


def _track_checkpointed(
    reader, diameter, sep, search_range, memory, n_frames,
    locate_separation, threshold, percentile, max_features,
    find_backend, t_column, checkpoint_dir, checkpoint_every,
    refine_kwargs, locate_kw,
):
    """Chunked track with persisted state (resume-safe).

    Layout of ``checkpoint_dir``: ``state.json`` (next frame, linker
    state, running cluster-id offset) + ``results.pkl`` (accumulated
    linked DataFrame).  Writes are atomic (tmp + rename), so a crash
    mid-chunk resumes from the previous complete chunk.
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
        f = _locate_frames(
            reader, chunk, diameter, locate_separation, threshold,
            percentile, max_features, t_column, **locate_kw,
        )
        if len(f):
            f = find_clusters(f, sep, t_column=t_column,
                              backend=find_backend, device=device)
            f = refine_leastsq(f, reader, diameter, sep, t_column=t_column,
                               device=device, **refine_kwargs)
            # cluster ids restart at 0 in every chunk: renumber them past
            # the previous chunks'
            _, inv = np.unique(
                f["cluster"].to_numpy(), return_inverse=True
            )
            f["cluster"] = cluster_offset + inv
            cluster_offset = int(f["cluster"].max()) + 1
            f = f[f["cost"].notna()].reset_index(drop=True)
            particle = np.full(len(f), -1, dtype=np.int64)
            for t, idx in f.groupby(t_column, sort=True).indices.items():
                particle[idx] = linker.advance(
                    int(t), f.iloc[idx][pos_columns].to_numpy(dtype=float)
                )
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
