"""LM solve of one bucket of large clusters (20 slots or more): the CUDA
kernel and its plain version.

Counterpart of the reference's XLA route for the unconstrained buckets its
Pallas kernels do not take: ``clustertracking_tpu/refine.py:553-558`` calls
``ops/lm.py::lm_solve`` with the closures of
``ops/residual.py::make_model_fns``.  Config 5's chains (2D isotropic
Gaussians, 3 slots a feature, up to 40 features) are such buckets.  Here:

- ``block_lm`` is the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/block_lm.cu`` (built for sm_90a on first
  use; one thread block per cluster, every built-in profile, 2D and 3D
  windows) and counts the launch in ``block_lm.launches``; on CPU tensors
  it returns the plain version's result.  It raises on anything the
  kernel does not take, and never swaps in the plain version for a CUDA
  tensor.
- ``block_lm_reference`` is the plain PyTorch version: the ``lm_solve``
  call of the bucket solver's plain route, ``ops/lm.py::lm_solve`` on the
  model of ``ops/residual.py``.

Both take::

    vect0 [B, V] f32, const_params [B, n, P] f32, pixels [B, Npix] f32
    (``window_gather``), mask [B, Npix] f32, origin [B, D] i32, norm [B]
    f32, valid [B] bool, fvalid [B, n] f32 or None, bounds
    (``ops/pixel_lm.py::SlotBounds``)

and return ``LMResult(x, cost, n_iter, converged, npix)``.  The mask is
``ops/gather.py::radius_mask``'s (``/ r``), computed with torch before the
launch, as the plain route computes it; npix is its sum per lane.  Lanes
with ``valid`` False are not solved: x is the clipped ``vect0``, cost the
cost there, n_iter 0 and converged False, as ``lm_solve`` leaves them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.packing import param_names_for
from .lm import LMResult, lm_solve
from .pixel_lm import _staged_extras, profile_tag
from .residual import make_model_fns
from .window_gather import check_tensor

__all__ = ["BLOCK_MAX_FEATURES", "BLOCK_MAX_SLOTS", "block_lm",
           "block_lm_clocks", "block_lm_reference", "blocks_per_sm",
           "check_block_lm_args", "smem_words"]

# Caps of csrc/block_lm.cu (kBlockMaxSlots, kBlockMaxFeatures): at V = 128
# and n = 64 one block's shared memory (the FP64 tile sums, a 128-row z
# tile and the items of two sweeps) still fits the 227 KB a block can have.
BLOCK_MAX_SLOTS = 128
BLOCK_MAX_FEATURES = 64
_WARPS = 8              # kWarps: 256 threads a block
_PANEL = 4              # kPanel: 8-column blocks of zᵀz a panel
_MISC_WORDS = 4 + _WARPS


def smem_words(D, prof, V, n):
    """Shared memory of one block of ``csrc/block_lm.cu``, in 4-byte words
    (``block_lm_smem_words``): the FP64 sums of each pixel slice's 8×8
    tiles, eight clocks, the FP64 reciprocals of the feature sizes, the
    column-major z tile of R pixel rows (which
    holds the factor during the solve), the two sweeps' items, four slot
    vectors, the list of the columns a pixel row zeroes, the feature
    parameters and slots."""
    K = V + 1
    nb = -(-K // 8)
    kpad = 8 * nb
    panels = -(-nb // _PANEL)
    jobs = panels * panels
    slices = 1 if jobs >= _WARPS else _WARPS // jobs
    rows = 256 if kpad <= 32 else 192 if kpad <= 72 else 128
    tiles = nb * (nb + 1) // 2
    items = K * (K + 1) // 2
    nx = _staged_extras(prof)
    feat_f, feat_i = 2 + 2 * D + nx, 2 + 2 * D + nx
    return (slices * tiles * 128 + 16 + 2 * D * n
            + max(kpad * (rows + 4), K * (K | 1))
            + 2 * items + 5 * kpad + n * (feat_f + feat_i) + _MISC_WORDS)


def block_lm_reference(vect0, const_params, pixels, mask, origin, norm,
                       valid, fvalid=None, *, model, layout, window_shape,
                       bounds, max_iter=60, ftol=1.49e-8, xtol=1.49e-8,
                       lam0=1e-3, lam_up=4.0, lam_down=0.25, lam_max=1e10):
    """Plain PyTorch version of ``block_lm``: ``lm_solve`` on
    ``make_model_fns``'s closures, as the bucket solver's plain route
    calls it.  Works for any model, layout and window rank, on any
    device."""
    fns = make_model_fns(model, layout, tuple(window_shape),
                         device=pixels.device)
    extra = () if fvalid is None else (fvalid,)
    res = lm_solve(
        fns.residual, fns.residual_jac, vect0,
        (const_params, pixels, mask, origin, norm) + extra,
        max_iter=max_iter, ftol=ftol, xtol=xtol, lam0=lam0, lam_up=lam_up,
        lam_down=lam_down, lam_max=lam_max, lower=bounds.lo,
        upper=bounds.hi, valid=valid,
    )
    return res._replace(npix=mask.sum(dim=1))


def check_block_lm_args(vect0, const_params, pixels, mask, origin, norm,
                        valid, fvalid, *, model, layout, window_shape,
                        bounds):
    """Raise on anything ``csrc/block_lm.cu`` does not take: a model with no
    kernel profile (``NotImplementedError``: a custom model is a Python
    callable), a window rank other than 2 or 3, a parameter layout, slot
    or feature count outside the kernel's, bounds built for another
    configuration or device, and tensors of the wrong dtype, shape, device
    or layout."""
    who = "block_lm"
    prof = profile_tag(model)
    if prof is None:
        raise NotImplementedError(
            f"{who}: model {model.name!r} is not a built-in profile; no CUDA "
            "kernel evaluates a custom model (kernel_route takes lm_solve)"
        )
    D = len(window_shape)
    if D not in (2, 3) or layout.ndim != D:
        raise ValueError(f"{who}: a {layout.ndim}D layout on window "
                         f"{tuple(window_shape)}")
    limits = (32767, 65535) if D == 2 else (2047, 1023, 1023)
    if any(w > lim for w, lim in zip(window_shape, limits)):
        raise ValueError(f"{who}: window {tuple(window_shape)} past the "
                         f"kernel's packed pixel offsets {limits}")
    if tuple(layout.param_names) != tuple(
            param_names_for(model, D, layout.isotropic)):
        raise ValueError(f"{who}: unexpected parameter layout")
    B, V = vect0.shape
    n, P = layout.n_features, layout.n_params
    if V != layout.n_slots:
        raise ValueError(f"{who}: vect0 has {V} columns, the layout "
                         f"{layout.n_slots}")
    if not 0 < V <= BLOCK_MAX_SLOTS:
        raise ValueError(f"{who}: {V} slots outside the kernel's "
                         f"1..{BLOCK_MAX_SLOTS}")
    if n > BLOCK_MAX_FEATURES:
        raise ValueError(f"{who}: n={n} features > {BLOCK_MAX_FEATURES}")
    device = vect0.device
    f32 = torch.float32
    npix = int(np.prod(window_shape))
    check_tensor(who, "vect0", vect0, f32, (B, V), device)
    check_tensor(who, "const_params", const_params, f32, (B, n, P), device)
    check_tensor(who, "pixels", pixels, f32, (B, npix), device)
    check_tensor(who, "mask", mask, f32, (B, npix), device)
    check_tensor(who, "origin", origin, torch.int32, (B, D), device)
    check_tensor(who, "norm", norm, f32, (B,), device)
    check_tensor(who, "valid", valid, torch.bool, (B,), device)
    check_tensor(who, "fvalid", fvalid, f32, (B, n), device)
    bounds.check(who, layout, None, V, device)


_ARGTYPES = (
    [ctypes.c_void_p] * 12          # pixels .. scratch
    + [ctypes.c_int] * 9            # B, n, P, V, iso, D, wz, wy, wx
    + [ctypes.c_int]                # max_iter
    + [ctypes.c_float] * 7          # ftol .. plateau
    + [ctypes.c_int] * 2            # prof, nx
    + [ctypes.c_void_p] * 4         # outputs
    + [ctypes.c_void_p]             # clocks (or null)
    + [ctypes.c_void_p]             # stream
)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("block_lm")
    if lib.block_lm_launch.argtypes is None:
        lib.block_lm_launch.argtypes = _ARGTYPES
        lib.block_lm_launch.restype = ctypes.c_int
        lib.block_lm_smem_words.argtypes = [ctypes.c_int] * 4
        lib.block_lm_smem_words.restype = ctypes.c_int
        lib.block_lm_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.block_lm_blocks_per_sm.restype = ctypes.c_int
        for D in (2, 3):
            for prof in range(5):
                for V, n in ((20, 4), (61, 20), (128, 64)):
                    if lib.block_lm_smem_words(D, prof, V, n) != \
                            smem_words(D, prof, V, n):
                        raise RuntimeError("block_lm: smem_words disagrees "
                                           "with csrc/block_lm.cu")
    return lib


def block_lm(vect0, const_params, pixels, mask, origin, norm, valid,
             fvalid=None, *, model, layout, window_shape, bounds,
             max_iter=60, ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3,
             lam_up=4.0, lam_down=0.25, lam_max=1e10):
    """LM solve of one bucket, one thread block per cluster (see the module
    docstring).

    CUDA tensors launch ``csrc/block_lm.cu`` with the model's profile; CPU
    tensors get ``block_lm_reference``.  Raises ``ValueError`` on any
    other device and on arguments the kernel does not take,
    ``NotImplementedError`` on CUDA for a custom model, and
    ``RuntimeError`` when the kernel does not build or launch."""
    kw = dict(model=model, layout=layout, window_shape=window_shape,
              bounds=bounds, max_iter=max_iter, ftol=ftol, xtol=xtol,
              lam0=lam0, lam_up=lam_up, lam_down=lam_down, lam_max=lam_max)
    if pixels.device.type == "cpu":
        return block_lm_reference(vect0, const_params, pixels, mask, origin,
                                  norm, valid, fvalid, **kw)
    return _launch(vect0, const_params, pixels, mask, origin, norm, valid,
                   fvalid, None, **kw)


def block_lm_clocks(vect0, const_params, pixels, mask, origin, norm, valid,
                    fvalid=None, **kw):
    """``block_lm`` on CUDA tensors that also returns each block's SM clock
    cycles ``[B, 6]`` int64, as its thread 0 sees them: in all, in its
    sweeps, in its damped Cholesky solves (what is left is the compaction
    and the LM rules), and of the sweeps' cycles those building the pixel
    rows, summing zᵀz and rounding the sums.  For measurement; the solve
    is the same."""
    B = vect0.shape[0]
    clocks = torch.zeros((B, 6), dtype=torch.int64, device=pixels.device)
    res = _launch(vect0, const_params, pixels, mask, origin, norm, valid,
                  fvalid, clocks, **kw)
    return res, clocks


def blocks_per_sm(D, prof, V, n):
    """Blocks of ``csrc/block_lm.cu`` an SM holds at once for V slots and n
    features, by the CUDA runtime (its registers and shared memory)."""
    return int(_library().block_lm_blocks_per_sm(D, prof, V, n))


def _launch(vect0, const_params, pixels, mask, origin, norm, valid, fvalid,
            clocks, *, model, layout, window_shape, bounds, max_iter=60,
            ftol=1.49e-8, xtol=1.49e-8, lam0=1e-3, lam_up=4.0,
            lam_down=0.25, lam_max=1e10):
    """Check the arguments and launch the kernel (counted in
    ``block_lm.launches``)."""
    device = pixels.device
    if device.type != "cuda":
        raise ValueError(f"block_lm: unsupported device {device}")
    B = vect0.shape[0]
    n, P = layout.n_features, layout.n_params
    vect0 = vect0.contiguous()
    if fvalid is None:
        fvalid = torch.ones((B, n), dtype=torch.float32, device=device)
    check_block_lm_args(vect0, const_params, pixels, mask, origin, norm,
                        valid, fvalid, model=model, layout=layout,
                        window_shape=window_shape, bounds=bounds)
    D = len(window_shape)
    wz, wy, wx = (1,) + tuple(window_shape) if D == 2 else window_shape
    V = layout.n_slots
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    valid_i = valid.to(i32)
    # each in-mask pixel's (value, mask / norm, that / n, index)
    scratch = torch.empty((B, wz * wy * wx, 4), dtype=f32, device=device)
    x_out = torch.empty((B, V), dtype=f32, device=device)
    cost = torch.empty((B,), dtype=f32, device=device)
    n_iter = torch.empty((B,), dtype=i32, device=device)
    conv = torch.empty((B,), dtype=i32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.block_lm_launch(
            pixels.data_ptr(), mask.data_ptr(), origin.data_ptr(),
            vect0.data_ptr(), const_params.data_ptr(), norm.data_ptr(),
            valid_i.data_ptr(), fvalid.data_ptr(),
            bounds.kernel.slot_idx.data_ptr(), bounds.lo.data_ptr(),
            bounds.hi.data_ptr(), scratch.data_ptr(),
            B, n, P, V, int(layout.isotropic), D, wz, wy, wx, int(max_iter),
            float(ftol), float(xtol), float(lam0), float(lam_up),
            float(lam_down), float(lam_max), float(1e6 * lam0),
            profile_tag(model), len(model.extra_params),
            x_out.data_ptr(), cost.data_ptr(), n_iter.data_ptr(),
            conv.data_ptr(), None if clocks is None else clocks.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"block_lm: kernel launch failed, cudaError {rc}")
    block_lm.launches += 1
    return LMResult(x=x_out, cost=cost, n_iter=n_iter,
                    converged=conv.to(torch.bool), npix=mask.sum(dim=1))


block_lm.launches = 0
