"""Parameter packing: fitting-mode semantics as static index maps.

PyTorch counterpart of ``clustertracking_tpu/models/packing.py``: the
layout (``build_layout``, ``ParamLayout``) stays host numpy, and only
``vect_from_params`` / ``vect_to_params`` act on torch tensors.  The
per-parameter *mode* contract:

- ``'const'``  — parameter is not fitted (stays at its input value)
- ``'var'``    — one optimizer slot per feature
- ``'cluster'``— one slot shared by all features in a cluster
- ``'global'`` — one slot shared across the *entire* fit

The reference implements these with per-call python loops over "groups"
(feature→cluster maps).  Here every cluster is one lane of a fixed-size
bucket (SURVEY.md §7 "bucketed cluster batch"), so the layout is static per
bucket: we precompute

- ``slot_idx[n, P]``  — vector slot for each (feature, param), −1 for const
- ``pack_mat[V, n*P]``— dense pack matrix (mean-reduces shared slots), so
  ``vect = params_flat @ pack_mat.T`` is one small matmul under jit
- ``global_slots[V]`` — bool mask of 'global'-mode slots, used by the
  train-time solver to tie slots across the cluster batch (the reference's
  cross-cluster groups in train_leastsq).

At the per-cluster level 'global' packs identically to 'cluster'; the
difference only materializes when a solver ties global slots across lanes
(see ops/lm.py::lm_solve_global).  This reproduces the reference semantics:
in refine_leastsq each cluster is fit separately, so a 'global' parameter
degenerates to cluster-shared there too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from ..utils import default_pos_columns, default_size_columns
from .registry import ModelSpec

__all__ = ["MODE_CODES", "ParamLayout", "build_layout", "param_names_for"]

MODE_CODES = {"const": 0, "var": 1, "cluster": 2, "global": 3}
_BACKGROUND_ALLOWED = {"const", "cluster", "global"}


def param_names_for(model: ModelSpec, ndim: int, isotropic: bool) -> list:
    """Canonical per-feature parameter order for a model.

    ``['background', 'signal', <pos cols>, <size cols>, <model extras>]`` —
    matching the reference's FitFunctions.params ordering convention.
    """
    return (
        ["background", "signal"]
        + default_pos_columns(ndim)
        + default_size_columns(ndim, isotropic)
        + list(model.extra_params)
    )


def default_param_mode(model: ModelSpec, ndim: int, isotropic: bool) -> dict:
    """Reference-default modes: positions & signal fitted per feature,
    size and background held constant; model extras use the model's
    declared defaults (e.g. inv_series coefficients are 'global')."""
    names = param_names_for(model, ndim, isotropic)
    mode = {n: "const" for n in names}
    mode["signal"] = "var"
    for c in default_pos_columns(ndim):
        mode[c] = "var"
    for extra in model.extra_params:
        mode[extra] = model.default_mode.get(extra, "const")
    return mode


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Static packing layout for one bucket (fixed cluster size ``n``).

    All fields are host numpy / hashable; solvers close over them.
    """

    n_features: int
    ndim: int
    isotropic: bool
    param_names: tuple            # length P
    modes: tuple                  # length P, str
    slot_idx: np.ndarray          # [n, P] int32, −1 = const
    n_slots: int                  # V
    global_slots: np.ndarray      # [V] bool
    pos_param_idx: tuple          # indices into param axis for positions
    size_param_idx: tuple         # indices for sizes
    signal_param_idx: int
    background_param_idx: int

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    # ------------------------------------------------------------------
    def pack_matrix(self) -> np.ndarray:
        """Dense [V, n*P] matrix: vect = params.reshape(-1) @ M.T.

        Shared (cluster/global) slots average their contributors, matching
        the reference's vect_from_params(operation=np.mean)."""
        n, P, V = self.n_features, self.n_params, self.n_slots
        M = np.zeros((V, n * P), dtype=np.float32)
        counts = np.zeros(V, dtype=np.float32)
        for i in range(n):
            for p in range(P):
                s = self.slot_idx[i, p]
                if s >= 0:
                    M[s, i * P + p] += 1.0
                    counts[s] += 1.0
        M /= np.maximum(counts, 1.0)[:, None]
        return M

    def vect_from_params(self, params):
        """params[..., n, P] → vect[..., V] (mean over shared slots).

        Static slice-and-stack (one slice per contributor): exact means,
        summed in the same order as the reference."""
        contributors: list = [[] for _ in range(self.n_slots)]
        for i in range(self.n_features):
            for p in range(self.n_params):
                s = self.slot_idx[i, p]
                if s >= 0:
                    contributors[s].append((i, p))
        cols = []
        for slots in contributors:
            acc = params[..., slots[0][0], slots[0][1]]
            for i, p in slots[1:]:
                acc = acc + params[..., i, p]
            cols.append(acc / len(slots) if len(slots) > 1 else acc)
        return torch.stack(cols, dim=-1)

    @functools.cached_property
    def _unpack_on(self) -> dict:
        return {}

    def unpack_index(self, device):
        """(slot of each (feature, param) [n·P] long, const mask [n, P]
        bool) on ``device``, built once a device: a bucket's solve copies
        no index to the device."""
        device = torch.device(device)
        if device not in self._unpack_on:
            self._unpack_on[device] = (
                torch.as_tensor(np.maximum(self.slot_idx, 0).reshape(-1),
                                dtype=torch.long, device=device),
                torch.as_tensor(self.slot_idx < 0, device=device))
        return self._unpack_on[device]

    def vect_to_params(self, vect, const_params):
        """vect[..., V] + const values → params[..., n, P].

        Const (slot −1) entries come from ``const_params``; fitted entries
        are gathered (broadcast for shared slots)."""
        idx, is_const = self.unpack_index(vect.device)
        gathered = vect[..., idx].reshape(
            *vect.shape[:-1], *self.slot_idx.shape
        )
        return torch.where(is_const, const_params, gathered)


def build_layout(
    model: ModelSpec,
    ndim: int,
    isotropic: bool,
    n_features: int,
    param_mode: Mapping | None = None,
) -> ParamLayout:
    """Build the static packing layout for one bucket.

    ``param_mode`` overrides the defaults per parameter name, exactly like
    the reference's ``param_mode`` kwarg to refine_leastsq.
    """
    names = param_names_for(model, ndim, isotropic)
    modes = default_param_mode(model, ndim, isotropic)
    if param_mode:
        for k, v in param_mode.items():
            if k not in modes:
                raise ValueError(
                    f"param_mode key {k!r} not a parameter of this model "
                    f"(have {names})"
                )
            if v not in MODE_CODES:
                raise ValueError(f"Unknown mode {v!r} for {k!r}")
            modes[k] = v
    if modes["background"] not in _BACKGROUND_ALLOWED:
        raise ValueError(
            "background mode must be one of 'const'/'cluster'/'global' "
            "(a per-feature background is degenerate)"
        )

    n, P = n_features, len(names)
    slot_idx = np.full((n, P), -1, dtype=np.int32)
    global_flags = []
    v = 0
    for p, name in enumerate(names):
        mode = modes[name]
        if mode == "const":
            continue
        if mode == "var":
            for i in range(n):
                slot_idx[i, p] = v
                global_flags.append(False)
                v += 1
        else:  # cluster / global: one shared slot
            slot_idx[:, p] = v
            global_flags.append(mode == "global")
            v += 1

    pos_cols = default_pos_columns(ndim)
    size_cols = default_size_columns(ndim, isotropic)
    return ParamLayout(
        n_features=n,
        ndim=ndim,
        isotropic=isotropic,
        param_names=tuple(names),
        modes=tuple(modes[name] for name in names),
        slot_idx=slot_idx,
        n_slots=v,
        global_slots=np.array(global_flags, dtype=bool),
        pos_param_idx=tuple(names.index(c) for c in pos_cols),
        size_param_idx=tuple(names.index(c) for c in size_cols),
        signal_param_idx=names.index("signal"),
        background_param_idx=names.index("background"),
    )
