"""Model-function registry: radial profiles for cluster fitting.

PyTorch counterpart of ``clustertracking_tpu/models/registry.py``.  A model
is a scalar torch function of the size-normalized squared radius ``r2``
plus optional extra parameters; every built-in is an elementwise tensor
function.  Derivatives that a model does not give in closed form come from
``torch.func.grad`` of the scalar profile (the reference uses ``jax.grad``),
vectorized over tensors with ``torch.func.vmap``.

Image model (the API contract)::

    I(x) = background + sum_i  signal_i * fun(r2_i, *extras)
    r2_i = sum_d ((x_d - pos_{i,d}) / size_{i,d})**2

``size`` is the Gaussian sigma; ``signal`` the peak amplitude
(``fun(0) == 1`` for every built-in except ``ring``, which peaks at
``r2 == 1``).

Built-in models: ``'gauss'``, ``'ring'`` (thickness ``t``), ``'hat'``
(``disc_size``), ``'disc'`` and ``'inv_series_<n>'``.  Custom models are
dicts ``{'params': [...], 'fun': f, 'dfun': None, 'default': {...},
'continuous': bool}``; ``fun`` must be a torch function.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping

import torch

__all__ = ["ModelSpec", "get_model", "register_model", "MODELS",
           "elementwise"]


def elementwise(scalar_fn: Callable) -> Callable:
    """Lift a scalar torch function of ``(r2, *extras)`` to broadcast
    tensors (the counterpart of ``jnp.vectorize``)."""

    def fn(r2, *extras):
        args = torch.broadcast_tensors(
            r2, *[torch.as_tensor(e, dtype=r2.dtype, device=r2.device)
                  for e in extras]
        )
        flat = [a.reshape(-1) for a in args]
        return torch.func.vmap(scalar_fn)(*flat).reshape(args[0].shape)

    return fn


@dataclasses.dataclass(frozen=True, eq=False)
class ModelSpec:
    # eq=False keeps identity hashing: instances carry dict/callable fields
    # and are interned in MODELS, so identity is the cache key of the
    # lru_cached bucket solvers in refine.py.
    """A radial model profile.

    Attributes:
      name: registry key.
      extra_params: names of extra scalar parameters beyond the standard
        (background, signal, pos..., size...) set, in call order.
      fun: ``fun(r2, *extras) -> intensity`` (elementwise torch function).
      default: default values for extra params.
      continuous: kept for API parity with the reference.
      default_mode: per-extra-param default fitting mode.
      dfun: optional analytic d fun / d r2 (elementwise).
      dfun_f: optional ``dfun_f(f, r2, *extras)`` — d fun / d r2 through
        the already-computed forward value ``f`` (one exp, not two).
    """

    name: str
    extra_params: tuple
    fun: Callable
    default: Mapping
    continuous: bool = True
    default_mode: Mapping = dataclasses.field(default_factory=dict)
    dfun: Callable = None
    dfun_f: Callable = None

    def dfun_dr2(self) -> Callable:
        """d fun / d r2 as a scalar torch function."""
        if self.dfun is not None:
            return self.dfun
        return torch.func.grad(lambda r2, *e: self.fun(r2, *e), argnums=0)

    def dfun_dextra(self, k: int) -> Callable:
        """d fun / d extras[k] as a scalar torch function."""
        return torch.func.grad(
            lambda r2, *e: self.fun(r2, *e), argnums=1 + k
        )


def _gauss(r2):
    return torch.exp(-0.5 * r2)


def _ring(r2, thickness):
    r = torch.sqrt(r2 + 1e-12)
    return torch.exp(-0.5 * ((r - 1.0) / thickness) ** 2)


def _hat(r2, disc_size):
    r = torch.sqrt(r2 + 1e-12)
    edge = torch.clamp(r - disc_size, min=0.0)
    sigma = torch.clamp(torch.as_tensor(1.0 - disc_size), min=1e-3)
    return torch.exp(-0.5 * (edge / sigma) ** 2)


def _disc(r2):
    # Smooth-edged disc: ~1 inside r=1, sigmoid falloff with 10% edge width.
    r = torch.sqrt(r2 + 1e-12)
    return torch.sigmoid((1.0 - r) / 0.1)


def _make_inv_series(n: int) -> ModelSpec:
    names = tuple(f"coeff_{k}" for k in range(1, n + 1))

    def fun(r2, *coeffs):
        acc = torch.ones_like(r2)
        p = r2
        for c in coeffs:
            acc = acc + c * p
            p = p * r2
        return 1.0 / acc

    def dfun(r2, *coeffs):
        # d/dr2 (1/A) = -A'/A²,  A' = Σ_k c_k · k · r2^(k-1)
        acc = torch.ones_like(r2)
        dacc = torch.zeros_like(r2)
        p = r2
        dp = torch.ones_like(r2)
        for k, c in enumerate(coeffs, start=1):
            acc = acc + c * p
            dacc = dacc + c * k * dp
            dp = p
            p = p * r2
        return -dacc / (acc * acc)

    def dfun_f(f, r2, *coeffs):
        # -A'/A² = -A'·f² with f = 1/A already computed
        dacc = torch.zeros_like(r2)
        dp = torch.ones_like(r2)
        p = r2
        for k, c in enumerate(coeffs, start=1):
            dacc = dacc + c * k * dp
            dp = p
            p = p * r2
        return -dacc * f * f

    # Default coefficients: the Taylor series of exp(r2/2), so the
    # untrained model approximates a Gaussian.
    fact = 1.0
    defaults = {}
    for k in range(1, n + 1):
        fact *= k
        defaults[f"coeff_{k}"] = 0.5 ** k / fact
    return ModelSpec(
        name=f"inv_series_{n}",
        extra_params=names,
        fun=fun,
        default=defaults,
        continuous=True,
        default_mode={name: "global" for name in names},
        dfun=dfun,
        dfun_f=dfun_f,
    )


def _dgauss(r2):
    return -0.5 * torch.exp(-0.5 * r2)


def _dgauss_f(f, r2):
    return -0.5 * f


def _dring_f(f, r2, thickness):
    r = torch.sqrt(r2 + 1e-12)
    return f * (1.0 - r) / (thickness * thickness) * 0.5 / r


def _dhat_f(f, r2, disc_size):
    r = torch.sqrt(r2 + 1e-12)
    edge = torch.clamp(r - disc_size, min=0.0)
    sigma = torch.clamp(torch.as_tensor(1.0 - disc_size), min=1e-3)
    return f * (-edge) / (sigma * sigma) * 0.5 / r


def _ddisc_f(f, r2):
    r = torch.sqrt(r2 + 1e-12)
    return f * (1.0 - f) * (-10.0) * 0.5 / r


def _dring(r2, thickness):
    # d/dr2 exp(-(r-1)²/(2t²)) = f · (1-r)/t² · dr/dr2,  dr/dr2 = 1/(2r)
    r = torch.sqrt(r2 + 1e-12)
    f = torch.exp(-0.5 * ((r - 1.0) / thickness) ** 2)
    return f * (1.0 - r) / (thickness * thickness) * 0.5 / r


def _dhat(r2, disc_size):
    r = torch.sqrt(r2 + 1e-12)
    edge = torch.clamp(r - disc_size, min=0.0)
    sigma = torch.clamp(torch.as_tensor(1.0 - disc_size), min=1e-3)
    f = torch.exp(-0.5 * (edge / sigma) ** 2)
    return f * (-edge) / (sigma * sigma) * 0.5 / r


def _ddisc(r2):
    r = torch.sqrt(r2 + 1e-12)
    s = torch.sigmoid((1.0 - r) / 0.1)
    return s * (1.0 - s) * (-10.0) * 0.5 / r


MODELS: dict = {
    "gauss": ModelSpec("gauss", (), _gauss, {}, dfun=_dgauss,
                       dfun_f=_dgauss_f),
    "ring": ModelSpec(
        "ring", ("thickness",), _ring, {"thickness": 0.2},
        default_mode={"thickness": "cluster"}, dfun=_dring,
        dfun_f=_dring_f,
    ),
    "hat": ModelSpec(
        "hat", ("disc_size",), _hat, {"disc_size": 0.5},
        default_mode={"disc_size": "cluster"}, dfun=_dhat,
        dfun_f=_dhat_f,
    ),
    "disc": ModelSpec("disc", (), _disc, {}, continuous=False, dfun=_ddisc,
                      dfun_f=_ddisc_f),
}

_INV_SERIES_RE = re.compile(r"^inv_series_(\d+)$")


def register_model(spec: ModelSpec) -> None:
    MODELS[spec.name] = spec


def get_model(fit_function) -> ModelSpec:
    """Resolve a model name / dict / ModelSpec into a ModelSpec.

    Accepts a registry name (``'gauss'``, ``'ring'``, ``'hat'``,
    ``'disc'``, ``'inv_series_<n>'``), a custom dict, or a ModelSpec.
    """
    if isinstance(fit_function, ModelSpec):
        return fit_function
    if isinstance(fit_function, str):
        if fit_function in MODELS:
            return MODELS[fit_function]
        m = _INV_SERIES_RE.match(fit_function)
        if m:
            spec = _make_inv_series(int(m.group(1)))
            MODELS[spec.name] = spec
            return spec
        raise ValueError(
            f"Unknown fit_function {fit_function!r}; known: "
            f"{sorted(MODELS)} + 'inv_series_<n>'"
        )
    if isinstance(fit_function, Mapping):
        params = tuple(fit_function.get("params", ()))
        return ModelSpec(
            name=fit_function.get("name", "custom"),
            extra_params=params,
            fun=fit_function["fun"],
            default=dict(fit_function.get("default", {})),
            continuous=bool(fit_function.get("continuous", True)),
            default_mode=dict(fit_function.get("default_mode", {})),
            dfun=fit_function.get("dfun"),
        )
    raise TypeError(f"Cannot interpret fit_function={fit_function!r}")
