"""Port parity: model profiles and parameter packing, torch vs JAX.

The same numpy inputs go through ``clustertracking_tpu.models`` and
``clustertracking_tpu_torch.models``.  Profiles are elementwise float32
functions, so they agree to rounding (rtol 1e-6: transcendental
functions differ by about one ulp between XLA and PyTorch; atol 1e-30,
because XLA on the CPU flushes subnormal values to zero, PyTorch keeps
them, and values computed from one stay below ~1e-34); packing
is index bookkeeping and must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clustertracking_tpu.models import build_layout as jax_build_layout
from clustertracking_tpu.models import get_model as jax_get_model
from clustertracking_tpu_torch.models import build_layout, get_model
from clustertracking_tpu_torch.models.registry import elementwise

torch.set_num_threads(1)

RTOL = 1e-6
ATOL = 1e-30
R2 = np.linspace(0.0, 30.0, 241).astype(np.float32)
EXTRAS = {
    "gauss": (),
    "disc": (),
    "ring": (np.float32(0.2),),
    "hat": (np.float32(0.5),),
    "inv_series_2": (np.float32(0.5), np.float32(0.125)),
    "inv_series_3": (np.float32(0.4), np.float32(0.1), np.float32(0.02)),
}
MODEL_NAMES = list(EXTRAS)


def _both(name):
    return get_model(name), jax_get_model(name)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=rtol, atol=ATOL
    )


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_fun_matches_jax(name):
    m, jm = _both(name)
    ex = EXTRAS[name]
    _close(m.fun(_t(R2), *map(_t, ex)), jm.fun(jnp.asarray(R2), *ex))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_dfun_matches_jax(name):
    m, jm = _both(name)
    ex = EXTRAS[name]
    _close(m.dfun(_t(R2), *map(_t, ex)), jm.dfun(jnp.asarray(R2), *ex))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_dfun_f_matches_jax(name):
    m, jm = _both(name)
    ex = EXTRAS[name]
    f = np.asarray(jm.fun(jnp.asarray(R2), *ex))
    _close(
        m.dfun_f(_t(f), _t(R2), *map(_t, ex)),
        jm.dfun_f(jnp.asarray(f), jnp.asarray(R2), *ex),
    )


@pytest.mark.parametrize(
    "name", [n for n in MODEL_NAMES if EXTRAS[n]]
)
def test_dfun_dextra_matches_jax(name):
    """d fun / d extra_k through torch.func.grad vs jax.grad."""
    m, jm = _both(name)
    ex = EXTRAS[name]
    for k in range(len(ex)):
        got = elementwise(m.dfun_dextra(k))(_t(R2), *map(_t, ex))
        want = jnp.vectorize(jm.dfun_dextra(k))(jnp.asarray(R2), *ex)
        _close(got, want)


def test_custom_dict_model_grad_matches_jax():
    """A custom model dict without dfun: d fun / d r2 from autodiff."""
    m = get_model({"name": "lorentz", "fun": lambda r2: 1.0 / (1.0 + r2)})
    jm = jax_get_model({"name": "lorentz",
                        "fun": lambda r2: 1.0 / (1.0 + r2)})
    _close(elementwise(m.dfun_dr2())(_t(R2)),
           jnp.vectorize(jm.dfun_dr2())(jnp.asarray(R2)))


def test_get_model_resolution():
    g = get_model("gauss")
    assert get_model(g) is g
    assert get_model("inv_series_4").extra_params == tuple(
        f"coeff_{k}" for k in range(1, 5)
    )
    assert get_model("inv_series_4").default == jax_get_model(
        "inv_series_4"
    ).default
    with pytest.raises(ValueError):
        get_model("nope")
    with pytest.raises(TypeError):
        get_model(3)


LAYOUTS = [
    ("gauss", 2, True, 1, {}),
    ("gauss", 2, True, 2, {}),
    ("gauss", 2, True, 6, {}),
    ("gauss", 2, True, 2, {"size": "var", "background": "cluster"}),
    ("gauss", 2, False, 3, {"size_y": "var", "size_x": "cluster"}),
    ("gauss", 3, False, 2, {"size_z": "var", "size_y": "var",
                            "size_x": "var"}),
    ("ring", 2, True, 2, {"thickness": "cluster"}),
    ("inv_series_2", 2, True, 2, {}),
]


@pytest.mark.parametrize("name,ndim,iso,n,modes", LAYOUTS)
def test_layout_matches_jax(name, ndim, iso, n, modes):
    lay = build_layout(get_model(name), ndim, iso, n, modes)
    jlay = jax_build_layout(jax_get_model(name), ndim, iso, n, modes)
    assert lay.param_names == jlay.param_names
    assert lay.modes == jlay.modes
    assert lay.n_slots == jlay.n_slots
    np.testing.assert_array_equal(lay.slot_idx, jlay.slot_idx)
    np.testing.assert_array_equal(lay.global_slots, jlay.global_slots)
    np.testing.assert_array_equal(lay.pack_matrix(), jlay.pack_matrix())


@pytest.mark.parametrize("name,ndim,iso,n,modes", LAYOUTS)
def test_packing_round_trip_matches_jax(name, ndim, iso, n, modes):
    lay = build_layout(get_model(name), ndim, iso, n, modes)
    jlay = jax_build_layout(jax_get_model(name), ndim, iso, n, modes)
    rng = np.random.default_rng(n + ndim)
    params = rng.uniform(-5, 50, (4, n, lay.n_params)).astype(np.float32)
    const = rng.uniform(-5, 50, params.shape).astype(np.float32)
    v = lay.vect_from_params(_t(params))
    jv = jlay.vect_from_params(jnp.asarray(params))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    back = lay.vect_to_params(v, _t(const))
    jback = jlay.vect_to_params(jv, jnp.asarray(const))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
