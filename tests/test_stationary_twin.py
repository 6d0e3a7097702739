"""The stationary K build (plain jnp, compiled by XLA on every backend) against
an independent float64 numpy twin, per family — the reference's
cython-vs-numpy test genre (GPy/GPy/testing/cython_tests.py:26-45) — and the
check that no backend routes K through a hand-written kernel."""
import importlib
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as kern


def _twin(family, r, variance, power=None):
    if family == "rbf":
        return variance * np.exp(-0.5 * r * r)
    if family in ("exponential", "ou"):
        return variance * np.exp(-r)
    if family == "matern32":
        return variance * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)
    if family == "matern52":
        return variance * (1 + np.sqrt(5) * r + 5 / 3 * r * r) \
            * np.exp(-np.sqrt(5) * r)
    if family == "cosine":
        return variance * np.cos(r)
    if family == "ratquad":
        return variance * (1 + 0.5 * r * r) ** (-power)
    raise ValueError(family)


CASES = [
    (kern.RBF, False), (kern.Matern52, True), (kern.Matern32, False),
    (kern.OU, False), (kern.Exponential, True), (kern.RatQuad, False),
    (kern.Cosine, False),
]


@pytest.mark.parametrize("cls,ard", CASES)
def test_K_matches_numpy_twin(cls, ard, rng):
    d = 3
    X = rng.uniform(-3, 3, size=(70, d))
    Z = rng.uniform(-3, 3, size=(40, d))
    ls = np.array([0.5, 1.0, 2.0]) if ard else 0.8
    if cls is kern.RatQuad:
        k = cls.create(d, variance=1.7, lengthscale=ls, power=1.5)
    else:
        k = cls.create(d, variance=1.7, lengthscale=ls, ARD=ard)
    power = 1.5 if cls is kern.RatQuad else None

    def r(A, B):
        return np.sqrt((((A[:, None, :] - B[None, :, :]) / ls) ** 2).sum(-1))

    np.testing.assert_allclose(np.asarray(k.K(jnp.asarray(X), jnp.asarray(Z))),
                               _twin(k._family, r(X, Z), 1.7, power),
                               rtol=1e-10, atol=1e-12)
    # self-covariance: symmetric to round-off, the variance on the diagonal
    K_self = np.asarray(k.K(jnp.asarray(X)))
    np.testing.assert_allclose(K_self, K_self.T, rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.diag(K_self), 1.7, rtol=1e-12)
    np.testing.assert_allclose(K_self, _twin(k._family, r(X, X), 1.7, power),
                               rtol=1e-9, atol=1e-10)


def test_no_backend_selects_a_handwritten_kernel():
    """K is plain jnp on every backend: its program holds no Pallas call, and
    the package has no kernel module or switch to select one."""
    k = kern.Matern52.create(6, ARD=True)
    X = jnp.zeros((300, 6), jnp.float32)
    assert "pallas_call" not in str(jax.make_jaxpr(k.K)(X))
    assert importlib.util.find_spec(
        "gaussian_process_optimization_tpu.ops.pallas_kernels") is None
    cfg = importlib.import_module("gaussian_process_optimization_tpu.config")
    assert not any("pallas" in name for name in dir(cfg.config))
    assert not hasattr(cfg, "pallas_enabled")
