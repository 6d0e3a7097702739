"""Autodiff gradients of the stationary K build against central finite
differences, for every stationary family (the reference's hand-written
``stationary_utils.c`` `_grad_X` / `_lengthscale_grads` contractions are what
autodiff of ``Stationary.K`` replaces). float64, rectangular X != Z, so every
pair is off the r = 0 kink."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as kern
from gaussian_process_optimization_tpu.utils.pytree import replace

FAMILIES = [
    (kern.RBF, False), (kern.Exponential, True), (kern.OU, False),
    (kern.Matern32, True), (kern.Matern52, True), (kern.Cosine, False),
    (kern.RatQuad, False),
]


def _kernel(cls, ard, d):
    if cls is kern.RatQuad:
        return cls.create(d, variance=1.7, lengthscale=0.8, power=1.5)
    return cls.create(d, variance=1.3,
                      lengthscale=np.array([0.7, 1.4, 0.9]) if ard else 0.8,
                      ARD=ard)


def _fd(f, x, eps=1e-6):
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        up, um = x.copy(), x.copy()
        up[i] += eps
        um[i] -= eps
        g[i] = (f(up) - f(um)) / (2 * eps)
    return g


@pytest.mark.parametrize("cls,ard", FAMILIES)
def test_K_gradients_match_finite_differences(cls, ard, rng):
    d = 3
    X = jnp.asarray(rng.uniform(-2, 2, size=(9, d)))
    Z = jnp.asarray(rng.uniform(-2, 2, size=(7, d)))
    G = jnp.asarray(rng.standard_normal((9, 7)))
    k = _kernel(cls, ard, d)

    def loss(kk, Xv):
        return jnp.sum(kk.K(Xv, Z) * G)

    gk, gX = jax.grad(loss, argnums=(0, 1))(k, X)
    np.testing.assert_allclose(
        np.asarray(gX), _fd(lambda x: float(loss(k, jnp.asarray(x))), X),
        rtol=1e-5, atol=1e-7)
    fields = ["variance", "lengthscale"] + (["power"] if cls is kern.RatQuad
                                            else [])
    for name in fields:
        val = getattr(k, name)

        def f(v, name=name):
            return float(loss(replace(k, **{name: jnp.asarray(v)}), X))

        np.testing.assert_allclose(np.asarray(getattr(gk, name)), _fd(f, val),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_K_gradient_wrt_second_argument(rng):
    """dK(X, Z)/dZ (the cross-covariance side the acquisition gradient uses)."""
    d = 3
    X = jnp.asarray(rng.uniform(-2, 2, size=(8, d)))
    Z = jnp.asarray(rng.uniform(-2, 2, size=(5, d)))
    G = jnp.asarray(rng.standard_normal((8, 5)))
    k = kern.Matern52.create(d, variance=1.1, lengthscale=np.array([0.6, 1.2, 2.0]),
                             ARD=True)

    def loss(Zv):
        return jnp.sum(k.K(X, Zv) * G)

    np.testing.assert_allclose(
        np.asarray(jax.grad(loss)(Z)),
        _fd(lambda z: float(loss(jnp.asarray(z))), Z), rtol=1e-5, atol=1e-7)
