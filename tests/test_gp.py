"""Exact GP regression tests: LML/predict parity with a hand-rolled numpy GP (the same
math as GPy exact_gaussian_inference.py:37 / posterior.py:274), checkgrad vs finite
differences (GPy gp_tests.py pattern), padding invariance, normalizer, fit recovery."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as kern
from gaussian_process_optimization_tpu.models import fit as fit_mod
from gaussian_process_optimization_tpu.models.gp import GPRegression
from gaussian_process_optimization_tpu.models.mean_functions import Constant
from gaussian_process_optimization_tpu.models.parameters import make_packer


def _numpy_gp(X, Y, Xs, var, ls, noise):
    """Reference exact GP (RBF), mirroring GPy's formulas."""
    def k(A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return var * np.exp(-0.5 * d2 / ls**2)

    n = X.shape[0]
    Ky = k(X, X) + (noise + 1e-8) * np.eye(n)
    L = np.linalg.cholesky(Ky)
    alpha = np.linalg.solve(Ky, Y)
    logdet = 2 * np.log(np.diag(L)).sum()
    lml = 0.5 * (-n * Y.shape[1] * np.log(2 * np.pi) - Y.shape[1] * logdet
                 - (alpha * Y).sum())
    Ks = k(X, Xs)
    mu = Ks.T @ alpha
    tmp = np.linalg.solve(L, Ks)
    v = var - (tmp**2).sum(0)
    return lml, mu, v


@pytest.fixture
def toy(rng):
    X = rng.uniform(-2, 2, size=(25, 2))
    Y = (np.sin(X[:, :1]) + 0.3 * X[:, 1:2] ** 2 + 0.05 * rng.standard_normal((25, 1)))
    Xs = rng.uniform(-2, 2, size=(7, 2))
    return X, Y, Xs


def test_lml_and_predict_match_numpy(toy):
    X, Y, Xs = toy
    var, ls, noise = 1.4, 0.9, 0.05
    k = kern.RBF.create(2, variance=var, lengthscale=ls)
    m = GPRegression.create(X, Y, kernel=k, noise_var=noise)
    lml = float(m.log_marginal_likelihood())
    mu, v = m.predict(jnp.asarray(Xs))
    lml_np, mu_np, v_np = _numpy_gp(X, Y, Xs, var, ls, noise)
    # tolerance: our pairwise distances use the -2XX^T+|X|^2 matmul trick,
    # numpy uses direct (A-B)^2 — agreement is limited by that cancellation (~1e-7)
    np.testing.assert_allclose(lml, lml_np, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu), mu_np, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v)[:, 0], v_np + noise, rtol=1e-6, atol=1e-8)
    # noiseless
    _, v2 = m.predict_noiseless(jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(v2)[:, 0], v_np, rtol=1e-6, atol=1e-8)
    # full covariance diag == var
    _, C = m.predict(jnp.asarray(Xs), full_cov=True, include_likelihood=False)
    np.testing.assert_allclose(np.diag(np.asarray(C)), v_np, rtol=1e-5, atol=1e-8)


def test_padding_invariance(toy):
    X, Y, Xs = toy
    k = kern.Matern52.create(2, variance=1.0, lengthscale=1.2)
    m = GPRegression.create(X, Y, kernel=k, noise_var=0.1)
    mp = GPRegression.create(X, Y, kernel=k, noise_var=0.1, max_points=40)
    np.testing.assert_allclose(
        float(m.log_marginal_likelihood()), float(mp.log_marginal_likelihood()), rtol=1e-10
    )
    mu, v = m.predict(jnp.asarray(Xs))
    mup, vp = mp.predict(jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mup), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v), np.asarray(vp), rtol=1e-8, atol=1e-12)


def test_normalizer_and_mean_function(toy):
    X, Y, Xs = toy
    k = kern.RBF.create(2)
    m = GPRegression.create(X, Y + 100.0, kernel=k, noise_var=0.1, normalizer=True)
    mu, v = m.predict(jnp.asarray(X))
    # with normalization, predictions at training points should be near raw Y scale
    assert abs(float(jnp.mean(mu)) - (float(np.mean(Y)) + 100.0)) < 1.0
    assert np.all(np.asarray(v) > 0)

    mf = Constant.create(2, value=5.0)
    m2 = GPRegression.create(X, Y, kernel=k, noise_var=0.1, mean_function=mf)
    mu_far, _ = m2.predict(jnp.asarray(100.0 * np.ones((1, 2))))
    np.testing.assert_allclose(np.asarray(mu_far), [[5.0]], atol=1e-6)


def test_lml_gradient_checkgrad(toy):
    """m.checkgrad() equivalent: autodiff grad of -(LML) in unconstrained space vs
    central finite differences."""
    X, Y, _ = toy
    k = kern.Matern52.create(2, variance=1.5, lengthscale=np.array([0.7, 1.3]), ARD=True)
    m = GPRegression.create(X, Y, kernel=k, noise_var=0.08)
    packer = make_packer(m)
    obj = fit_mod.make_objective(packer)
    u0 = np.asarray(packer.pack(m))
    g = np.asarray(jax.grad(lambda u: obj(u, m))(jnp.asarray(u0)))
    eps = 1e-4  # FD noise is erratic at 1e-6 here; 1e-4 and 1e-7 both agree w/ autodiff
    fd = np.zeros_like(u0)
    for i in range(u0.size):
        up, um = u0.copy(), u0.copy()
        up[i] += eps
        um[i] -= eps
        fd[i] = (float(obj(jnp.asarray(up), m)) - float(obj(jnp.asarray(um), m))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-7)


def test_fit_improves_and_recovers(rng):
    # sample from a known GP and check the fit recovers reasonable hyperparameters
    n = 40
    X = rng.uniform(-3, 3, size=(n, 1))
    def k_true(A, B):
        return 2.0 * np.exp(-0.5 * ((A[:, None, 0] - B[None, :, 0]) ** 2) / 0.5**2)
    K = k_true(X, X) + 0.01 * np.eye(n)
    Y = np.linalg.cholesky(K) @ rng.standard_normal((n, 1))
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1), noise_var=1.0)
    lml0 = float(m.log_marginal_likelihood())
    fitted, res = fit_mod.fit(m, num_restarts=3, maxiter=200, key=jax.random.PRNGKey(1))
    lml1 = float(fitted.log_marginal_likelihood())
    assert lml1 > lml0 + 1.0
    assert 0.001 < float(fitted.likelihood_variance) < 0.1
    assert 0.2 < float(fitted.kern.lengthscale) < 1.5


def test_fit_fixed_noise(toy):
    """exact_feval semantics: noise fixed (GPyOpt gpmodel.py:72-76)."""
    X, Y, _ = toy
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(2), noise_var=1e-6)
    fitted, _ = fit_mod.fit(m, num_restarts=2, maxiter=100,
                            fix=("likelihood_variance",), key=jax.random.PRNGKey(0))
    assert float(fitted.likelihood_variance) == pytest.approx(1e-6)
    assert float(fitted.log_marginal_likelihood()) > float(m.log_marginal_likelihood())


def test_predictive_gradients(toy):
    X, Y, Xs = toy
    k = kern.RBF.create(2, variance=1.2, lengthscale=0.8)
    m = GPRegression.create(X, Y, kernel=k, noise_var=0.05, normalizer=True)
    dm, dv = m.predictive_gradients(jnp.asarray(Xs))
    assert dm.shape == (7, 2, 1) and dv.shape == (7, 2)
    eps = 1e-6
    for j in range(2):
        Xp, Xm = Xs.copy(), Xs.copy()
        Xp[:, j] += eps
        Xm[:, j] -= eps
        mup, vup = m.predict(jnp.asarray(Xp))
        mum, vum = m.predict(jnp.asarray(Xm))
        fd_m = (np.asarray(mup) - np.asarray(mum)) / (2 * eps)
        fd_v = (np.asarray(vup) - np.asarray(vum))[:, 0] / (2 * eps)
        np.testing.assert_allclose(np.asarray(dm)[:, j, 0], fd_m[:, 0], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(np.asarray(dv)[:, j], fd_v, rtol=1e-4, atol=1e-7)


def test_posterior_samples(toy):
    X, Y, Xs = toy
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(2), noise_var=0.05)
    s = m.posterior_samples_f(jnp.asarray(Xs), size=500, key=jax.random.PRNGKey(2))
    assert s.shape == (7, 500)
    mu, v = m.predict_noiseless(jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(s.mean(axis=1)), np.asarray(mu)[:, 0], atol=0.15)


def test_loo(toy):
    X, Y, _ = toy
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(2), noise_var=0.05)
    lpd = m.log_likelihood_LOO()
    assert lpd.shape == (25, 1)
    assert np.all(np.isfinite(np.asarray(lpd)))


def test_checkgrad_method(toy):
    """paramz m.checkgrad() parity via models.fit.checkgrad."""
    X, Y, _ = toy
    for kcls in [kern.RBF, kern.Matern52]:
        m = GPRegression.create(X, Y, kernel=kcls.create(2, ARD=True), noise_var=0.05)
        assert fit_mod.checkgrad(m)
