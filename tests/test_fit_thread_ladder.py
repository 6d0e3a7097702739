"""Within-fit jitchol ladder-rung threading (Fitter(thread_ladder=...)).

The L-BFGS aux channel carries the accepted rung of each line-search trial's
jitter ladder into the next trial's `jitter_hint` (greedy walk up — the same
policy the BO wrappers apply across refits, bo_models.updateModel). Guards:
- rung-0 data: threaded fit is EXACTLY the plain fit (greedy from hint 0 is
  GPy's fresh sequential ladder, util/linalg.py:56-74);
- ladder-climbing data: the threaded fit reaches the same optima and the aux
  records the climbed rungs;
- default OFF (an A/B found no win on the bench workload), GPRegression-only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as kern
from gaussian_process_optimization_tpu.config import config
from gaussian_process_optimization_tpu.models import fit as fit_mod
from gaussian_process_optimization_tpu.models.gp import GPRegression


def _toy(n=48, d=2, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d)).astype(dtype)
    Y = (np.sin(X[:, :1] * 2) + 0.1 * rng.standard_normal((n, 1))).astype(dtype)
    return X, Y


def test_threaded_fit_matches_plain_on_rung0_data():
    X, Y = _toy()
    m = GPRegression.create(X, Y, kernel=kern.Matern52.create(2, ARD=True),
                            noise_var=0.05)
    f_off = fit_mod.Fitter(m, num_restarts=3, maxiter=30, tol=0.0,
                           thread_ladder=False)
    f_on = fit_mod.Fitter(m, num_restarts=3, maxiter=30, tol=0.0,
                          thread_ladder=True)
    assert f_on.thread_ladder and not f_off.thread_ladder
    _, r0 = f_off(m, jax.random.PRNGKey(0))
    _, r1 = f_on(m, jax.random.PRNGKey(0))
    # rung never leaves 0 on well-conditioned data, so every trial's ladder is
    # identical to the plain path: same objectives, iterates, trial counts
    np.testing.assert_array_equal(np.asarray(r1.aux), 0.0)
    np.testing.assert_allclose(np.asarray(r1.f), np.asarray(r0.f), rtol=0)
    np.testing.assert_array_equal(np.asarray(r1.num_ls), np.asarray(r0.num_ls))


def test_threaded_fit_on_ladder_climbing_surface():
    # duplicated rows (rank 24 of 144) + below-roundoff noise and zero
    # floors -> the Gram is numerically singular at rung 0 (even in the
    # suite's x64) and the ladder must climb during the fit
    old_floor, old_jit = config.f32_noise_floor, config.noise_jitter
    config.f32_noise_floor = 0.0
    config.noise_jitter = 0.0
    try:
        rng = np.random.default_rng(0)
        Xu = rng.uniform(-2, 2, (24, 2))
        X = np.repeat(Xu, 6, axis=0)
        Y = np.sin(X[:, :1] * 2)
        m = GPRegression.create(
            X, Y, kernel=kern.RBF.create(2, ARD=True, variance=25.0),
            noise_var=1e-18)
        f_off = fit_mod.Fitter(m, num_restarts=3, maxiter=25, tol=0.0,
                               thread_ladder=False)
        f_on = fit_mod.Fitter(m, num_restarts=3, maxiter=25, tol=0.0,
                              thread_ladder=True)
        _, r0 = f_off(m, jax.random.PRNGKey(0))
        _, r1 = f_on(m, jax.random.PRNGKey(0))
        aux = np.asarray(r1.aux)
        assert np.all(np.isfinite(np.asarray(r1.f)))
        assert aux.max() >= 1.0, f"expected a climbed rung, got {aux}"
        # greedy-from-hint may accept a (one-rung) larger jitter than the
        # fresh ladder on trials where the needed rung dropped — optima must
        # still agree to line-search resolution
        np.testing.assert_allclose(np.asarray(r1.f), np.asarray(r0.f),
                                   rtol=1e-3)
    finally:
        config.f32_noise_floor = old_floor
        config.noise_jitter = old_jit


def test_default_off_and_gpregression_only():
    # default OFF (an A/B found no win on the bench workload);
    # explicit True applies to exact GPRegression only (the hint fields live
    # on it), and is ignored for models without the ladder-hint channel
    X, Y = _toy()
    m = GPRegression.create(X, Y, noise_var=0.05)
    assert not fit_mod.Fitter(m, num_restarts=1, maxiter=2).thread_ladder
    assert fit_mod.Fitter(m, num_restarts=1, maxiter=2,
                          thread_ladder=True).thread_ladder
    from gaussian_process_optimization_tpu.models.sparse import (
        SparseGPRegression,
    )
    sm = SparseGPRegression.create(X, Y, num_inducing=8)
    assert not fit_mod.Fitter(sm, num_restarts=1, maxiter=2,
                              thread_ladder=True).thread_ladder


def test_threaded_fit_respects_initial_hint():
    # a model carrying jitter_hint seeds the aux chain with it
    X, Y = _toy()
    m = GPRegression.create(X, Y, noise_var=0.05)
    from gaussian_process_optimization_tpu.utils.pytree import replace
    m = replace(m, jitter_hint=jnp.asarray(2.0, jnp.float32))
    f_on = fit_mod.Fitter(m, num_restarts=2, maxiter=3, tol=0.0,
                          thread_ladder=True)
    _, r = f_on(m, jax.random.PRNGKey(0))
    # greedy from an overshooting hint accepts the hint rung: the aux stays
    # at 2 on well-conditioned data (rungs never climb, hint never descends
    # within a fit — the posterior factorization re-anchors it, bo_models)
    np.testing.assert_array_equal(np.asarray(r.aux), 2.0)
