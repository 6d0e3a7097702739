"""BO wrappers for warped GPs (GPyOpt/GPyOpt/models/warpedgpmodel.py:15
`WarpedGPModel`, input_warped_gpmodel.py:9 `InputWarpedGPModel` — the latter warps
continuous and discrete dims with Kumar warping)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..kernels.stationary import Matern52
from .bo_models import BOModel, _bucket
from .fit import Fitter
from .warped import InputWarpedGP, WarpedGP


# Module-level jitted predict programs (see bo_models._predict_mean_std for
# why: eager method chains dispatch one program per op, and the per-call
# vmap/grad closures also re-traced every call).
@jax.jit
def _warped_predict(m, post, X, floor):
    mu, v = m.predict(X, posterior=post)
    return mu, jnp.sqrt(jnp.clip(v, floor, None))


@jax.jit
def _warped_predict_grads(m, post, X, floor):
    def mu_s(x):
        mu, v = m.predict(x[None, :], posterior=post)
        v = jnp.clip(v, floor, None)
        return jnp.ravel(mu)[0], jnp.sqrt(jnp.ravel(v)[0])

    ms, ss = jax.vmap(mu_s)(X)
    dm = jax.vmap(jax.grad(lambda x: mu_s(x)[0]))(X)
    ds = jax.vmap(jax.grad(lambda x: mu_s(x)[1]))(X)
    return ms, ss, dm, ds


@jax.jit
def _warped_posterior(m):
    # jitted per-refit posterior factorization (see bo_models._inference_device)
    return m.posterior_cache()


@jax.jit
def _warped_fmin(m, post):
    mu, _ = m.predict(m.gp.X, posterior=post)
    mu = jnp.ravel(mu)
    if m.gp.mask is not None:
        mu = jnp.where(m.gp.mask > 0, mu, jnp.inf)
    return jnp.min(mu)


class _WarpedBase(BOModel):
    analytical_gradient_prediction = False  # gradients via autodiff on demand

    def __init__(self, kernel=None, noise_var=None, exact_feval=False,
                 optimizer="lbfgs", max_iters=500, optimize_restarts=3,
                 verbose=False, ARD=False, seed=0):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.verbose = verbose
        self.ARD = ARD
        self.model = None
        self._fitters = {}
        self._key = jax.random.PRNGKey(seed)

    def _kern(self, d):
        return self.kernel_template or Matern52.create(d, ARD=self.ARD)

    def _make(self, X, Y, bucket):
        raise NotImplementedError

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        self.model = self._make(X_all, Y_all, bucket)
        if bucket not in self._fitters:
            fix = ("likelihood_variance",) if self.exact_feval else ()
            self._fitters[bucket] = Fitter(
                self.model, num_restarts=self.optimize_restarts,
                maxiter=self.max_iters, fix=fix,
            )
        self._key, sub = jax.random.split(self._key)
        self.model, _ = self._fitters[bucket](self.model, sub)
        # one Cholesky per refit; every predict below reuses it (GPModel keeps
        # the same invariant via self.posterior)
        self._post = _warped_posterior(self.model)

    def predict(self, X):
        X2 = np.atleast_2d(X)
        mu, s = _warped_predict(self.model, self._post,
                                jnp.asarray(X2, dtype=float),
                                config.variance_floor)
        return (np.asarray(mu).reshape(len(X2), -1),
                np.asarray(s).reshape(len(X2), -1))

    def predict_withGradients(self, X):
        X = jnp.asarray(np.atleast_2d(X), dtype=float)
        m, s, dm, ds = _warped_predict_grads(self.model, self._post, X,
                                             config.variance_floor)
        return (np.asarray(m)[:, None], np.asarray(s)[:, None],
                np.asarray(dm), np.asarray(ds))

    def get_fmin(self):
        return float(_warped_fmin(self.model, self._post))


class WarpedGPModel(_WarpedBase):
    """(warpedgpmodel.py:15)"""

    def __init__(self, *args, warping_terms=3, **kw):
        super().__init__(*args, **kw)
        self.warping_terms = warping_terms

    def _make(self, X, Y, bucket):
        noise = self.noise_var if self.noise_var is not None else float(np.var(Y)) * 0.01
        noise = 1e-6 if self.exact_feval else noise
        m = WarpedGP.create(X, Y, kernel=self._kern(X.shape[1]), noise_var=noise,
                            warping_terms=self.warping_terms, max_points=bucket)
        if self.model is not None:
            import dataclasses

            m = dataclasses.replace(m, warp=self.model.warp,
                                    gp=dataclasses.replace(
                                        m.gp, kern=self.model.gp.kern,
                                        likelihood_variance=self.model.gp.likelihood_variance))
        return m


class InputWarpedGPModel(_WarpedBase):
    """(input_warped_gpmodel.py:9) — warps continuous + discrete dims."""

    def __init__(self, space=None, *args, **kw):
        super().__init__(*args, **kw)
        self.space = space

    def _make(self, X, Y, bucket):
        noise = self.noise_var if self.noise_var is not None else float(np.var(Y)) * 0.01
        noise = 1e-6 if self.exact_feval else noise
        warping_indices = None
        if self.space is not None:
            warping_indices = sorted(
                self.space.get_continuous_dims() + self.space.get_discrete_dims()
            )
        m = InputWarpedGP.create(X, Y, kernel=self._kern(X.shape[1]), noise_var=noise,
                                 warping_indices=warping_indices, max_points=bucket)
        if self.model is not None:
            import dataclasses

            m = dataclasses.replace(
                m, warp=dataclasses.replace(self.model.warp, lo=m.warp.lo, hi=m.warp.hi),
                gp=dataclasses.replace(m.gp, kern=self.model.gp.kern,
                                       likelihood_variance=self.model.gp.likelihood_variance))
        return m
