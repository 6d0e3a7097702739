"""BO surrogate-model wrappers (GPyOpt/GPyOpt/models/: base.py `BOModel`, gpmodel.py:9
`GPModel`, `GPModel_MCMC`:180).

The wrapper owns the GPyOpt-side conventions:
- ``predict`` returns (mean, **std**) with the variance clipped at 1e-10 before the
  sqrt (gpmodel.py:102, :99);
- ``get_fmin`` = min posterior mean at the training inputs (gpmodel.py:125);
- default kernel Matern52 (ARD), optionally Gower-wrapped with the design space's
  continuous ranges (gpmodel.py:58, the reference author's modification);
- default noise = Y.var() * 0.01 (gpmodel.py:64); ``exact_feval`` fixes the noise at
  1e-6, otherwise it is bounded to [1e-9, 1e6] (gpmodel.py:72-76);
- ``updateModel`` refits with multi-restart L-BFGS (gpmodel.py:88-93).

Accelerator-first redesign: training data lives in fixed-size padded buffers (bucketed at
powers of two), so the jitted fit/predict programs compile once per bucket instead of
once per BO iteration; the per-bucket `Fitter` programs are cached on the wrapper.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..kernels.gower import Gower
from ..kernels.stationary import Matern52
from ..utils.pytree import replace
from ..utils.transforms import Logistic
from .fit import Fitter
from .gp import GPRegression


def _bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two padding bucket: O(log N) recompiles as the BO loop grows N."""
    return max(minimum, 2 ** math.ceil(math.log2(max(n, 1))))


# Module-level jitted predict programs (gp/post as pytree ARGUMENTS so the
# compiled code is shared across refits): the eager method chain dispatched
# ~10 small programs per call, and an eager predict in a host loop (LP
# update_batches, get_fmin, pool scoring) pays that dispatch cost every time.
@jax.jit
def _predict_mean_std(gp, post, X, floor):
    mu, v = gp.predict(X, posterior=post)
    return mu, jnp.sqrt(jnp.clip(v, floor, None))


@jax.jit
def _predict_with_gradients(gp, post, X, floor):
    mu, v = gp.predict(X, posterior=post)
    v = jnp.clip(v, floor, None)
    s = jnp.sqrt(v)
    dm, dv = gp.predictive_gradients(X, posterior=post)
    return mu, s, dm[:, :, 0], dv / (2.0 * s)


@jax.jit
def _fmin_device(gp, post):
    mu, _ = gp.predict(gp.X, posterior=post)
    if gp.mask is not None:
        mu = jnp.where(gp.mask[:, None] > 0, mu, jnp.inf)
    return jnp.min(mu)


@jax.jit
def _inference_device(gp):
    return gp.inference(precompute_inverse=True)


class BOModel:
    """Abstract surrogate interface (GPyOpt models/base.py)."""

    analytical_gradient_prediction = False
    MCMC_sampler = False

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        raise NotImplementedError

    def predict(self, X):
        raise NotImplementedError

    def predict_withGradients(self, X):
        raise NotImplementedError

    def get_fmin(self):
        raise NotImplementedError


class GPModel(BOModel):
    """Exact/padded GP surrogate (GPyOpt gpmodel.py:9)."""

    analytical_gradient_prediction = True

    def __init__(
        self,
        kernel=None,
        noise_var=None,
        exact_feval=False,
        optimizer="lbfgs",
        max_iters=1000,
        optimize_restarts=5,
        verbose=False,
        ARD=False,
        Gower=False,
        space=None,
        mean_function=None,
        seed=0,
        mesh=None,
    ):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.optimizer_name = optimizer
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.verbose = verbose
        self.ARD = ARD
        self.Gower = Gower
        self.space = space
        self.mean_function = mean_function
        # optional jax.sharding.Mesh: restart chains shard over its 'data' axis
        # (parallel.sharded.make_sharded_multistart_fit); total restarts become
        # ceil(optimize_restarts / n_devices) per device x n_devices
        self.mesh = mesh
        self.model: GPRegression | None = None
        self.posterior = None
        self._fitters: dict = {}
        self._key = jax.random.PRNGKey(seed)

    # ------------------------------------------------------------------ internals
    def _default_kernel(self, input_dim):
        """Matern52 ARD default; Gower wrap takes the space's continuous ranges
        (gpmodel.py:58 + GPy stationary.py:61-64)."""
        base = Matern52.create(input_dim, variance=1.0, ARD=self.ARD)
        if self.Gower and self.space is not None:
            # The kernel slices MODEL-space X (one-hot expanded), so the
            # continuous/discrete column indices must come from the model-space
            # slices — get_continuous_dims() returns OBJECTIVE-space indices,
            # which misalign as soon as a categorical variable expands
            # (ADVICE round 1). Categorical one-hot columns go down the Hamming
            # branch, which is exact on 0/1 indicators.
            cont, disc = [], []
            for v, sl in zip(self.space.space_expanded, self.space._model_slices):
                (cont if v.is_continuous else disc).extend(range(sl.start, sl.stop))
            return Gower.create(
                base,
                ranges=np.asarray(self.space.lengthscales(), dtype=float),
                cont_dims=tuple(cont),
                disc_dims=tuple(disc),
                gpy_compat=True,
            )
        return base

    def _create_model(self, X, Y, max_points):
        noise = self.noise_var if self.noise_var is not None else float(np.var(Y)) * 0.01
        kern = self.kernel_template
        if kern is None:
            kern = self._default_kernel(X.shape[1])
        noise = 1e-6 if self.exact_feval else noise
        self.model = GPRegression.create(
            X, Y, kernel=kern, noise_var=noise,
            mean_function=self.mean_function, max_points=max_points,
        )
        # jitchol ladder warm start (see GPRegression.jitter_hint): refreshed
        # from Posterior.rung after every refit. Materialized here (not None)
        # so the Fitter's pytree structure is stable from the first fit on.
        # jitter_greedy: fit line-search trials accept the first rung that
        # factors, walking up from the hint (1 batched Cholesky steady state);
        # the once-per-refit posterior below re-verifies minimality and
        # re-anchors the hint, so a stale-high rung descends at the next refit.
        self.model = replace(self.model, jitter_hint=jnp.zeros((), jnp.float32),
                             jitter_greedy=True)

    def _fitter_for(self, bucket):
        if bucket not in self._fitters:
            if self.exact_feval:
                # fix the noise (gpmodel.py:72-73)
                fix, overrides = ("likelihood_variance",), None
            else:
                # bound it to [1e-9, 1e6] (gpmodel.py:74-76)
                fix, overrides = (), {"likelihood_variance": Logistic(lo=1e-9, hi=1e6)}
            if self.mesh is not None:
                from ..parallel.sharded import make_sharded_multistart_fit

                n_dev = self.mesh.shape["data"]
                per_dev = max(1, -(-self.optimize_restarts // n_dev))
                self._fitters[bucket] = make_sharded_multistart_fit(
                    self.model, self.mesh, restarts_per_device=per_dev,
                    maxiter=self.max_iters, fix=fix,
                    transform_overrides=overrides,
                )
            else:
                self._fitters[bucket] = Fitter(
                    self.model,
                    num_restarts=self.optimize_restarts,
                    maxiter=self.max_iters,
                    fix=fix,
                    transform_overrides=overrides,
                )
        return self._fitters[bucket]

    # ------------------------------------------------------------------ public API
    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        """Refit on all data (gpmodel.py:78-93): set data, multi-restart L-BFGS."""
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        n = X_all.shape[0]
        bucket = _bucket(n)
        if self.model is None:
            self._create_model(X_all, Y_all, max_points=bucket)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        if self.max_iters > 0:
            fitter = self._fitter_for(bucket)
            self._key, sub = jax.random.split(self._key)
            self.model, _info = fitter(self.model, sub)
        # precompute L^-1: the posterior feeds the acquisition sweep + vmapped
        # multistart, where matmul-path prediction avoids latency-bound
        # triangular solves (Posterior.Li); jitted — the eager chain was ~10
        # dispatches per refit. The posterior factors with the
        # VERIFIED minimal-rung ladder (jitter_greedy=False) — it is the
        # once-per-refit anchor that lets a stale-high greedy rung descend.
        self.posterior = _inference_device(
            replace(self.model, jitter_greedy=False))
        # feed the accepted jitter rung back as the NEXT refit's ladder warm
        # start (stays a device scalar — no host sync). The fitted params'
        # conditioning is the best predictor of the next iteration's: the
        # Gower/exact_feval fit re-climbs 5 rungs per line-search trial
        # without it.
        if self.model.jitter_hint is not None and self.posterior.rung is not None:
            self.model = replace(
                self.model,
                jitter_hint=self.posterior.rung.astype(jnp.float32))
        self._fmin = None

    def predict(self, X):
        """(mean, STD) with variance floored at 1e-10 (gpmodel.py:102-124)."""
        X = np.atleast_2d(X)
        mu, s = _predict_mean_std(self.model, self.posterior,
                                  jnp.asarray(X, dtype=float),
                                  config.variance_floor)
        return np.asarray(mu), np.asarray(s)

    def predict_covariance(self, X):
        _, cov = self.model.predict(jnp.asarray(np.atleast_2d(X), dtype=float),
                                    full_cov=True, posterior=self.posterior)
        return np.asarray(cov)

    def predict_withGradients(self, X):
        """(m, s, dm/dx, ds/dx); ds = dv/dx / (2 s) (gpmodel.py:131-141)."""
        X = jnp.asarray(np.atleast_2d(X), dtype=float)
        mu, s, dm, ds = _predict_with_gradients(self.model, self.posterior, X,
                                                config.variance_floor)
        return np.asarray(mu), np.asarray(s), np.asarray(dm), np.asarray(ds)

    def get_fmin(self):
        """Min posterior mean at the training points (gpmodel.py:125-129), cached
        per refit."""
        if getattr(self, "_fmin", None) is None:
            self._fmin = float(_fmin_device(self.model, self.posterior))
        return self._fmin

    def Y_min(self):
        """min of the (real, unpadded) training targets — LP's `Min`
        (batch_local_penalization.py:44 uses model.model.Y.min())."""
        Y = np.asarray(self.model.Y)
        if self.model.mask is not None:
            Y = Y[np.asarray(self.model.mask) > 0]
        return float(Y.min())

    def get_model_parameters(self):
        leaves = jax.tree_util.tree_leaves((self.model.kern, self.model.likelihood_variance))
        return np.atleast_2d(np.concatenate([np.ravel(np.asarray(l)) for l in leaves]))

    def get_model_parameters_names(self):
        from .parameters import _leaf_names

        return _leaf_names((self.model.kern, self.model.likelihood_variance))

    # pure device-side state for jitted acquisition programs
    def device_state(self):
        return self.model, self.posterior, jnp.asarray(self.get_fmin())
