"""GP surrogate with MCMC-integrated hyperparameters
(GPyOpt/GPyOpt/models/gpmodel.py:180 `GPModel_MCMC`).

Reference behavior replicated (gpmodel.py:213-255): default RBF kernel, Gamma
priors with E=2, V=4 on kernel params and noise (`Gamma.from_EV(2.,4.)`,
:231-232), noise default Y.var()*0.01, exact_feval fixes noise at 1e-6; updateModel
optimizes 200 iters, perturbs params by x(1 + 0.01 eps), runs HMC for
burnin + n*interval steps (step 0.1, 20 leapfrog) and keeps every `interval`-th
sample after burn-in; predict/get_fmin loop over the samples.

Accelerator-first: the hyperparameter samples live as a STACKED model pytree (leading
sample axis on parameter leaves), so the reference's per-sample Python loop is a
`vmap` — predictions over S samples are one batched program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..kernels.stationary import RBF
from ..utils.priors import GammaPrior
from .bo_models import BOModel, _bucket
from .fit import Fitter, make_objective
from .gp import GPRegression
from .hmc import hmc_sample
from .parameters import make_packer


class GPModel_MCMC(BOModel):
    MCMC_sampler = True
    analytical_gradient_prediction = True

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, n_samples=10,
                 n_burnin=100, subsample_interval=10, step_size=1e-1,
                 leapfrog_steps=20, verbose=False, seed=0):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.n_samples = n_samples
        self.n_burnin = n_burnin
        self.subsample_interval = subsample_interval
        self.step_size = step_size
        self.leapfrog_steps = leapfrog_steps
        self.verbose = verbose
        self.model: GPRegression | None = None
        self._key = jax.random.PRNGKey(seed)
        self._programs = {}

    # ------------------------------------------------------------------ internals
    def _priors(self):
        # Gamma(E=2, V=4) on positive hyperparameters (gpmodel.py:231-232)
        g = GammaPrior.from_EV(2.0, 4.0)
        priors = {"variance": g, "lengthscale": g}
        if not self.exact_feval:
            priors["likelihood_variance"] = g
        return priors

    def _build(self, X, Y, bucket):
        noise = self.noise_var if self.noise_var is not None else float(np.var(Y)) * 0.01
        noise = 1e-6 if self.exact_feval else noise
        kern = self.kernel_template or RBF.create(X.shape[1])
        self.model = GPRegression.create(X, Y, kernel=kern, noise_var=noise,
                                         max_points=bucket)

    def _program_for(self, bucket):
        if bucket not in self._programs:
            fix = ("likelihood_variance",) if self.exact_feval else ()
            packer = make_packer(self.model, fix=fix)
            obj = make_objective(packer, priors=self._priors())
            fitter = Fitter(self.model, num_restarts=1, maxiter=200, fix=fix,
                            priors=self._priors())

            def run_hmc(model, key, num_samples):
                u0 = packer.pack(model)
                k1, k2 = jax.random.split(key)
                # x(1 + 0.01 eps) perturbation in constrained space (gpmodel.py:251)
                # applied in unconstrained coords as additive noise of similar scale
                u0 = u0 * (1.0 + 0.01 * jax.random.normal(k1, u0.shape, dtype=u0.dtype))
                samples, rate = hmc_sample(
                    lambda u: obj(u, model), u0, k2, num_samples,
                    stepsize=self.step_size, leapfrog_steps=self.leapfrog_steps,
                )
                return samples, rate

            def stack_models(model, samples):
                return jax.vmap(lambda u: packer.unpack(u, reference=model))(samples)

            def batched_predict(stacked, X):
                def one(mdl):
                    post = mdl.inference()
                    mu, v = mdl.predict(X, posterior=post)
                    v = jnp.clip(v, config.variance_floor, None)
                    return mu, jnp.sqrt(v)

                return jax.vmap(one)(stacked)

            def batched_fmin(stacked):
                def one(mdl):
                    post = mdl.inference()
                    mu, _ = mdl.predict(mdl.X, posterior=post)
                    mu = jnp.where(mdl.mask[:, None] > 0, mu, jnp.inf)
                    return jnp.min(mu)

                return jax.vmap(one)(stacked)

            def batched_predict_grads(stacked, X):
                def one(mdl):
                    post = mdl.inference()
                    mu, v = mdl.predict(X, posterior=post)
                    v = jnp.clip(v, config.variance_floor, None)
                    s = jnp.sqrt(v)
                    dm, dv = mdl.predictive_gradients(X, posterior=post)
                    return mu, s, dm[:, :, 0], dv / (2.0 * s)

                return jax.vmap(one)(stacked)

            self._programs[bucket] = dict(
                packer=packer, fitter=fitter,
                run_hmc=jax.jit(run_hmc, static_argnames=("num_samples",)),
                stack=jax.jit(stack_models),
                predict=jax.jit(batched_predict),
                fmin=jax.jit(batched_fmin),
                predict_grads=jax.jit(batched_predict_grads),
            )
        return self._programs[bucket]

    # ------------------------------------------------------------------ public API
    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        if self.model is None:
            self._build(X_all, Y_all, bucket)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        prog = self._program_for(bucket)
        self._key, k_fit, k_hmc = jax.random.split(self._key, 3)
        self.model, _ = prog["fitter"](self.model, k_fit)
        total = self.n_burnin + self.n_samples * self.subsample_interval
        samples, rate = prog["run_hmc"](self.model, k_hmc, total)
        kept = samples[self.n_burnin :: self.subsample_interval][: self.n_samples]
        self.hmc_samples = np.asarray(kept)
        self._stacked = prog["stack"](self.model, kept)
        self._prog = prog
        if self.verbose:
            print(f"HMC accept rate: {float(rate):.2f}")

    def predict(self, X):
        """Lists of per-sample (means, stds) — the GPyOpt MCMC contract
        (gpmodel.py:257-277)."""
        X = jnp.asarray(np.atleast_2d(X), dtype=float)
        mus, stds = self._prog["predict"](self._stacked, X)
        return list(np.asarray(mus)), list(np.asarray(stds))

    def get_fmin(self):
        """Per-sample minima of the posterior mean at X (gpmodel.py:279-295)."""
        return list(np.asarray(self._prog["fmin"](self._stacked)))

    def Y_min(self):
        """min of the real training targets — LP's `Min`
        (batch_local_penalization.py:44)."""
        Y = np.asarray(self.model.Y)
        if self.model.mask is not None:
            Y = Y[np.asarray(self.model.mask) > 0]
        return float(Y.min())

    def get_model_parameters(self):
        """(S, P) matrix of the kept hyperparameter samples — GPyOpt's MCMC
        contract stores the chain, not a point estimate (gpmodel.py:247-255;
        bo_loop._save_model_parameter_values writes one row per iteration)."""
        import jax

        leaves = jax.tree_util.tree_leaves(
            (self._stacked.kern, self._stacked.likelihood_variance))
        S = np.asarray(leaves[0]).shape[0]
        return np.concatenate(
            [np.asarray(l).reshape(S, -1) for l in leaves], axis=1)

    def get_model_parameters_names(self):
        from .parameters import _leaf_names

        return _leaf_names((self.model.kern, self.model.likelihood_variance))

    def predict_withGradients(self, X):
        X = jnp.asarray(np.atleast_2d(X), dtype=float)
        mus, stds, dms, dss = self._prog["predict_grads"](self._stacked, X)
        return (list(np.asarray(mus)), list(np.asarray(stds)),
                list(np.asarray(dms)), list(np.asarray(dss)))

    # device-side state for the integrated acquisitions
    def device_state_mcmc(self):
        fmins = self._prog["fmin"](self._stacked)
        return self._stacked, fmins
