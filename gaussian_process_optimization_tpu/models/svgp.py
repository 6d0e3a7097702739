"""Stochastic variational GP (SVGP) — minibatch scaling past the exact-GP wall.

Rebuild of GPy's SVGP (``GPy/GPy/core/svgp.py:11``,
``GPy/GPy/inference/latent_function_inference/svgp.py:10``): whitened q(u) with a
flat-packed Cholesky (ops/choleskies), ELBO = sum_n E_q[log p(y_n|f_n)] * (N/batch)
- KL(q(u) || p(u)), optimized by minibatch Adam (the reference uses climin SGD slices).

Accelerator-first: one jitted `svgp_step`; data parallelism across a mesh is a `psum` of the
per-shard expected-likelihood term (see parallel/sharded.py) — the direct analog of
the reference's MPI allreduce (``var_dtc_parallel.py`` reduceArrays).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..ops.choleskies import flat_to_triang, triang_to_flat
from ..utils.pytree import pytree_dataclass
from .gp import LOG_2_PI


@pytree_dataclass
class SVGP:
    kern: Kernel = None
    likelihood_variance: jnp.ndarray = None
    Z: jnp.ndarray = None  # (M, D)
    q_mu: jnp.ndarray = None  # (M, P) whitened mean
    q_sqrt_flat: jnp.ndarray = None  # (M(M+1)/2, P) packed whitened chol
    num_data: int = 0  # static via pytree? keep as array for safety
    # optional non-Gaussian likelihood (GPy SVGP works with any likelihood via
    # quadrature, core/svgp.py); None -> closed-form Gaussian ELL
    likelihood: object = None

    @classmethod
    def create(cls, X, Y, kernel=None, num_inducing=20, Z=None, noise_var=0.1, seed=0,
               likelihood=None):
        import numpy as np

        X = np.atleast_2d(np.asarray(X, dtype=float))
        Y = np.asarray(Y, dtype=float).reshape(len(X), -1)
        n, d = X.shape
        p = Y.shape[1]
        if kernel is None:
            kernel = RBF.create(d)
        if Z is None:
            rng = np.random.default_rng(seed)
            Z = X[rng.permutation(n)[: num_inducing]].copy()
        m = Z.shape[0]
        eye_flat = triang_to_flat(jnp.tile(jnp.eye(m)[None], (p, 1, 1)))
        return cls(
            kern=kernel,
            likelihood_variance=jnp.asarray(noise_var, dtype=float).reshape(()),
            Z=jnp.asarray(Z, dtype=float),
            q_mu=jnp.zeros((m, p)),
            q_sqrt_flat=eye_flat,
            num_data=jnp.asarray(float(n)),
            likelihood=likelihood,
        )

    # ------------------------------------------------------------------ math
    def _q_sqrt(self):
        return flat_to_triang(self.q_sqrt_flat, self.Z.shape[0])  # (P, M, M)

    def kl(self):
        """KL(q(v) || N(0, I)) in whitened coordinates (svgp.py bound)."""
        Ls = self._q_sqrt()
        m = self.Z.shape[0]
        logdet = 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(Ls, axis1=-2, axis2=-1))))
        tr = jnp.sum(jnp.square(Ls))
        mahal = jnp.sum(jnp.square(self.q_mu))
        p = self.q_mu.shape[1]
        return 0.5 * (tr + mahal - m * p - logdet)

    def _predict_f(self, X, full_cov=False):
        """q(f(X)) under whitened q(u)."""
        m = self.Z.shape[0]
        Kmm = self.kern.K(self.Z) + 1e-6 * jnp.eye(m)
        Lm, _, _ = linalg.jitchol(Kmm)
        Kmx = self.kern.K(self.Z, X)
        A = linalg.solve_lower(Lm, Kmx)  # (M, B)
        mu = A.T @ self.q_mu  # (B, P)
        Ls = self._q_sqrt()  # (P, M, M)
        SA = jnp.einsum("pmk,kb->pmb", jnp.swapaxes(Ls, -1, -2), A)  # Ls^T A
        if full_cov:
            cov = self.kern.K(X) - A.T @ A + jnp.einsum("pmb,pmc->bc", SA, SA)
            return mu, cov
        var = (
            self.kern.Kdiag(X)[:, None]
            - jnp.sum(jnp.square(A), axis=0)[:, None]
            + jnp.sum(jnp.square(SA), axis=1).T
        )
        return mu, jnp.clip(var, 1e-15, None)

    def _expected_log_lik(self, Y_batch, mu, var):
        """E_q[log p(y|f)]: closed form for Gaussian, Gauss-Hermite otherwise
        (the reference's quadrature fallback, likelihoods/likelihood.py)."""
        if self.likelihood is None:
            sigma2 = self.likelihood_variance + config.noise_jitter
            return -0.5 * (LOG_2_PI + jnp.log(sigma2)) - 0.5 * (
                jnp.square(Y_batch - mu) + var
            ) / sigma2
        import numpy as np

        gh_x, gh_w = np.polynomial.hermite.hermgauss(20)
        gh_x = jnp.asarray(gh_x, dtype=mu.dtype)
        gh_w = jnp.asarray(gh_w, dtype=mu.dtype) / jnp.sqrt(jnp.pi)
        f = mu[..., None] + jnp.sqrt(2.0 * var[..., None]) * gh_x
        lp = self.likelihood.logpdf(f, Y_batch[..., None])
        return jnp.sum(gh_w * lp, axis=-1)

    def elbo(self, X_batch, Y_batch, batch_mask=None):
        """Minibatch evidence lower bound."""
        mu, var = self._predict_f(X_batch)
        ell = self._expected_log_lik(Y_batch, mu, var)
        if batch_mask is not None:
            ell = ell * batch_mask[:, None]
            b = jnp.sum(batch_mask)
        else:
            b = X_batch.shape[0]
        scale = self.num_data / jnp.maximum(b, 1.0)
        return scale * jnp.sum(ell) - self.kl()

    def log_likelihood(self, X, Y):
        """Full-data bound (GPy SVGP.log_likelihood)."""
        return self.elbo(X, Y)

    def predict(self, Xnew, include_likelihood=True, full_cov=False):
        mu, var = self._predict_f(jnp.atleast_2d(Xnew), full_cov=full_cov)
        if include_likelihood:
            if self.likelihood is not None:
                if full_cov:
                    # a non-Gaussian predictive has no closed-form joint; the
                    # old fall-through silently added the UNUSED Gaussian
                    # likelihood_variance field to a classification covariance
                    raise NotImplementedError(
                        "full_cov predictive through a non-Gaussian likelihood "
                        "has no closed form; use include_likelihood=False for "
                        "the latent covariance")
                ey, vy = self.likelihood.predictive(mu[:, 0], var[:, 0])
                return ey[:, None], vy[:, None]
            if full_cov:
                var = var + self.likelihood_variance * jnp.eye(var.shape[0])
            else:
                var = var + self.likelihood_variance
        return mu, var

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), key=None):
        """Predictive quantiles through the model's likelihood (GPy core
        svgp.py inherits gp.py:384 -> likelihood.predictive_quantiles — the
        Gaussian closed form, or the sampling fallback for the non-Gaussian
        zoo). Percent units; list of (M, 1) arrays."""
        mu, var = self._predict_f(jnp.atleast_2d(Xnew), full_cov=False)
        lik = self.likelihood
        if lik is None:
            from .likelihoods import GaussianLik

            lik = GaussianLik(variance=self.likelihood_variance)
        return lik.predictive_quantiles(mu[:, 0], var[:, 0], quantiles, key=key)

    def log_predictive_density(self, x_test, y_test, gh_points=32):
        """Per-point log p(y*|D) through the likelihood (GPy gp.py:680)."""
        mu, var = self._predict_f(jnp.atleast_2d(x_test), full_cov=False)
        y = jnp.atleast_2d(jnp.asarray(y_test))
        lik = self.likelihood
        if lik is None:
            from .likelihoods import GaussianLik

            lik = GaussianLik(variance=self.likelihood_variance)
        return lik.log_predictive_density(y[:, 0], mu[:, 0], var[:, 0],
                                          gh_points=gh_points)[:, None]


def make_svgp_train_step(optimizer=None, learning_rate=1e-2):
    """Jitted Adam step on -(ELBO). Returns (step_fn, init_fn) working on the
    trainable subset (kernel params, noise, Z, q_mu, q_sqrt)."""
    import optax

    from .parameters import make_packer

    opt = optimizer or optax.adam(learning_rate)

    def make(model):
        packer = make_packer(model, fix=("num_data",))

        @jax.jit
        def step(u, opt_state, model_ref, X_batch, Y_batch):
            def loss(uu):
                mdl = packer.unpack(uu, reference=model_ref)
                return -mdl.elbo(X_batch, Y_batch)

            val, g = jax.value_and_grad(loss)(u)
            updates, opt_state = opt.update(g, opt_state, u)
            u = optax.apply_updates(u, updates)
            return u, opt_state, val

        u0 = packer.pack(model)
        return packer, u0, opt.init(u0), step

    return make


def fit_svgp(model, X, Y, num_steps=500, batch_size=None, learning_rate=1e-2, key=None):
    """Minibatch SVI training loop (reference: climin-sliced batches, svgp_tests)."""
    import numpy as np

    key = key if key is not None else jax.random.PRNGKey(0)
    X = jnp.atleast_2d(jnp.asarray(X, dtype=float))
    Y = jnp.asarray(Y, dtype=float).reshape(len(X), -1)
    n = X.shape[0]
    batch_size = batch_size or min(n, 256)
    make = make_svgp_train_step(learning_rate=learning_rate)
    packer, u, opt_state, step = make(model)
    losses = []
    for i in range(num_steps):
        key, sub = jax.random.split(key)
        idx = jax.random.choice(sub, n, shape=(batch_size,), replace=False)
        u, opt_state, val = step(u, opt_state, model, X[idx], Y[idx])
        losses.append(float(val))
    fitted = packer.unpack(u, reference=model)
    return fitted, np.asarray(losses)
