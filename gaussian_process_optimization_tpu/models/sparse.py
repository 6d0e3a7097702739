"""Sparse (inducing-point) GP regression: the O(N M^2) scaling path.

Rebuild of GPy's sparse inference stack (SURVEY §2.1 'Sparse inference'):
- VarDTC — Titsias collapsed variational bound
  (``GPy/GPy/inference/latent_function_inference/var_dtc.py:14``, inference :66)
- FITC   (``fitc.py:21``) — heteroscedastic diagonal correction
- DTC    (``dtc.py:23``) — deterministic training conditional
- model wrapper ``SparseGPRegression`` (``GPy/GPy/models/sparse_gp_regression.py``,
  ``GPy/GPy/core/sparse_gp.py:14`` — predictive variable = Z :64; Z is trainable).

All bounds are computed with the numerically standard Lm/LB factorization so the
whole thing is three matmuls + two small Cholesky factorizations; gradients
(including dL/dZ) come from autodiff, replacing GPy's hand-derived gradient plumbing.
Padding mask semantics match the exact GP: padded rows contribute nothing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.normalizer import Standardize
from ..utils.pytree import pytree_dataclass, static_field
from .gp import LOG_2_PI


@pytree_dataclass
class SparsePosterior:
    Lm: jnp.ndarray = None  # chol(Kmm)
    LB: jnp.ndarray = None  # chol(I + A A^T / sigma2)
    c: jnp.ndarray = None  # LB^-1 A y / sigma2
    lml: jnp.ndarray = None
    ok: jnp.ndarray = None


def kmm_init(X, m=10, rng=None):
    """Kmeans++-style inducing-point initialization (GPy util/misc.py:96
    kmm_init): pick a random seed point, then sample each next point with
    probability proportional to squared distance. Faithful to the reference,
    including its quirk of weighting by distance to the LAST chosen point
    only (true kmeans++ uses the min over all chosen); `rng` is an explicit
    numpy Generator instead of global state."""
    import numpy as np

    rng = np.random.default_rng() if rng is None else rng
    X = np.atleast_2d(np.asarray(X, dtype=float))
    XXT = X @ X.T
    D = -2.0 * XXT + np.diag(XXT)[:, None] + np.diag(XXT)[None, :]
    s = int(rng.permutation(X.shape[0])[0])
    chosen = [s]
    prob = D[s] / D[s].sum()
    for _ in range(m - 1):
        s = int(rng.multinomial(1, prob.ravel()).argmax())
        chosen.append(s)
        prob = D[s] / D[s].sum()
    return X[np.asarray(chosen)]


@pytree_dataclass
class SparseGPRegression:
    kern: Kernel = None
    likelihood_variance: jnp.ndarray = None
    Z: jnp.ndarray = None  # (M, D) inducing inputs — trainable
    X: jnp.ndarray = None
    Y: jnp.ndarray = None
    mask: jnp.ndarray = None
    normalizer: Standardize = None
    inference: str = static_field(default="vardtc")  # 'vardtc' | 'fitc' | 'dtc' | 'pep'
    # power-EP interpolation parameter (pep.py; alpha->1 FITC, alpha->0 VarDTC)
    pep_alpha: float = static_field(default=0.5)

    @classmethod
    def create(cls, X, Y, kernel=None, num_inducing=10, Z=None, noise_var=1.0,
               normalizer=False, inference="vardtc", max_points=None, seed=0):
        """GPy SparseGPRegression defaults (sparse_gp_regression.py): Z = random
        subset of X when not given."""
        import numpy as np

        X = jnp.atleast_2d(jnp.asarray(X, dtype=float))
        Y = jnp.asarray(Y, dtype=float)
        if Y.ndim == 1:
            Y = Y[:, None]
        n, d = X.shape
        if kernel is None:
            kernel = RBF.create(d)
        if Z is None:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(n)[:num_inducing]
            Z = jnp.asarray(np.asarray(X)[idx].copy())
        else:
            Z = jnp.atleast_2d(jnp.asarray(Z, dtype=float))
        norm = Standardize.fit(Y) if normalizer else None
        mask = None
        if max_points is not None:
            if max_points < n:
                raise ValueError(f"max_points={max_points} < n={n}")
            pad = max_points - n
            X = jnp.concatenate([X, jnp.zeros((pad, d), X.dtype)])
            Y = jnp.concatenate([Y, jnp.zeros((pad, Y.shape[1]), Y.dtype)])
            mask = (jnp.arange(max_points) < n).astype(X.dtype)
        return cls(
            kern=kernel,
            likelihood_variance=jnp.asarray(noise_var, dtype=float).reshape(()),
            Z=Z, X=X, Y=Y, mask=mask, normalizer=norm, inference=inference,
        )

    # ------------------------------------------------------------------ internals
    @property
    def num_data(self):
        return self.X.shape[0] if self.mask is None else jnp.sum(self.mask)

    def _normalized_Y(self):
        Yn = self.normalizer.normalize(self.Y) if self.normalizer is not None else self.Y
        if self.mask is not None:
            Yn = Yn * self.mask[:, None]
        return Yn

    def _factorize(self):
        """Common Lm / A factorization. Returns (Lm, A (M,N) = Lm^-1 Kmn, Kdiag, Yc).
        Padded columns of A are zeroed."""
        Yc = self._normalized_Y()
        Kmm = self.kern.K(self.Z)
        m = self.Z.shape[0]
        Kmm = Kmm + 1e-6 * jnp.mean(jnp.diagonal(Kmm)) * jnp.eye(m, dtype=Kmm.dtype)
        Lm, _, ok = linalg.jitchol(Kmm)
        Kmn = self.kern.K(self.Z, self.X)
        Kdiag = self.kern.Kdiag(self.X)
        if self.mask is not None:
            Kmn = Kmn * self.mask[None, :]
            Kdiag = Kdiag * self.mask
        A = linalg.solve_lower(Lm, Kmn)
        return Lm, A, Kdiag, Yc, ok

    def inference_state(self) -> SparsePosterior:
        sigma2 = self.likelihood_variance + config.noise_jitter
        Lm, A, Kdiag, Yc, ok = self._factorize()
        n = self.num_data
        m = self.Z.shape[0]
        p = Yc.shape[1]

        if self.inference in ("fitc", "pep"):
            # FITC: heteroscedastic diag  beta_n = 1/(sigma2 + Kdiag_n - Qnn_n).
            # PEP (GPy pep.py, Bui et al. 2017): the power-EP collapsed bound
            # interpolates FITC (alpha=1) and VarDTC (alpha->0): the diagonal
            # correction is scaled by alpha and a log-penalty term is added.
            qnn = jnp.sum(jnp.square(A), axis=0)
            g = jnp.maximum(Kdiag - qnn, 0.0)
            alpha_pep = 1.0 if self.inference == "fitc" else float(self.pep_alpha)
            lam = sigma2 + alpha_pep * g
            if self.mask is not None:
                lam = jnp.where(self.mask > 0, lam, 1.0)
            beta = 1.0 / lam
            Ab = A * beta[None, :]
            B = jnp.eye(m, dtype=A.dtype) + Ab @ A.T
            LB, _, okB = linalg.jitchol(B)
            Aby = Ab @ Yc
            c = linalg.solve_lower(LB, Aby)
            mask_term = self.mask if self.mask is not None else jnp.ones_like(beta)
            lml = (
                -0.5 * n * p * LOG_2_PI
                - 0.5 * p * jnp.sum(jnp.log(lam) * mask_term)
                - 0.5 * p * linalg.logdet_from_chol(LB)
                - 0.5 * jnp.sum(jnp.square(Yc) * beta[:, None])
                + 0.5 * jnp.sum(jnp.square(c))
            )
            if self.inference == "pep":
                # -(1-a)/(2a) sum log(1 + a g / sigma2)  (the PEP entropy penalty)
                lml = lml - 0.5 * (1.0 - alpha_pep) / alpha_pep * p * jnp.sum(
                    jnp.log1p(alpha_pep * g / sigma2) * mask_term
                )
            return SparsePosterior(Lm=Lm, LB=LB, c=c, lml=lml, ok=ok & okB)

        # VarDTC / DTC share the homoscedastic factorization
        B = jnp.eye(m, dtype=A.dtype) + (A @ A.T) / sigma2
        LB, _, okB = linalg.jitchol(B)
        Ay = A @ Yc  # (M, P)
        c = linalg.solve_lower(LB, Ay) / sigma2
        lml = (
            -0.5 * n * p * (LOG_2_PI + jnp.log(sigma2))
            - 0.5 * p * linalg.logdet_from_chol(LB)
            - 0.5 * jnp.sum(jnp.square(Yc)) / sigma2
            + 0.5 * jnp.sum(jnp.square(c))
        )
        if self.inference == "vardtc":
            # Titsias trace correction (var_dtc.py:66): -1/(2 sigma2)(tr Knn - tr Qnn)
            trace_term = jnp.sum(Kdiag) - jnp.sum(jnp.square(A))
            lml = lml - 0.5 * p * trace_term / sigma2
        return SparsePosterior(Lm=Lm, LB=LB, c=c, lml=lml, ok=ok & okB)

    def log_marginal_likelihood(self):
        return self.inference_state().lml

    # ------------------------------------------------------------------ prediction
    def _raw_predict(self, Xnew, full_cov=False, posterior: SparsePosterior | None = None):
        post = posterior if posterior is not None else self.inference_state()
        Xnew = jnp.atleast_2d(Xnew)
        Kms = self.kern.K(self.Z, Xnew)  # (M, S)
        tmp = linalg.solve_lower(post.Lm, Kms)  # Lm^-1 Kms
        tmp2 = linalg.solve_lower(post.LB, tmp)  # LB^-1 Lm^-1 Kms
        mu = tmp2.T @ post.c
        if full_cov:
            var = self.kern.K(Xnew) - tmp.T @ tmp + tmp2.T @ tmp2
            var = linalg.symmetrify(var)
        else:
            var = (
                self.kern.Kdiag(Xnew)
                - jnp.sum(jnp.square(tmp), axis=0)
                + jnp.sum(jnp.square(tmp2), axis=0)
            )
            var = jnp.clip(var, 1e-15, None)[:, None]
        return mu, var

    def predict(self, Xnew, full_cov=False, include_likelihood=True,
                posterior: SparsePosterior | None = None):
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, posterior=posterior)
        if include_likelihood:
            if full_cov:
                var = var + self.likelihood_variance * jnp.eye(var.shape[0], dtype=var.dtype)
            else:
                var = var + self.likelihood_variance
        if self.normalizer is not None:
            mu = self.normalizer.inverse_mean(mu)
            var = (self.normalizer.inverse_covariance(var) if full_cov
                   else self.normalizer.inverse_variance(var))
        return mu, var

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5),
                          posterior: SparsePosterior | None = None):
        """Gaussian predictive quantiles in percent (GPy gp.py:384 inherited
        by SparseGP). List of (M, P) arrays."""
        from jax.scipy.special import ndtri

        mu, var = self.predict(Xnew, full_cov=False, include_likelihood=True,
                               posterior=posterior)
        sd = jnp.sqrt(var)
        return [mu + ndtri(q / 100.0) * sd for q in quantiles]

    def predictive_gradients(self, Xnew, posterior: SparsePosterior | None = None):
        post = posterior if posterior is not None else self.inference_state()

        def mu_var(x):
            mu, var = self._raw_predict(x[None, :], full_cov=False, posterior=post)
            if self.normalizer is not None:
                mu = self.normalizer.inverse_mean(mu)
                var = self.normalizer.inverse_variance(var)
            return mu[0], var[0, 0]

        Xnew = jnp.atleast_2d(Xnew)
        dm = jax.vmap(lambda x: jax.jacfwd(lambda xx: mu_var(xx)[0])(x))(Xnew)
        dv = jax.vmap(lambda x: jax.jacfwd(lambda xx: mu_var(xx)[1])(x))(Xnew)
        return jnp.swapaxes(dm, 1, 2), dv

    def missing_data_lml(self, output_mask):
        """Missing-data VarDTC (GPy vardtc_md.py): multi-output Y where output p
        observes only rows with output_mask[:, p] == 1. Sum of per-output collapsed
        bounds sharing one Kmm factorization — the per-output loop is a vmap.

        output_mask: (N, P) in {0,1}; masked-out Y entries are ignored.
        """
        sigma2 = self.likelihood_variance + config.noise_jitter
        Lm, A, Kdiag, Yc, ok = self._factorize()
        m = self.Z.shape[0]
        mask_o = jnp.asarray(output_mask, dtype=A.dtype)
        if self.mask is not None:
            mask_o = mask_o * self.mask[:, None]

        def per_output(y_col, w):
            Aw = A * w[None, :]
            B = jnp.eye(m, dtype=A.dtype) + (Aw @ Aw.T) / sigma2
            LB, _, okB = linalg.jitchol(B)
            c = linalg.solve_lower(LB, Aw @ (y_col * w)) / sigma2
            n_p = jnp.sum(w)
            trace_term = jnp.sum(Kdiag * w) - jnp.sum(jnp.square(Aw))
            return (
                -0.5 * n_p * (LOG_2_PI + jnp.log(sigma2))
                - 0.5 * linalg.logdet_from_chol(LB)
                - 0.5 * jnp.sum(jnp.square(y_col * w)) / sigma2
                + 0.5 * jnp.sum(jnp.square(c))
                - 0.5 * trace_term / sigma2
            )

        vals = jax.vmap(per_output, in_axes=(1, 1))(Yc, mask_o)
        return jnp.sum(vals)

    def with_data(self, X, Y, max_points=None):
        new = SparseGPRegression.create(
            X, Y, kernel=self.kern, Z=self.Z, noise_var=self.likelihood_variance,
            normalizer=self.normalizer is not None, inference=self.inference,
            max_points=max_points,
        )
        # create() has no pep_alpha parameter — forward it so a PEP model keeps
        # optimizing the bound the user configured
        from ..utils.pytree import replace as _replace

        return _replace(new, pep_alpha=self.pep_alpha)
