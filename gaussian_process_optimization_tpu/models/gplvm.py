"""GPLVM family (GPy/GPy/models/: gplvm.py, bayesian_gplvm.py; psi-statistics in
GPy/GPy/kern/src/psi_comp/).

- GPLVM: a GP whose inputs X are latent and trained by maximum likelihood. In this
  functional framework that is literally the exact GP with the X leaf unfrozen in
  the packer — no special machinery.
- Bayesian GPLVM: variational q(X) = N(mu, diag(S)) with the RBF closed-form psi
  statistics (PSICOMP_RBF: psi0 = N sigma^2; psi1/psi2 Gaussian expectations) and
  the uncertain-input VarDTC collapsed bound (Titsias & Lawrence 2010).

Notes: psi1/psi2 are dense (N, M)/(M, M) tensors built from elementwise ops and
one big contraction — matmul/elementwise friendly; the bound reuses the sparse Lm/LB
factorization of models/sparse.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.pytree import pytree_dataclass
from .gp import LOG_2_PI, GPRegression


# --------------------------------------------------------------------- GPLVM
def make_gplvm(Y, input_dim, kernel=None, init="pca", seed=0):
    """Point-estimate GPLVM = GPRegression with trainable X (gplvm.py)."""
    Y = np.asarray(Y, dtype=float)
    n = Y.shape[0]
    if init == "pca":
        Yc = Y - Y.mean(0)
        _, _, Vt = np.linalg.svd(Yc, full_matrices=False)
        X0 = Yc @ Vt[:input_dim].T
        X0 /= X0.std(0) + 1e-9
    else:
        X0 = np.random.default_rng(seed).standard_normal((n, input_dim))
    kernel = kernel or RBF.create(input_dim, ARD=True)
    return GPRegression.create(X0, Y, kernel=kernel, noise_var=0.1)


def fit_gplvm(model, maxiter=500, key=None, priors=None):
    """Optimize hyperparameters AND the latent X (packer with X unfrozen).

    ``priors``: field-name -> Prior dict (models/fit.py make_objective). Pass
    ``{"X": DGPLVMPrior(lbl=...)}`` for the discriminative GPLVM of
    GPy priors.py:535 (the prior's lnpdf sees the (N, Q) latent leaf)."""
    from ..ops import lbfgs
    from .fit import make_objective
    from .parameters import DATA_NAMES, make_packer
    from ..utils.packing import Packer
    from ..utils.transforms import IDENTITY, POSITIVE
    from .parameters import POSITIVE_NAMES, _leaf_names

    names = _leaf_names(model)
    transforms, fixed = [], []
    for nm in names:
        transforms.append(POSITIVE if nm in POSITIVE_NAMES else IDENTITY)
        fixed.append(nm in (DATA_NAMES - {"X"}))  # X trainable; Y etc. fixed
    packer = Packer(model, transforms=transforms, fixed=fixed)
    obj = make_objective(packer, priors=priors)
    u0 = packer.pack(model)
    res = lbfgs.minimize(lambda u: obj(u, model), u0, maxiter=maxiter)
    return packer.unpack(res.x, reference=model), res


# ------------------------------------------------------- RBF psi statistics
def rbf_psi_stats_n(kern, Z, mu, S):
    """Like rbf_psi_stats but returns the PER-POINT psi2 (N, M, M) un-summed
    (GPy kern.psi2n) — needed by predictive variances that weight per-point
    (e.g. the LVMOGP row side, vardtc_svi_multiout.py _raw_predict)."""
    psi0, psi1, psi2n = _rbf_psi_core(kern, Z, mu, S)
    return psi0, psi1, psi2n


def rbf_psi_stats(kern, Z, mu, S):
    psi0, psi1, psi2n = _rbf_psi_core(kern, Z, mu, S)
    return psi0, psi1, jnp.sum(psi2n, axis=0)


def _rbf_psi_core(kern, Z, mu, S):
    """Closed-form Gaussian expectations of the RBF kernel
    (GPy kern/src/psi_comp/rbf_psi_comp.py):
      psi0 = sum_n <k(x_n, x_n)>         = N * variance
      psi1[n,m] = <k(x_n, z_m)>_q(x_n)
      psi2[m,m'] = sum_n <k(x_n,z_m) k(x_n,z_m')>_q(x_n)
    q(x_n) = N(mu_n, diag(S_n)); ARD lengthscales supported."""
    var = kern.variance
    ls2 = jnp.square(kern.lengthscale)  # (D,) or ()
    D = mu.shape[1]
    ls2 = jnp.broadcast_to(ls2, (D,))

    psi0 = mu.shape[0] * var

    # psi1
    denom1 = S + ls2[None, :]  # (N, D)
    dist1 = jnp.square(mu[:, None, :] - Z[None, :, :]) / denom1[:, None, :]
    logdet1 = jnp.sum(jnp.log1p(S / ls2[None, :]), axis=1)  # (N,)
    psi1 = var * jnp.exp(-0.5 * jnp.sum(dist1, axis=2) - 0.5 * logdet1[:, None])

    # psi2
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])  # (M, M, D)
    dZ2 = jnp.square(Z[:, None, :] - Z[None, :, :])  # (M, M, D)
    denom2 = 2.0 * S + ls2[None, :]  # (N, D)
    logdet2 = jnp.sum(jnp.log1p(2.0 * S / ls2[None, :]), axis=1)  # (N,)
    # exp(-dZ2/(4 ls2)) is n-independent
    cross = jnp.exp(-0.25 * jnp.sum(dZ2 / ls2, axis=2))  # (M, M)
    # sum_n exp(-(mu_n - zbar)^2 / denom2_n) / sqrt(prod(1+2S/ls2))
    diff = mu[:, None, None, :] - Zbar[None, :, :, :]  # (N, M, M, D)
    quad = jnp.sum(jnp.square(diff) / denom2[:, None, None, :], axis=3)
    psi2 = jnp.square(var) * cross[None, :, :] * jnp.exp(
        -quad - 0.5 * logdet2[:, None, None]
    )
    return psi0, psi1, psi2  # (N, M, M) per-point; callers sum as needed


# ------------------------------------------------------- Bayesian GPLVM bound
@pytree_dataclass
class BayesianGPLVM:
    """Variational GPLVM: q(X) = N(mu, diag(S)), RBF kernel, inducing points Z
    (bayesian_gplvm.py + var_dtc psi-statistics path)."""

    kern: object = None  # RBF (psi statistics implemented for RBF)
    likelihood_variance: jnp.ndarray = None
    Z: jnp.ndarray = None
    q_mu: jnp.ndarray = None  # (N, Q) variational means  (trainable)
    q_S: jnp.ndarray = None  # (N, Q) variational variances (positive, trainable)
    Y: jnp.ndarray = None

    @classmethod
    def create(cls, Y, input_dim, num_inducing=10, kernel=None, noise_var=0.1, seed=0):
        Y = np.asarray(Y, dtype=float)
        n = Y.shape[0]
        Yc = Y - Y.mean(0)
        _, _, Vt = np.linalg.svd(Yc, full_matrices=False)
        mu0 = Yc @ Vt[:input_dim].T
        mu0 /= mu0.std(0) + 1e-9
        rng = np.random.default_rng(seed)
        Z0 = mu0[rng.permutation(n)[:num_inducing]].copy()
        kernel = kernel or RBF.create(input_dim, ARD=True)
        return cls(
            kern=kernel,
            likelihood_variance=jnp.asarray(noise_var, dtype=float).reshape(()),
            Z=jnp.asarray(Z0),
            q_mu=jnp.asarray(mu0),
            q_S=0.5 * jnp.ones((n, input_dim)),
            Y=jnp.asarray(Yc),
        )

    def elbo(self):
        """Uncertain-input collapsed bound (Titsias & Lawrence 2010; GPy var_dtc
        with psi statistics) + KL(q(X) || N(0, I))."""
        bound = uncertain_input_bound(
            self.kern, self.Z, self.likelihood_variance, self.Y, self.q_mu, self.q_S
        )
        return bound - gaussian_kl(self.q_mu, self.q_S)

    def log_marginal_likelihood(self):
        return self.elbo()

    def posterior_u(self):
        """(wv, Wi): the collapsed bound's implied q(u) in woodbury form
        (GPy var_dtc.py:199-212 — wv = beta Lm^-T B^-1 Lm^-1 psi1^T Y,
        Wi = Lm^-T (I - B^-1) Lm^-1). Shared by predict and infer_newX."""
        sigma2 = jnp.maximum(self.likelihood_variance, 1e-6)
        m = self.Z.shape[0]
        _, psi1, psi2 = rbf_psi_stats(self.kern, self.Z, self.q_mu, self.q_S)
        Kmm = self.kern.K(self.Z) + 1e-6 * jnp.eye(m)
        Lm, _, _ = linalg.jitchol(Kmm)
        A = linalg.solve_lower(Lm, linalg.solve_lower(Lm, psi2).T).T / sigma2
        LB, _, _ = linalg.jitchol(jnp.eye(m) + A)
        wv = linalg.solve_lower_t(
            Lm, linalg.cho_solve(LB, linalg.solve_lower(Lm, psi1.T @ self.Y))
        ) / sigma2
        Wi = linalg.backsub_both_sides(Lm, jnp.eye(m) - linalg.dpotri(LB))
        return wv, Wi

    def predict(self, Xnew, full_cov=False, include_likelihood=True,
                posterior=None):
        """Decode latent points back to data space (GPy BayesianGPLVM inherits
        SparseGP.predict, sparse_gp.py:14; sparse posterior predictive through
        the collapsed q(u)). ``posterior``: optional cached ``posterior_u()``."""
        Xnew = jnp.atleast_2d(Xnew)
        wv, Wi = self.posterior_u() if posterior is None else posterior
        Ks = self.kern.K(Xnew, self.Z)  # (M*, M)
        mu = Ks @ wv
        if full_cov:
            var = self.kern.K(Xnew) - Ks @ Wi @ Ks.T
            if include_likelihood:
                var = var + self.likelihood_variance * jnp.eye(Xnew.shape[0])
        else:
            var = self.kern.Kdiag(Xnew) - jnp.sum(Ks * (Ks @ Wi), axis=1)
            var = jnp.maximum(var, 1e-12)[:, None]
            if include_likelihood:
                var = var + self.likelihood_variance
        return mu, var


def uncertain_input_bound(kern, Z, noise_var, Y, q_mu, q_S):
    """The collapsed variational bound for ONE view given q(X) = N(q_mu, diag(q_S))
    (GPy var_dtc.py uncertain-inputs path; shared by BayesianGPLVM and MRD)."""
    psi0, psi1, psi2 = rbf_psi_stats(kern, Z, q_mu, q_S)
    return collapsed_bound_from_psi(kern, Z, noise_var, Y, psi0, psi1, psi2)


def collapsed_bound_from_psi(kern, Z, noise_var, Y, psi0, psi1, psi2):
    """Collapsed uncertain-input bound given precomputed psi statistics (shared
    with the spike-and-slab GPLVM, which swaps in the SSRBF psi stats)."""
    sigma2 = noise_var + config.noise_jitter
    n, p = Y.shape
    m = Z.shape[0]
    Kmm = kern.K(Z) + 1e-6 * jnp.eye(m)
    Lm, _, _ = linalg.jitchol(Kmm)
    # A = Lm^-1 psi2 Lm^-T / sigma2
    tmp = linalg.solve_lower(Lm, psi2)
    A = linalg.solve_lower(Lm, tmp.T).T / sigma2
    B = jnp.eye(m) + A
    LB, _, _ = linalg.jitchol(B)
    # c = LB^-1 Lm^-1 psi1^T Y / sigma2
    Py = psi1.T @ Y
    c = linalg.solve_lower(LB, linalg.solve_lower(Lm, Py)) / sigma2
    return (
        -0.5 * n * p * (LOG_2_PI + jnp.log(sigma2))
        - 0.5 * p * linalg.logdet_from_chol(LB)
        - 0.5 * jnp.sum(jnp.square(Y)) / sigma2
        + 0.5 * jnp.sum(jnp.square(c))
        - 0.5 * p / sigma2 * (psi0 - jnp.trace(A) * sigma2)
    )


def gaussian_kl(q_mu, q_S):
    """KL(N(q_mu, diag(q_S)) || N(0, I))."""
    return 0.5 * jnp.sum(jnp.square(q_mu) + q_S - jnp.log(q_S) - 1.0)
