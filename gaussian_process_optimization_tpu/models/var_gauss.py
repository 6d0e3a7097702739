"""KL variational Gaussian inference (Opper & Archambeau 2009).

Rebuild of ``GPy/GPy/inference/latent_function_inference/var_gauss.py`` (69 LoC):
q(f) = N(m, S) with the optimal structure m = K alpha, S = (K^-1 + diag(W))^-1;
ELBO = E_q[log p(y|f)] - KL(q || N(0, K)), expectations by Gauss-Hermite.

Accelerator-first: the free parameters (alpha, W) are optimized by the same jitted L-BFGS as
everything else; S's diagonal and the KL are computed from one Cholesky of
B = I + W^1/2 K W^1/2 (no N x N inverse materialized).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lbfgs, linalg
from ..utils.pytree import pytree_dataclass

LOG_2_PI = float(np.log(2 * np.pi))


def _posterior_terms(K, alpha, W):
    """(m, diag(S), KL) for q = N(K alpha, (K^-1 + diag(W))^-1)."""
    n = K.shape[0]
    eye = jnp.eye(n, dtype=K.dtype)
    sW = jnp.sqrt(jnp.maximum(W, 1e-12))
    B = eye + sW[:, None] * K * sW[None, :]
    L, _, ok = linalg.jitchol(B)
    m = K @ alpha
    # S = K - K sW B^-1 sW K  => diag via V = L^-1 sW K
    V = linalg.solve_lower(L, sW[:, None] * K)
    s_diag = jnp.clip(jnp.diagonal(K) - jnp.sum(jnp.square(V), 0), 1e-12, None)
    # KL(q || N(0,K)) = 0.5 [ alpha^T K alpha + tr(K^-1 S) - n + log|K| - log|S| ]
    #                 = 0.5 [ alpha^T m + tr(B^-1) - n + log|B| ]   (standard identity)
    Li = linalg.solve_lower(L, eye)
    tr_Binv = jnp.sum(jnp.square(Li))
    kl = 0.5 * (jnp.dot(alpha, m) + tr_Binv - n + linalg.logdet_from_chol(L))
    return m, s_diag, kl, ok


def vargauss_elbo(K, y, likelihood, alpha, W, gh_points=20):
    m, s_diag, kl, _ = _posterior_terms(K, alpha, W)
    gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
    gh_x = jnp.asarray(gh_x, dtype=K.dtype)
    gh_w = jnp.asarray(gh_w, dtype=K.dtype) / jnp.sqrt(jnp.pi)
    f = m[:, None] + jnp.sqrt(2.0 * s_diag)[:, None] * gh_x
    ell = jnp.sum(gh_w * likelihood.logpdf(f, y[:, None]))
    return ell - kl


@pytree_dataclass
class VarGaussPosterior:
    alpha: jnp.ndarray = None
    W: jnp.ndarray = None
    elbo: jnp.ndarray = None


def vargauss_inference(K, y, likelihood, maxiter=200):
    """Optimize (alpha, log W) by L-BFGS on -(ELBO). Returns VarGaussPosterior."""
    n = K.shape[0]

    def unpack(u):
        return u[:n], jnp.exp(u[n:])

    def loss(u):
        a, W = unpack(u)
        return -vargauss_elbo(K, y, likelihood, a, W)

    u0 = jnp.concatenate([jnp.zeros(n, dtype=K.dtype), jnp.zeros(n, dtype=K.dtype)])
    res = lbfgs.minimize(loss, u0, maxiter=maxiter)
    a, W = unpack(res.x)
    return VarGaussPosterior(alpha=a, W=W, elbo=-res.f)


def vargauss_predict(K_train, Ks, kdiag_s, post: VarGaussPosterior):
    """Latent predictive under q: mu* = Ks^T alpha; var* via the same B factor."""
    n = K_train.shape[0]
    eye = jnp.eye(n, dtype=K_train.dtype)
    sW = jnp.sqrt(jnp.maximum(post.W, 1e-12))
    B = eye + sW[:, None] * K_train * sW[None, :]
    L, _, _ = linalg.jitchol(B)
    mu = Ks.T @ post.alpha
    V = linalg.solve_lower(L, sW[:, None] * Ks)
    var = jnp.clip(kdiag_s - jnp.sum(jnp.square(V), 0), 1e-15, None)
    return mu, var
