"""Expectation propagation: dense (sequential + parallel) and sparse (EPDTC).

Rebuild of ``GPy/GPy/inference/latent_function_inference/expectation_propagation.py``
(622 LoC): ``EP`` (:253) — dense EP over a full K with per-site rank-1 posterior
updates (sequential, ``posteriorParams._update_rank1``) or parallel site updates;
``EPDTC`` (:443) — sparse EP on inducing points, whose converged sites feed the
heteroscedastic VarDTC collapsed bound (``var_dtc.py`` `precision=` path) plus the
``log_Z_tilde`` correction.

JAX-native structure:
- moment matching is vectorized through ``Likelihood.moments_match_ep`` (exact for
  probit/Gaussian, Gauss-Hermite in log space otherwise);
- the PARALLEL mode (default) refreshes all sites per sweep from one Cholesky —
  each sweep is a few batched O(n^3)/O(nm^2) ops;
- the SEQUENTIAL mode replicates the reference's site-by-site rank-1 updates
  (GPy ``_local_updates`` :337 with ``_update_rank1`` :103) as a ``lax.fori_loop``
  with a deterministic 0..n-1 order (the reference permutes randomly; both converge
  to the same fixed point, which the tests assert);
- fractional (eta) and damped (delta) updates follow ``EPBase`` (:188) semantics;
  convergence is GPy's ``_stop_criteria`` (:233): mean squared site diffs < epsilon.

The EP log marginal is GPy's ``_ep_marginal`` (:370) + ``_log_Z_tilde`` (:360)
with zero prior mean, evaluated from cavities recomputed at the converged
posterior (equal to the reference's last-sweep bookkeeping at convergence).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import linalg
from ..utils.pytree import pytree_dataclass

LOG_2_PI = 1.8378770664093453  # log(2*pi), host constant


@pytree_dataclass
class EPPosterior:
    mu: jnp.ndarray = None
    Sigma: jnp.ndarray = None
    tau_site: jnp.ndarray = None
    nu_site: jnp.ndarray = None
    lml: jnp.ndarray = None


@pytree_dataclass
class EPDTCPosterior:
    """Sparse-EP state in the Lm/LB form the sparse predict path consumes."""

    Lm: jnp.ndarray = None  # chol(Kmm)
    LB: jnp.ndarray = None  # chol(I + Ahat Ahat^T), Ahat = Lm^-1 Kmn sqrt(beta)
    c: jnp.ndarray = None  # LB^-1 Lm^-1 Kmn (beta * mu_tilde)
    tau_site: jnp.ndarray = None
    nu_site: jnp.ndarray = None
    lml: jnp.ndarray = None


def _norm_logcdf(z):
    return jax.scipy.stats.norm.logcdf(z)


_TAU_EPS = 2.220446049250313e-16  # np.finfo(float).eps, the reference's site floor


# --------------------------------------------------------------------------- dense EP


def _dense_posterior_from_sites(K, tau, nu):
    """GPy posteriorParams._recompute (:129): Sigma = K - K S^1/2 B^-1 S^1/2 K,
    mu = Sigma nu (zero prior mean), via B = I + S^1/2 K S^1/2."""
    n = K.shape[0]
    sW = jnp.sqrt(jnp.maximum(tau, _TAU_EPS))
    B = jnp.eye(n, dtype=K.dtype) + sW[:, None] * K * sW[None, :]
    L, _, ok = linalg.jitchol(B)
    V = linalg.solve_lower(L, sW[:, None] * K)
    Sigma = K - V.T @ V
    # alpha = nu - S^1/2 B^-1 S^1/2 K nu  == (K + S~^-1)^-1 mu~
    aux = linalg.cho_solve(L, (sW * (K @ nu))[:, None])[:, 0]
    alpha = nu - sW * aux
    mu = K @ alpha
    return mu, Sigma, L, alpha


def _site_deltas(lik, y, tau, nu, mu_post, sigma2_post, eta, delta):
    """Cavity + moment match + GPy site-delta form (cavityParams._update_i :27,
    gaussianApproximation._update_i :52). Returns (delta_tau, delta_nu, logZ_hat,
    tau_cav, v_cav) — all vectorized over sites."""
    sigma2 = jnp.maximum(sigma2_post, 1e-12)
    tau_cav = 1.0 / sigma2 - eta * tau
    v_cav = mu_post / sigma2 - eta * nu
    tau_cav = jnp.maximum(tau_cav, 1e-12)
    logZ, mu_hat, s2_hat = lik.moments_match_ep(y, tau_cav, v_cav)
    delta_tau = (delta / eta) * (1.0 / s2_hat - 1.0 / sigma2)
    delta_nu = (delta / eta) * (mu_hat / s2_hat - mu_post / sigma2)
    return delta_tau, delta_nu, logZ, tau_cav, v_cav


def ep_inference(K, y, lik, mode="parallel", eta=1.0, delta=None, max_sweeps=50,
                 epsilon=1e-6):
    """Dense EP (GPy EP.inference :253). mode 'parallel' (JAX-native, damped,
    default delta=0.5) or 'sequential' (reference parity: rank-1 posterior updates
    per site, default delta=1.0 as in EPBase)."""
    K = jnp.asarray(K)
    y = jnp.asarray(y).reshape(-1)
    n = K.shape[0]
    if delta is None:
        delta = 0.5 if mode == "parallel" else 1.0

    tau0 = jnp.zeros((n,), dtype=K.dtype)
    nu0 = jnp.zeros((n,), dtype=K.dtype)

    if mode == "parallel":

        def sweep(carry):
            tau, nu, _, _, it = carry
            mu, Sigma, _, _ = _dense_posterior_from_sites(K, tau, nu)
            d_tau, d_nu, _, _, _ = _site_deltas(
                lik, y, tau, nu, mu, jnp.diagonal(Sigma), eta, delta
            )
            tau_new = jnp.maximum(tau + d_tau, _TAU_EPS)
            nu_new = nu + d_nu
            return tau_new, nu_new, tau, nu, it + 1

    elif mode == "sequential":

        def site_update(i, state):
            tau, nu, mu, Sigma = state
            sigma2_i = jnp.maximum(Sigma[i, i], 1e-12)
            tau_cav = jnp.maximum(1.0 / sigma2_i - eta * tau[i], 1e-12)
            v_cav = mu[i] / sigma2_i - eta * nu[i]
            _, mu_hat, s2_hat = lik.moments_match_ep(
                y[i][None], tau_cav[None], v_cav[None]
            )
            mu_hat, s2_hat = mu_hat[0], s2_hat[0]
            d_tau = (delta / eta) * (1.0 / s2_hat - 1.0 / sigma2_i)
            d_nu = (delta / eta) * (mu_hat / s2_hat - mu[i] / sigma2_i)
            # positivity floor exactly as gaussianApproximation._update_i (:60-66)
            tau_new_i = tau[i] + d_tau
            d_tau = jnp.where(tau_new_i < _TAU_EPS, _TAU_EPS - tau[i], d_tau)
            tau = tau.at[i].set(jnp.maximum(tau_new_i, _TAU_EPS))
            nu = nu.at[i].add(d_nu)
            # rank-1 posterior update (posteriorParams._update_rank1 :103)
            si = Sigma[:, i]
            ci = d_tau / (1.0 + d_tau * si[i])
            mu = mu - (ci * (mu[i] + si[i] * d_nu) - d_nu) * si
            Sigma = Sigma - ci * si[:, None] * si[None, :]
            return tau, nu, mu, Sigma

        def sweep(carry):
            tau, nu, _, _, it = carry
            mu, Sigma, _, _ = _dense_posterior_from_sites(K, tau, nu)
            tau_new, nu_new, _, _ = lax.fori_loop(
                0, n, site_update, (tau, nu, mu, Sigma)
            )
            return tau_new, nu_new, tau, nu, it + 1

    else:
        raise ValueError(f"unknown EP mode {mode!r}")

    def cond(carry):
        tau, nu, tau_old, nu_old, it = carry
        tau_diff = jnp.mean(jnp.square(tau - tau_old))
        nu_diff = jnp.mean(jnp.square(nu - nu_old))
        converged = (it > 1) & (tau_diff < epsilon) & (nu_diff < epsilon)
        return (~converged) & (it < max_sweeps)

    # Sigma(init) = K + 1e-7 I, mu = 0 (GPy _init_approximations :321-327)
    init = sweep((tau0, nu0, jnp.full((n,), jnp.inf, K.dtype), nu0, jnp.int32(0)))
    tau, nu, _, _, _ = lax.while_loop(cond, lambda c: sweep(c), init)

    mu, Sigma, L, alpha = _dense_posterior_from_sites(K, tau, nu)
    lml = _dense_ep_lml(lik, y, K, tau, nu, mu, Sigma, L, eta)
    return EPPosterior(mu=mu, Sigma=Sigma, tau_site=tau, nu_site=nu, lml=lml)


def _dense_ep_lml(lik, y, K, tau, nu, mu, Sigma, L, eta):
    """GPy _ep_marginal (:370) + _log_Z_tilde (:360), zero prior mean."""
    sigma2 = jnp.maximum(jnp.diagonal(Sigma), 1e-12)
    tau_cav = jnp.maximum(1.0 / sigma2 - eta * tau, 1e-12)
    v_cav = mu / sigma2 - eta * nu
    logZ_hat, _, _ = lik.moments_match_ep(y, tau_cav, v_cav)

    Z_tilde = jnp.sum(
        logZ_hat
        + 0.5 * LOG_2_PI
        + 0.5 * jnp.log1p(tau / tau_cav)
        - 0.5 * jnp.square(nu) / (tau_cav + tau)
        + 0.5 * (v_cav * ((tau / tau_cav) * v_cav - 2.0 * nu) / (tau_cav + tau))
    )
    B_logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    n = K.shape[0]
    gauss = 0.5 * (-n * LOG_2_PI - B_logdet + jnp.sum(nu * (Sigma @ nu)))
    return gauss + Z_tilde


def ep_probit_inference(K, y, sweeps=30, damping=0.5, jitter=1e-8, mode="parallel"):
    """Probit-classification convenience wrapper (kept for round-1 API parity)."""
    from .likelihoods import Bernoulli

    return ep_inference(
        K, y, Bernoulli(), mode=mode, delta=damping, max_sweeps=sweeps, epsilon=0.0
        if mode == "parallel" else 1e-10,
    )


def ep_predict(K_train, Ks, kdiag_s, post: EPPosterior):
    """Predictive latent mean/var given EP sites (GPML 3.60-3.61)."""
    n = K_train.shape[0]
    eye = jnp.eye(n, dtype=K_train.dtype)
    sW = jnp.sqrt(jnp.maximum(post.tau_site, _TAU_EPS))
    B = eye + sW[:, None] * K_train * sW[None, :]
    L, _, _ = linalg.jitchol(B)
    z = sW * linalg.cho_solve(L, (sW * (K_train @ post.nu_site))[:, None])[:, 0]
    mu = Ks.T @ (post.nu_site - z)
    V = linalg.solve_lower(L, sW[:, None] * Ks)
    var = jnp.clip(kdiag_s - jnp.sum(jnp.square(V), 0), 1e-15, None)
    return mu, var


# --------------------------------------------------------------------------- EPDTC


def _dtc_posterior_from_sites(Lm, Kmn, tau, nu):
    """GPy posteriorParamsDTC._recompute (:175): Sigma = Kmn^T (Kmm + Kmn S Knm)^-1
    Kmn, mu = Sigma nu. Returns (mu, Sigma_diag, V) with V = L^-1 Kmn,
    L = chol(LLT0 + Kmn diag(tau) Knm)."""
    LLT = Lm @ Lm.T + (Kmn * tau[None, :]) @ Kmn.T
    L, _, _ = linalg.jitchol(LLT)
    V = linalg.solve_lower(L, Kmn)  # (m, n)
    Sigma_diag = jnp.maximum(jnp.sum(V * V, axis=0), _TAU_EPS)
    mu = V.T @ (V @ nu)
    return mu, Sigma_diag, V, L


def epdtc_inference(Kmm, Kmn, Kdiag, y, lik, mode="parallel", eta=1.0, delta=None,
                    max_sweeps=50, epsilon=1e-6, psi2n=None, sites=None):
    """Sparse EP on inducing points (GPy EPDTC :443).

    Runs EP sweeps on the DTC posterior (Qnn = Knm Kmm^-1 Kmn), then evaluates the
    heteroscedastic VarDTC collapsed bound at pseudo-targets mu_tilde = nu/tau with
    per-site precision beta = tau (EPDTC.inference :457-481 feeding
    VarDTC.inference with precision=tau), plus the log_Z_tilde correction (:521).

    Uncertain inputs (SparseGPClassificationUncertainInput,
    sparse_gp_classification.py:103): pass Kmn = psi1.T, Kdiag = per-point psi0,
    and psi2n = the per-point (N, M, M) psi2 statistics. The EP sweeps keep the
    DTC posterior built from psi1 (exactly the reference: EPDTC.inference :460
    sets Kmn = psi1.T); the final bound replaces Knm beta Kmn with
    sum_n beta_n psi2_n (var_dtc.py uncertain-input het branch).

    `sites=(tau, nu)`: skip the EP sweeps and evaluate the bound at FIXED site
    parameters — the hyperparameter half of the reference's alternated EP
    evidence maximization (EPBase ep_mode='alternated', expectation_propagation
    .py:188): the sweep while_loop is not reverse-differentiable, but at the
    EP fixed point the site-fixed gradient equals the total derivative.
    """
    Kmm = jnp.asarray(Kmm)
    Kmn = jnp.asarray(Kmn)
    Kdiag = jnp.asarray(Kdiag).reshape(-1)
    y = jnp.asarray(y).reshape(-1)
    n = Kmn.shape[1]
    if delta is None:
        delta = 0.5 if mode == "parallel" else 1.0

    Lm, _, _ = linalg.jitchol(Kmm)
    tau0 = jnp.zeros((n,), dtype=Kmm.dtype)
    nu0 = jnp.zeros((n,), dtype=Kmm.dtype)

    if mode == "parallel":

        def sweep(carry):
            tau, nu, _, _, it = carry
            mu, Sigma_diag, _, _ = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
            d_tau, d_nu, _, _, _ = _site_deltas(
                lik, y, tau, nu, mu, Sigma_diag, eta, delta
            )
            tau_new = jnp.maximum(tau + d_tau, _TAU_EPS)
            nu_new = nu + d_nu
            return tau_new, nu_new, tau, nu, it + 1

    elif mode == "sequential":

        def site_update(i, state):
            # reference: posteriorParamsDTC._update_rank1 (:149) — DSYR on LLT,
            # re-factorize, refresh Sigma_diag/mu. O(m^3 + n m^2) per site.
            tau, nu, mu, Sigma_diag, LLT = state
            sigma2_i = jnp.maximum(Sigma_diag[i], 1e-12)
            tau_cav = jnp.maximum(1.0 / sigma2_i - eta * tau[i], 1e-12)
            v_cav = mu[i] / sigma2_i - eta * nu[i]
            _, mu_hat, s2_hat = lik.moments_match_ep(
                y[i][None], tau_cav[None], v_cav[None]
            )
            mu_hat, s2_hat = mu_hat[0], s2_hat[0]
            d_tau = (delta / eta) * (1.0 / s2_hat - 1.0 / sigma2_i)
            d_nu = (delta / eta) * (mu_hat / s2_hat - mu[i] / sigma2_i)
            tau_new_i = tau[i] + d_tau
            d_tau = jnp.where(tau_new_i < _TAU_EPS, _TAU_EPS - tau[i], d_tau)
            tau = tau.at[i].set(jnp.maximum(tau_new_i, _TAU_EPS))
            nu = nu.at[i].add(d_nu)
            ki = Kmn[:, i]
            LLT = LLT + d_tau * ki[:, None] * ki[None, :]
            L, _, _ = linalg.jitchol(LLT)
            V = linalg.solve_lower(L, Kmn)
            Sigma_diag = jnp.maximum(jnp.sum(V * V, axis=0), _TAU_EPS)
            si = V.T @ V[:, i]  # (V^T V)[:, i]
            mu = mu + (d_nu - d_tau * mu[i]) * si
            return tau, nu, mu, Sigma_diag, LLT

        def sweep(carry):
            tau, nu, _, _, it = carry
            mu, Sigma_diag, _, L = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
            LLT = L @ L.T
            tau_new, nu_new, _, _, _ = lax.fori_loop(
                0, n, site_update, (tau, nu, mu, Sigma_diag, LLT)
            )
            return tau_new, nu_new, tau, nu, it + 1

    else:
        raise ValueError(f"unknown EP mode {mode!r}")

    def cond(carry):
        tau, nu, tau_old, nu_old, it = carry
        tau_diff = jnp.mean(jnp.square(tau - tau_old))
        nu_diff = jnp.mean(jnp.square(nu - nu_old))
        converged = (it > 1) & (tau_diff < epsilon) & (nu_diff < epsilon)
        return (~converged) & (it < max_sweeps)

    if sites is not None:
        tau, nu = jnp.asarray(sites[0]).reshape(-1), jnp.asarray(sites[1]).reshape(-1)
    else:
        init = sweep((tau0, nu0, jnp.full((n,), jnp.inf, Kmm.dtype), nu0,
                      jnp.int32(0)))
        tau, nu, _, _, _ = lax.while_loop(cond, lambda c: sweep(c), init)

    # ---- heteroscedastic VarDTC collapsed bound at the EP pseudo-data ----
    mu_post, Sigma_diag, _, _ = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
    tau_safe = jnp.maximum(tau, _TAU_EPS)
    mu_tilde = nu / tau_safe
    beta = tau_safe

    # log_Z_tilde (EPDTC._log_Z_tilde :521), cavities at the converged posterior
    sigma2 = jnp.maximum(Sigma_diag, 1e-12)
    tau_cav = jnp.maximum(1.0 / sigma2 - eta * tau, 1e-12)
    v_cav = mu_post / sigma2 - eta * nu
    logZ_hat, _, _ = lik.moments_match_ep(y, tau_cav, v_cav)
    mu_cav = v_cav / tau_cav
    s2_sum = 1.0 / tau_cav + 1.0 / tau_safe
    Z_tilde = jnp.sum(
        logZ_hat + 0.5 * LOG_2_PI + 0.5 * jnp.log(s2_sum)
        + 0.5 * jnp.square(mu_cav - mu_tilde) / s2_sum
    )

    # VarDTC with heteroscedastic precision (var_dtc.py:266-277, het branch)
    m = Kmm.shape[0]
    if psi2n is None:
        sqb = jnp.sqrt(beta)
        Ahat = linalg.solve_lower(Lm, Kmn * sqb[None, :])
        A = Ahat @ Ahat.T
    else:
        # uncertain inputs: E_q[Kmn beta Knm] = sum_n beta_n psi2_n
        P = jnp.einsum("n,nij->ij", beta, jnp.asarray(psi2n))
        A = linalg.solve_lower(Lm, linalg.solve_lower(Lm, P).T).T
    B = jnp.eye(m, dtype=Kmm.dtype) + A
    LB, _, _ = linalg.jitchol(B)
    tmp = linalg.solve_lower(Lm, Kmn)  # Lm^-1 Kmn
    c = linalg.solve_lower(LB, tmp @ (beta * mu_tilde))
    data_fit = jnp.sum(jnp.square(c))
    lml = (
        -0.5 * n * LOG_2_PI
        + 0.5 * jnp.sum(jnp.log(beta))
        - 0.5 * jnp.sum(beta * jnp.square(mu_tilde))
        - 0.5 * (jnp.sum(beta * Kdiag) - jnp.trace(A))
        - jnp.sum(jnp.log(jnp.diagonal(LB)))
        + 0.5 * data_fit
        + Z_tilde
    )
    return EPDTCPosterior(Lm=Lm, LB=LB, c=c[:, None], tau_site=tau, nu_site=nu,
                          lml=lml)


def epdtc_predict(Lm, LB, c, Kms, kdiag_s):
    """Sparse-EP predictive latent mean/var — same Lm/LB algebra as the Gaussian
    sparse path (models/sparse.py _raw_predict)."""
    tmp = linalg.solve_lower(Lm, Kms)
    tmp2 = linalg.solve_lower(LB, tmp)
    mu = (tmp2.T @ c)[:, 0]
    var = jnp.clip(
        kdiag_s - jnp.sum(jnp.square(tmp), 0) + jnp.sum(jnp.square(tmp2), 0),
        1e-15, None,
    )
    return mu, var
