"""EPMGP: EP approximation of p_min over a joint Gaussian (GPyOpt/util/epmgp.py,
itself the RoBO port of Cunningham/Hennig/Lacoste-Julien "Gaussian probabilities
and expectation propagation", arXiv 2011).

``joint_min(mu, Sigma)`` returns log p(x_k == argmin f) for each of the D points of
a joint Gaussian belief N(mu, Sigma): for every k it runs EP over the D-1 linear
truncation factors 1[f_k <= f_l] (``min_faktor`` / ``lt_factor`` in the reference,
epmgp.py:124-287) and normalizes across k.

JAX-native structure: the per-k EP is a ``lax.while_loop`` of ``lax.fori_loop``
rank-1 sweeps (inherently sequential, matching the reference), but all D factor
problems run batched under ``vmap`` — one jitted program instead of a Python loop
of 50xD numpy iterations. All reference branch points (z < -6 failure, z > 6
factor removal) become masked selects.

Documented deviation: the reference's final derivative renormalization uses
``Zij = Zm.T * Zm`` (elementwise — a Matlab-translation artifact); the
mathematically correct second-derivative correction is the OUTER product
Zm Zm^T, which is what we compute (validated against finite differences in
tests/test_epmgp.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

SQ2 = 1.4142135623730951
EPS = 1.1920929e-07  # float32 eps, the reference's message floor (epmgp.py:47)
L2P = 1.8378770664093453  # log(2*pi)


def _log_relative_gauss(z):
    """(e, logPhi, flag): e = N(z)/Phi(z); flag -1 => numerical failure (z<-6),
    +1 => factor inactive (z>6), 0 => regular (epmgp.py:268-280)."""
    logphi = -0.5 * (z * z + L2P)
    logPhi = jax.scipy.stats.norm.logcdf(z)
    e = jnp.exp(logphi - logPhi)
    flag = jnp.where(z < -6.0, -1, jnp.where(z > 6.0, 1, 0))
    e = jnp.where(flag == 0, e, jnp.where(flag == 1, 0.0, 1.0))
    logPhi = jnp.where(flag == 0, logPhi, jnp.where(flag == 1, 0.0, -1.0e12))
    return e, logPhi, flag


def _lt_factor(s, l, M, V, mp, p, gamma):
    """One EP update of the truncation factor 1[f_s <= f_l] (epmgp.py:215-266).

    Returns (Mnew, Vnew, pnew, mpnew, logS, d, failed): d is the convergence
    increment; failed flags the reference's NaN/z<-6 abort.
    """
    cVc = (V[l, l] - 2.0 * V[s, l] + V[s, s]) / 2.0
    Vc = (V[:, l] - V[:, s]) / SQ2
    cM = (M[l] - M[s]) / SQ2
    cVnic = jnp.maximum(cVc / (1.0 - p * cVc), 0.0)
    cmni = cM + cVnic * (p * cM - mp)
    z = cmni / jnp.sqrt(cVnic + 1e-25)
    z = jnp.where(jnp.isnan(z), -jnp.inf, z)
    e, lP, flag = _log_relative_gauss(z)

    # --- regular branch (flag == 0) ---
    cVnic_safe = jnp.maximum(cVnic, 1e-25)
    alpha = e / jnp.sqrt(cVnic_safe)
    beta = alpha * (alpha * cVnic + cmni)
    r = beta / jnp.maximum(1.0 - beta, 1e-25)
    pnew0 = r / cVnic_safe
    mpnew0 = r * (alpha + cmni / cVnic_safe) + alpha
    dp0 = jnp.maximum(-p + EPS, gamma * (pnew0 - p))
    dmp0 = jnp.maximum(-mp + EPS, gamma * (mpnew0 - mp))
    logS0 = (
        lP
        - 0.5 * (jnp.log(jnp.maximum(beta, 1e-300))
                 - jnp.log(jnp.maximum(p + dp0, 1e-300))
                 - jnp.log(cVnic_safe))
        + (alpha * alpha) / (2.0 * jnp.maximum(beta, 1e-300)) * cVnic
    )

    # --- inactive branch (flag == 1): remove the message ---
    dp1 = -p
    dmp1 = -mp

    regular = flag == 0
    inactive = flag == 1
    failed = flag == -1

    dp = jnp.where(regular, dp0, jnp.where(inactive, dp1, 0.0))
    dmp = jnp.where(regular, dmp0, jnp.where(inactive, dmp1, 0.0))
    d = jnp.where(regular, jnp.maximum(dmp, dp), jnp.where(inactive, 0.0, jnp.nan))
    pnew = p + dp
    mpnew = mp + dmp
    logS = jnp.where(regular, logS0, 0.0)

    denom = 1.0 + dp * cVc
    Vnew = V - (dp / denom) * (Vc[:, None] * Vc[None, :])
    Mnew = M + ((dmp - cM * dp) / denom) * Vc
    Vnew = jnp.where(failed, V, Vnew)
    Mnew = jnp.where(failed, M, Mnew)
    failed = failed | jnp.any(jnp.isnan(Vnew))
    return Mnew, Vnew, pnew, mpnew, logS, d, failed


def _min_factor(Mu, Sigma, k, gamma=1.0, max_sweeps=50, conv_tol=1e-3):
    """EP for log P(f_k <= f_l for all l != k) under N(Mu, Sigma) plus the
    derivatives of that logZ w.r.t. Mu and Sigma (epmgp.py:124-213).

    Returns (logZ, dlogZdMu (D,), dlogZdMudMu (D,D), dlogZdSigma packed
    lower-triangular row-major (D(D+1)/2,)).
    """
    D = Mu.shape[0]
    # sites i = 0..D-2 correspond to l = i + (i >= k)
    iidx = jnp.arange(D - 1)
    lidx = iidx + (iidx >= k)

    def site(i, state):
        M, V, P, MP, logS, diff, failed = state
        l = lidx[i]
        Mn, Vn, pn, mpn, lSn, d, fail_i = _lt_factor(k, l, M, V, MP[i], P[i], gamma)
        d = jnp.where(jnp.isnan(d), 0.0, d)
        # once failed, freeze everything (the reference breaks out of the loop)
        keep = ~failed
        M = jnp.where(keep, Mn, M)
        V = jnp.where(keep, Vn, V)
        P = P.at[i].set(jnp.where(keep, pn, P[i]))
        MP = MP.at[i].set(jnp.where(keep, mpn, MP[i]))
        logS = logS.at[i].set(jnp.where(keep, lSn, logS[i]))
        diff = diff + jnp.where(keep, jnp.abs(d), 0.0)
        failed = failed | fail_i
        return M, V, P, MP, logS, diff, failed

    def sweep(carry):
        M, V, P, MP, logS, _, failed, it = carry
        M, V, P, MP, logS, diff, failed = lax.fori_loop(
            0, D - 1, site, (M, V, P, MP, logS, jnp.asarray(0.0, Mu.dtype), failed)
        )
        return M, V, P, MP, logS, diff, failed, it + 1

    def cond(carry):
        *_, diff, failed, it = carry
        return (~failed) & (jnp.abs(diff) >= conv_tol) & (it < max_sweeps)

    z = jnp.zeros((D - 1,), Mu.dtype)
    init = sweep((Mu, Sigma, z, z, z, jnp.asarray(jnp.inf, Mu.dtype),
                  jnp.asarray(False), jnp.int32(0)))
    M, V, P, MP, logS, _, failed, _ = lax.while_loop(cond, sweep, init)

    # ---- assemble logZ (epmgp.py:168-196) ----
    # C: identity/sqrt(2) with row k = -1/sqrt(2), column k removed
    eye = jnp.eye(D, dtype=Mu.dtype) / SQ2
    row_is_k = (jnp.arange(D) == k)[:, None]
    Cfull = jnp.where(row_is_k, -1.0 / SQ2, eye)
    C = jnp.take(Cfull, lidx, axis=1)  # (D, D-1)

    R = C * jnp.sqrt(jnp.maximum(P, 0.0))[None, :]
    r = C @ MP  # (D,)
    mpm = jnp.sum(jnp.where(MP != 0.0, MP * MP / jnp.maximum(P, 1e-300), 0.0))
    s_sum = jnp.sum(logS)
    IRSR = jnp.eye(D - 1, dtype=Mu.dtype) + R.T @ Sigma @ R
    rSr = r @ (Sigma @ r)
    A = R @ jnp.linalg.solve(IRSR, R.T)
    A = 0.5 * (A + A.T)
    b = Mu + Sigma @ r
    Ab = A @ b
    sign, logdet = jnp.linalg.slogdet(IRSR)
    logZ = 0.5 * (rSr - b @ Ab - logdet) + Mu @ r + s_sum - 0.5 * mpm
    logZ = jnp.where(failed, -jnp.inf, logZ)

    dlogZdMu = jnp.where(failed, 0.0, r - Ab)
    dlogZdMudMu = jnp.where(failed, 0.0, -A)
    dS = (
        -A
        - 2.0 * r[:, None] * Ab[None, :]
        + r[:, None] * r[None, :]
        + (A @ b)[:, None] * Ab[None, :]
    )
    dS = 0.5 * (dS + dS.T - jnp.diag(jnp.diagonal(dS)))
    ti, tj = jnp.tril_indices(D)
    dlogZdSigma = jnp.where(failed, 0.0, dS[ti, tj])
    return logZ, dlogZdMu, dlogZdMudMu, dlogZdSigma


@functools.partial(jax.jit, static_argnames=("with_derivatives", "max_sweeps"))
def joint_min(mu, Sigma, with_derivatives=False, max_sweeps=50):
    """log p_min over the D points of N(mu, Sigma) (epmgp.py joint_min :55-122).

    Returns logP (D,), and with derivatives also dlogPdMu (D,D),
    dlogPdSigma (D, D(D+1)/2) packed lower-triangular row-major, and
    dlogPdMudMu (D,D,D).
    """
    mu = jnp.asarray(mu).reshape(-1)
    D = mu.shape[0]
    Sigma = jnp.asarray(Sigma)

    logP, dMu, dMudMu, dSig = jax.vmap(
        lambda k: _min_factor(mu, Sigma, k, max_sweeps=max_sweeps)
    )(jnp.arange(D))

    logP = jnp.where(jnp.isinf(logP), -500.0, logP)
    # normalize across k (:100-105)
    mx = jnp.max(logP)
    s = mx + jnp.log(jnp.sum(jnp.exp(logP - mx)))
    logP_n = logP - s
    if not with_derivatives:
        return logP_n

    p_hat = jnp.exp(logP - s)  # normalized weights
    Zm = p_hat @ dMu  # (D,)
    Zs = p_hat @ dSig  # (D(D+1)/2,)
    dMu_n = dMu - Zm[None, :]
    dSig_n = dSig - Zs[None, :]
    gg = jnp.einsum("k,kij->ij", p_hat, dMudMu + jnp.einsum("ki,kj->kij", dMu, dMu))
    adds = -gg + Zm[:, None] * Zm[None, :]  # correct outer-product form
    dMudMu_n = dMudMu + adds[None, :, :]
    return logP_n, dMu_n, dSig_n, dMudMu_n


def pack_tril(S):
    """Pack a symmetric (D,D) matrix lower-triangular row-major — the layout of
    joint_min's dlogPdSigma axis."""
    D = S.shape[0]
    ti, tj = jnp.tril_indices(D)
    return S[ti, tj]
