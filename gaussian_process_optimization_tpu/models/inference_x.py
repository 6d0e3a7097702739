"""Latent-X inference for new observations — ``infer_newX``.

Rebuild of GPy's InferenceX engine
(``GPy/GPy/inference/latent_function_inference/inferenceX.py:1-170``): given a
TRAINED latent-variable model and new observations Y*, infer where in latent
space each new row lives, holding the trained posterior fixed. Point models
(GPLVM = GPRegression with trainable X) get a point estimate X*; Bayesian
GPLVM gets a variational posterior q(x*) = N(mu*, diag(S*)).

Accelerator-first design. The reference builds a throwaway paramz Model and runs one
scipy L-BFGS on the SUMMED objective (inferenceX.py:23-26). But the psi-space
objective decomposes over new rows, so here every row is an INDEPENDENT small
optimization and we vmap ONE jitted L-BFGS over all rows — N* Q-dim chains in
a single compiled program, no host loop.

Math. The reference objective is ``sum(dL_dpsi_i * psi_i)`` with the trained
posterior folded into constants (inferenceX.py:120-135 ``compute_dL``):

    dL_dpsi0 = -beta P / 2
    dL_dpsi1 = beta Y* wv^T
    dL_dpsi2 = beta/2 (P Wi - wv wv^T)

where wv/Wi are the posterior's woodbury vector/inverse and beta = 1/sigma^2.

- Point case (``psi2 = psi1^T psi1``, inferenceX.py:141-144): the contraction
  collapses to ``-beta/2 sum_nd [(y_nd - m_nd)^2 + v_n]`` + const — the
  expected log-likelihood of Y* under the fixed posterior predictive
  (m, v) = predict(x*). We optimize that directly via ``_raw_predict``.
- Uncertain case (BayesianGPLVM): the same contraction with the RBF psi
  statistics of q(x*) (inferenceX.py:137-139), with wv/Wi recovered from the
  collapsed bound (``var_dtc.py:199-212``: wv = beta Lm^-T B^-1 Lm^-1 psi1^T Y,
  Wi = Lm^-T (I - B^-1) Lm^-1), minus KL(q(x*) || N(0, I))
  (inferenceX.py:146-168).

Initialization mirrors ``_init_X`` (inferenceX.py:87-115): nearest training
row in Y space ('L2' squared distance, 'NCC' dot-product argmin — replicated
as written — or 'rand'), seeding x* with that row's latent (and variance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lbfgs
from ..utils.pytree import pytree_dataclass
from .gp import GPRegression
from .gplvm import BayesianGPLVM, _rbf_psi_core


@pytree_dataclass
class NormalLatentPosterior:
    """q(X*) = N(mean, diag(variance)) — the VariationalPosterior analog the
    reference returns (inferenceX.py:27)."""

    mean: jnp.ndarray = None      # (N*, Q)
    variance: jnp.ndarray = None  # (N*, Q)


def _init_idx(Y_train, Y_new, init, key, valid=None):
    """Nearest-training-row index per new row (inferenceX.py:87-106). ``valid``
    (N*, P) bool restricts distances to each new row's OBSERVED dims — the
    missing-data path (inferenceX.py:90-96), generalized to per-row masks."""
    Y_train = np.asarray(Y_train)
    Y_new = np.asarray(Y_new)
    if init == "rand":
        if key is None:
            key = jax.random.PRNGKey(0)
        return np.asarray(
            jax.random.randint(key, (Y_new.shape[0],), 0, Y_train.shape[0]))
    if valid is None:
        valid = np.ones(Y_new.shape, dtype=bool)
    Yn = np.where(valid, Y_new, 0.0)
    if init == "NCC":
        dist = Yn @ Y_train.T  # argmin of the dot, as written in the reference
    elif init == "L2":
        dist = (-2.0 * Yn @ Y_train.T
                + np.square(Yn).sum(1)[:, None]
                + (valid.astype(float) @ np.square(Y_train).T))
    else:
        raise ValueError(f"unknown init {init!r} (use 'L2', 'NCC' or 'rand')")
    return dist.argmin(axis=1)


def infer_newX(model, Y_new, optimize=True, init="L2", maxiter=200, key=None):
    """Infer latent positions for new observations ``Y_new`` (``infer_newX``,
    inferenceX.py:9-27).

    model: a trained ``GPRegression`` (point GPLVM) or ``BayesianGPLVM``.
    Y_new: (N*, P) in the model's OWN Y space (BayesianGPLVM stores centered Y;
    pass rows centered the same way — e.g. ``model.Y`` itself for train rows).

    Returns ``(X, info)``: X is an (N*, Q) array for point models, a
    :class:`NormalLatentPosterior` for BayesianGPLVM; ``info['objective']``
    holds the per-row final objective values (lower is better).
    """
    Y_new = jnp.asarray(Y_new, dtype=float)
    if Y_new.ndim == 1:
        Y_new = Y_new[:, None]
    if isinstance(model, BayesianGPLVM):
        return _infer_newX_uncertain(model, Y_new, optimize, init, maxiter, key)
    if isinstance(model, GPRegression):
        return _infer_newX_point(model, Y_new, optimize, init, maxiter, key)
    raise TypeError(
        f"infer_newX supports GPRegression (point GPLVM) and BayesianGPLVM, "
        f"got {type(model).__name__}")


# ------------------------------------------------------------------ point case
def _infer_newX_point(model, Y_new, optimize, init, maxiter, key):
    if model.normalizer is not None:
        Y_new = model.normalizer.normalize(Y_new)
    X_train = model.X
    Y_train = model.Y
    if model.mask is not None:
        n_real = int(np.sum(np.asarray(model.mask)))
        X_train = X_train[:n_real]
        Y_train = Y_train[:n_real]

    # Missing data: NaNs in Y_new mark unobserved dims. The reference restricts
    # this to ONE row at a time (inferenceX.py:47 asserts Y.shape[0]==1); the
    # branchless per-row mask handles arbitrary rows under one vmap.
    valid_np = ~np.isnan(np.asarray(Y_new))
    has_missing = not valid_np.all()
    valid = jnp.asarray(valid_np)
    Y_filled = jnp.where(valid, Y_new, 0.0)

    idx = _init_idx(Y_train, np.asarray(Y_filled), init, key,
                    valid=valid_np if has_missing else None)
    X0 = jnp.asarray(np.asarray(X_train)[idx])

    # Li precomputed once -> every vmapped L-BFGS objective eval predicts via
    # matmuls instead of a latency-bound (N,N) triangular solve per trial
    post = model.inference(precompute_inverse=True)
    sigma2 = model.likelihood_variance
    if sigma2.ndim > 0:  # heteroscedastic train noise: scalar test analog
        m_ = model.mask
        sigma2 = (jnp.sum(sigma2 * m_) / jnp.sum(m_)) if m_ is not None \
            else jnp.mean(sigma2)
    beta = 1.0 / jnp.maximum(sigma2, 1e-6)

    def obj_row(x, y, v):
        mu, var = model._raw_predict(x[None, :], posterior=post)
        # -E_post[log N(y | f(x), sigma2)] over the OBSERVED dims only
        # (missing dims contribute nothing — inferenceX.py:125-133):
        p_eff = jnp.sum(v)
        return 0.5 * beta * (
            jnp.sum(v * jnp.square(y - mu[0])) + p_eff * var[0, 0])

    V = valid.astype(Y_filled.dtype)
    if not optimize:
        f0 = jax.jit(jax.vmap(obj_row))(X0, Y_filled, V)
        return X0, {"objective": f0}

    def solve_row(x0, y, v):
        res = lbfgs.minimize(lambda x: obj_row(x, y, v), x0, maxiter=maxiter,
                             carry_vjp=False)
        return res.x, res.f

    xs, fs = jax.jit(jax.vmap(solve_row))(X0, Y_filled, V)
    return xs, {"objective": fs}


# -------------------------------------------------------------- uncertain case
def _infer_newX_uncertain(model, Y_new, optimize, init, maxiter, key):
    kern = model.kern
    Z = model.Z
    Y = model.Y
    sigma2 = jnp.maximum(model.likelihood_variance, 1e-6)
    beta = 1.0 / sigma2
    P = Y.shape[1]
    Q = model.q_mu.shape[1]

    # The collapsed-bound posterior q(u) in woodbury form (var_dtc.py:199-212).
    wv, Wi = model.posterior_u()
    dL2 = 0.5 * beta * (P * Wi - wv @ wv.T)  # dL_dpsi2 (compute_dL)

    idx = _init_idx(Y, Y_new, init, key)
    mu0 = jnp.asarray(np.asarray(model.q_mu)[idx])
    S0 = jnp.asarray(np.asarray(model.q_S)[idx])

    def neg_elbo_row(u, y):
        mu = u[:Q][None, :]
        S = jnp.exp(u[Q:])[None, :]
        psi0, psi1, psi2n = _rbf_psi_core(kern, Z, mu, S)  # psi0 == variance (N=1)
        m_pred = psi1[0] @ wv  # (P,) predictive mean at q(x*)
        val = (jnp.sum(dL2 * psi2n[0])
               + beta * jnp.dot(y, m_pred)
               - 0.5 * beta * P * psi0)
        kl = 0.5 * jnp.sum(jnp.square(mu) + S - jnp.log(S) - 1.0)
        return -(val - kl)

    U0 = jnp.concatenate([mu0, jnp.log(S0)], axis=1)
    if not optimize:
        f0 = jax.jit(jax.vmap(neg_elbo_row))(U0, Y_new)
        return NormalLatentPosterior(mean=mu0, variance=S0), {"objective": f0}

    def solve_row(u0, y):
        res = lbfgs.minimize(lambda u: neg_elbo_row(u, y), u0, maxiter=maxiter,
                             carry_vjp=False)
        return res.x, res.f

    us, fs = jax.jit(jax.vmap(solve_row))(U0, Y_new)
    return (
        NormalLatentPosterior(mean=us[:, :Q], variance=jnp.exp(us[:, Q:])),
        {"objective": fs},
    )
