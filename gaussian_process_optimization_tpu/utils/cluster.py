"""Greedy time-series clustering with the offset GP.

Rebuild of GPy's ``util/cluster_with_offset.py:1`` (``cluster``,
``get_log_likelihood_offset``): starting from singleton clusters, iteratively
join the pair whose combined offset-GP log likelihood most exceeds the sum of
the separate fits, until no join improves it. A pair fit shares one GP across
the two series with a trainable per-series input offset (our
``models/zoo.py GPOffsetRegression``; reference ``gp_offset_regression.py:11``)
and the reference's N(0, 20) prior on the offset
(``cluster_with_offset.py:84``).

Accelerator-first redesign: the reference optimizes O(K^2) GPy models SERIALLY, one
``m.optimize()`` per candidate pair, each at its own ragged size. Here every
candidate is right-padded to one fixed row budget (mask-aware LML — padded
rows become identity rows before the Cholesky, ``ops/linalg.py masked_gram``),
so a single jitted program serves the whole greedy loop, and ALL stale
candidates in a round are fit in one vmapped L-BFGS program (lanes = candidate
pairs) — the same restart-batching structure as the main fit path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.stationary import RBF
from ..models.gp import GPRegression
from ..ops import lbfgs
from .transforms import Positive

_POS = Positive()
_OFFSET_PRIOR_STD = 20.0  # reference: GPy.priors.Gaussian(0, 20) on the offset


def _masked_lml(u, X, Y, sel, mask, with_offset):
    """LML of the (optionally offset-)GP at packed params u.

    u = [raw_noise, raw_variance, raw_lengthscale(, offset)] with the positive
    leaves through softplus (paramz Logexp parity). ``sel`` is 0/1 per row;
    rows with sel==1 are shifted by the trainable offset
    (gp_offset_regression.py:11 with two clusters)."""
    noise = _POS.forward(u[0]) + 1e-6
    kern = RBF(input_dim=X.shape[1], active_dims=None,
               variance=_POS.forward(u[1]), lengthscale=_POS.forward(u[2]))
    Xs = X + (u[3] * sel)[:, None] if with_offset else X
    m = GPRegression(kern=kern, likelihood_variance=noise, X=Xs, Y=Y,
                     mask=mask, normalizer=None, mean_function=None)
    return m.log_marginal_likelihood()


from functools import partial as _jit_partial


@_jit_partial(jax.jit, static_argnums=(5, 6))
def _fit_batch(U0, Xb, Yb, selb, maskb, with_offset, maxiter):
    """Fit all lanes in ONE vmapped L-BFGS program; returns (lml, offset).

    Module-level jit with static (with_offset, maxiter): wrapping a fresh
    closure in jax.jit per call retraced + recompiled every greedy round
    (~9 s/round measured on this host) — the cache must key on a stable
    function object to actually serve the whole loop."""

    def one(u0, X, Y, sel, mask):
        def obj(u):
            pen = (0.5 * (u[3] / _OFFSET_PRIOR_STD) ** 2 if with_offset else 0.0)
            return -_masked_lml(u, X, Y, sel, mask, with_offset) + pen

        res = lbfgs.minimize(obj, u0, maxiter=maxiter)
        # report the LIKELIHOOD at the MAP (the reference compares
        # m.log_likelihood() values, not posteriors)
        ll = _masked_lml(res.x, X, Y, sel, mask, with_offset)
        off = res.x[3] if with_offset else jnp.zeros(())
        return ll, off

    return jax.vmap(one)(U0, Xb, Yb, selb, maskb)


def _pad_stack(items, n_max):
    """items: list of (X, Y, sel); right-pad each to n_max rows + build masks."""
    Xb, Yb, selb, maskb = [], [], [], []
    for X, Y, sel in items:
        n, d = X.shape
        p = n_max - n
        Xb.append(np.vstack([X, np.zeros((p, d))]))
        Yb.append(np.vstack([Y, np.zeros((p, Y.shape[1]))]))
        selb.append(np.concatenate([sel, np.zeros(p)]))
        maskb.append((np.arange(n_max) < n).astype(float))
    return (jnp.asarray(np.stack(Xb)), jnp.asarray(np.stack(Yb)),
            jnp.asarray(np.stack(selb)), jnp.asarray(np.stack(maskb)))


def _u0(with_offset):
    raw1 = float(_POS.inverse(1.0))
    return np.array([raw1, raw1, raw1, 0.0] if with_offset else
                    [raw1, raw1, raw1])


def get_log_likelihood(inputs, data, clust, maxiter=80):
    """LL of the union of ``clust`` ignoring offsets
    (cluster_with_offset.py get_log_likelihood:8). Returns (ll, 0.0)."""
    X = np.vstack([np.asarray(inputs[p], dtype=float) for p in clust])
    Y = np.vstack([np.asarray(data[p], dtype=float).T for p in clust])
    items = [(X, Y, np.zeros(X.shape[0]))]
    Xb, Yb, selb, maskb = _pad_stack(items, X.shape[0])
    U0 = jnp.asarray(_u0(True))[None, :]
    ll, _ = _fit_batch(U0, Xb, Yb, selb, maskb, False, maxiter)
    return float(ll[0]), 0.0


def get_log_likelihood_offset(inputs, data, clust, maxiter=80):
    """LL of the union of ``clust`` with a trainable offset between the two
    members (cluster_with_offset.py get_log_likelihood_offset:47). Returns
    (ll, offset); a single-member clust falls back to the offset-free fit."""
    if len(clust) == 1:
        return get_log_likelihood(inputs, data, clust, maxiter=maxiter)
    assert len(clust) == 2, "the greedy loop only ever joins pairs"
    i, j = clust
    Xi = np.asarray(inputs[i], dtype=float)
    Xj = np.asarray(inputs[j], dtype=float)
    X = np.vstack([Xi, Xj])
    Y = np.vstack([np.asarray(data[i], dtype=float).T,
                   np.asarray(data[j], dtype=float).T])
    sel = np.concatenate([np.zeros(Xi.shape[0]), np.ones(Xj.shape[0])])
    Xb, Yb, selb, maskb = _pad_stack([(X, Y, sel)], X.shape[0])
    U0 = jnp.asarray(_u0(True))[None, :]
    ll, off = _fit_batch(U0, Xb, Yb, selb, maskb, True, maxiter)
    return float(ll[0]), float(off[0])


def cluster(data, inputs, verbose=False, maxiter=80):
    """Greedy offset-GP clustering (cluster_with_offset.py cluster:92).

    ``data``: list, one entry per series, each (S, T_p) (S outputs over T_p
    times); ``inputs``: list of (T_p, 1) time stamps — the reference's layout.
    Returns the list of clusters (lists of original series indices).

    Unlike the reference, all stale candidate evaluations in a round run as
    ONE vmapped multi-fit; merged series are padded to the fixed total-row
    budget so the compiled program is reused across rounds.
    """
    data = [np.asarray(d, dtype=float) for d in data]
    inputs = [np.asarray(x, dtype=float) for x in inputs]
    n_max = sum(x.shape[0] for x in inputs)  # fixed padding budget

    active = [[p] for p in range(len(data))]
    loglikes = np.full(len(active), np.nan)
    pairll = np.full((len(active), len(active)), np.nan)
    pairoff = np.zeros_like(pairll)

    def run_stale():
        # gather every NaN single + NaN pair, fit them all in one vmapped call
        jobs, where = [], []
        for i in range(len(active)):
            if np.isnan(loglikes[i]):
                jobs.append((inputs[i], data[i].T, np.zeros(inputs[i].shape[0])))
                where.append(("s", i))
            for j in range(i):
                if np.isnan(pairll[i, j]):
                    X = np.vstack([inputs[i], inputs[j]])
                    Y = np.vstack([data[i].T, data[j].T])
                    sel = np.concatenate([np.zeros(inputs[i].shape[0]),
                                          np.ones(inputs[j].shape[0])])
                    jobs.append((X, Y, sel))
                    where.append(("p", i, j))
        if not jobs:
            return
        Xb, Yb, selb, maskb = _pad_stack(jobs, n_max)
        U0 = jnp.broadcast_to(jnp.asarray(_u0(True)), (len(jobs), 4))
        ll, off = _fit_batch(U0, Xb, Yb, selb, maskb, True, maxiter)
        ll, off = np.asarray(ll), np.asarray(off)
        for k, w in enumerate(where):
            if w[0] == "s":
                loglikes[w[1]] = ll[k]
            else:
                pairll[w[1], w[2]] = ll[k]
                pairoff[w[1], w[2]] = off[k]

    it = 0
    while True:
        it += 1
        if verbose:
            print(f"cluster iteration {it}: {len(active)} clusters")
        run_stale()
        sep = loglikes[None, :] + loglikes[:, None]
        improvement = pairll - sep
        if np.all(np.isnan(improvement)):
            break
        top = np.unravel_index(np.nanargmax(improvement), improvement.shape)
        if not improvement[top] > 0:
            break
        i, j = top  # join j into i (reference joins top[1] into top[0])
        offset = pairoff[i, j]
        active[i].extend(active[j])
        # the pair fit ADDS the offset to cluster j's rows (sel == 1, matching
        # GPOffsetRegression._shifted), so aligning j onto i applies +offset —
        # the reference subtracts because ITS model shifts the other way
        inputs[i] = np.vstack([inputs[i], inputs[j] + offset])
        data[i] = np.hstack([data[i], data[j]])
        del inputs[j], data[j], active[j]
        pairll[:, i] = np.nan
        pairll[i, :] = np.nan
        pairll = np.delete(np.delete(pairll, j, 0), j, 1)
        pairoff = np.delete(np.delete(pairoff, j, 0), j, 1)
        loglikes[i] = np.nan
        loglikes = np.delete(loglikes, j)
        if len(active) == 1:
            break
    return active
