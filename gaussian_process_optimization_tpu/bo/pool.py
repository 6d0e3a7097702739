"""Finite-candidate-pool batch selection — the reference application's pattern
(run.py:1234-1267 get_configurations): instead of optimizing the acquisition over a
continuous box, directly evaluate it on a finite pool of feasible configurations,
and build LP batches by re-scoring the penalized acquisition over the pool with a
mask of already-picked entries (update_batches/estimate_L driven manually).

Device-side: the pool scoring is one jitted sweep; the greedy batch loop is k small
device argmaxes.
"""
from __future__ import annotations

import weakref

import jax
import jax.numpy as jnp
import numpy as np

from .acquisitions import AcquisitionLP
from .evaluators import estimate_L

# per-acquisition jitted pool scorer (weak-keyed like
# AcquisitionOptimizer._jit_cache): calling pure_neg_acq eagerly dispatched
# ~10 small programs per score_pool call.
_score_jits = weakref.WeakKeyDictionary()


def _pool_scorer(acquisition):
    if acquisition not in _score_jits:
        def score(gp, post, fmin, state, X):
            return acquisition.pure_neg_acq(gp, post, fmin, state, X)

        _score_jits[acquisition] = jax.jit(score)
    return _score_jits[acquisition]


def score_pool(acquisition, pool_obj, space):
    """Acquisition values over a pool given in OBJECTIVE space. Returns
    minimize-convention scores (lower = better), infeasible entries +inf."""
    Xm = space.unzip_inputs(pool_obj)
    gp, post, fmin, state = acquisition.device_args()
    scores = np.asarray(
        _pool_scorer(acquisition)(gp, post, fmin, state, jnp.asarray(Xm, dtype=float))
    )
    if space.has_constraints():
        ind = space.indicator_constraints(Xm).flatten()
        scores = np.where(ind == 1, scores, np.inf)
    return scores, Xm


def suggest_from_pool(acquisition, pool_obj, space, batch_size=1, exclude_mask=None):
    """Pick `batch_size` pool entries: first by plain acquisition argmax over the
    pool, then (for LP acquisitions) re-scoring the penalized acquisition after each
    pick (run.py:1243-1263). Returns (indices, X_objective rows)."""
    pool_obj = np.atleast_2d(np.asarray(pool_obj, dtype=float))
    n = pool_obj.shape[0]
    taken = np.zeros(n, dtype=bool) if exclude_mask is None else np.asarray(
        exclude_mask, dtype=bool
    ).copy()

    is_lp = isinstance(acquisition, AcquisitionLP)
    if is_lp:
        acquisition.update_batches(None, None, None)

    scores, Xm = score_pool(acquisition, pool_obj, space)
    picks = []
    X_batch = None
    L = Min = None
    for k in range(batch_size):
        s = np.where(taken, np.inf, scores)
        idx = int(np.argmin(s))
        if not np.isfinite(s[idx]):
            break
        picks.append(idx)
        taken[idx] = True
        if is_lp and k + 1 < batch_size:
            if L is None:
                L = estimate_L(acquisition.model, space.get_bounds())
                Min = acquisition.model.Y_min()
            X_batch = Xm[picks]
            acquisition.update_batches(X_batch, L, Min)
            scores, _ = score_pool(acquisition, pool_obj, space)
    if is_lp:
        acquisition.update_batches(None, None, None)
    return np.asarray(picks, dtype=int), pool_obj[picks]


def metamodel_rmse(model, X_test, Y_test):
    """Surrogate-only prediction quality (run.py predict_using_metamodel:1322-1361):
    RMSE of the posterior mean against held-out objective values.

    NOTE: Y_test must be in the MODEL's training units. The BO loop trains its
    surrogate on 'stats'-normalized Y (bo_loop._update_model), so pass
    `normalize_stats(Y)` when scoring a BO-loop surrogate."""
    mu, _ = model.predict(np.atleast_2d(X_test))
    err = np.asarray(mu).flatten() - np.asarray(Y_test).flatten()
    return float(np.sqrt(np.mean(err**2)))


def shuffle_indices(X, variables, rng=None):
    """Randomly relabel each discrete dimension's level indices
    (run.py:192-205 shuffle_indices) — the reference's encoding-robustness
    experiment: if BO performance depends on the arbitrary ordering of
    discrete levels, the surrogate is reading false ordinal structure.

    `variables`: the domain spec list ({'type': 'discrete', 'domain': levels}).
    Returns (X_shuffled, shuffle_patterns); invert with
    :func:`unshuffle_indices`. Unlike the reference (which uses the global
    numpy RNG and mutates X in place), takes an optional Generator and returns
    a copy.
    """
    rng = np.random.default_rng() if rng is None else rng
    X = np.array(X, dtype=float, copy=True)
    patterns = [None] * len(variables)
    for d, var in enumerate(variables):
        if var.get("type") != "discrete":
            continue
        levels = list(var["domain"])
        pattern = list(range(len(levels)))
        rng.shuffle(pattern)
        patterns[d] = pattern
        for row in X:
            original = levels.index(row[d])
            row[d] = levels[pattern[original]]
    return X, patterns


def unshuffle_indices(X, variables, shuffle_patterns):
    """Invert :func:`shuffle_indices` (run.py:207-218)."""
    X = np.array(X, dtype=float, copy=True)
    for d, var in enumerate(variables):
        if var.get("type") != "discrete" or shuffle_patterns[d] is None:
            continue
        levels = list(var["domain"])
        pattern = shuffle_patterns[d]
        for row in X:
            shuffled = levels.index(row[d])
            row[d] = levels[pattern.index(shuffled)]
    return X
