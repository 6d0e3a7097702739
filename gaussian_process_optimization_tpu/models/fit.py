"""Hyperparameter fitting: multi-restart L-BFGS on the (negative) log marginal
likelihood.

Rebuild of the paramz optimize/optimize_restarts harness as used by the reference
(GPy core/gp.py:643 -> paramz Model.optimize -> scipy lbfgsb; GPyOpt gpmodel.py:88-93
runs optimize_restarts(5, 'bfgs', max_iters=1000)). Differences, accelerator-first:

- the objective is -(LML + log prior) with gradients by autodiff through the whole
  inference (kernel build, jitter-ladder Cholesky, solves) — replacing the hand-written
  dL_dK / dL_dtheta plumbing;
- restarts run as ONE vmapped L-BFGS program on device (the reference loops restarts
  serially in Python, each step doing an O(N^3) CPU factorization);
- restart initialization: restart 0 starts from the current parameters, others draw
  N(0,1) in unconstrained space (paramz `randomize()` equivalent) routed through each
  transform's `random_restart` so box-bounded parameters restart at sane magnitudes.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..ops import lbfgs
from ..utils.priors import Prior
from .parameters import _leaf_names, make_packer


def make_objective(packer, priors: dict[str, Prior] | None = None,
                   extra_loss=None):
    """Returns obj(u, model) = -(LML(model with packed params u) + log prior).

    `priors`: field-name -> Prior, applied on constrained values (GPy
    core/model.py:101-127 objective = -logL - logPrior). For priored parameters
    under a non-identity transform, the transform's log-Jacobian is added so the
    unconstrained-space target is the correctly change-of-variabled density
    (GPy core/parameterization/priorizable.py:57-65; fixed parameters carry no
    Jacobian there either — paramz replaces their constraint with __fixed__).
    """
    def _tail(m, total):
        if priors:
            leaf_names = _leaf_names(m)
            leaves = jax.tree_util.tree_leaves(m)
            for nm, leaf, t, fx in zip(leaf_names, leaves,
                                       packer.transforms, packer.fixed):
                pr = priors.get(nm)
                if pr is not None:
                    leaf = jnp.asarray(leaf)
                    total = total + jnp.sum(pr.lnpdf(leaf))
                    if not fx:
                        total = total + jnp.sum(t.log_jacobian(leaf))
        if extra_loss is not None:
            total = total - extra_loss(m)
        return -total

    def obj(u, model):
        m = packer.unpack(u, reference=model)
        return _tail(m, m.log_marginal_likelihood())

    obj.tail = _tail
    return obj


class Fitter:
    """Reusable jitted fit program for one model structure.

    Build once, call many times (the BO loop refits every iteration on same-shaped
    padded buffers, so the compiled program is reused).
    """

    def __init__(
        self,
        template_model: Any,
        num_restarts: int = 5,
        maxiter: int = 1000,
        fix: tuple = (),
        transform_overrides: dict | None = None,
        priors: dict[str, Prior] | None = None,
        tol: float = 1e-5,
        history: int = 10,
        jit: bool = True,
        max_ls: int = 8,
        nonmonotone_eta: float = 0.0,
        grow_backtracked: float | None = None,
        thread_ladder: bool | None = None,
    ):
        if grow_backtracked is None:
            from ..config import config as _config

            grow_backtracked = _config.ls_grow_backtracked
        self.packer = make_packer(
            template_model, fix=fix, transform_overrides=transform_overrides
        )
        self.num_restarts = num_restarts
        self.maxiter = maxiter
        obj = make_objective(self.packer, priors=priors)
        packer = self.packer
        # thread_ladder: thread the accepted jitchol ladder rung across line-
        # search trials via the L-BFGS aux channel — each trial's ladder starts
        # at the rung the PREVIOUS ACCEPTED evaluation ended on (greedy walk up;
        # see ops/linalg._jitchol_loop). This is the same greedy-hint policy the
        # BO wrappers already apply ACROSS refits (bo_models.updateModel, which
        # re-verifies minimality at the posterior factorization), with one-
        # trial-ago freshness. OPT-IN (GPO_THREAD_LADDER=1), default OFF: the
        # bench fit's accepted trials never leave rung 0 — ladder cost hides
        # in REJECTED exploratory trials, which threading cannot help — and the
        # threaded program ran slower in an earlier A/B. It wins only on
        # workloads whose ACCEPTED path climbs (exact_feval Gower first-fits);
        # exact GPRegression only (its LML is inference().lml and it carries the
        # hint fields).
        if thread_ladder is None:
            import os

            thread_ladder = bool(os.environ.get("GPO_THREAD_LADDER", ""))
        if thread_ladder:
            from .gp import GPRegression as _GPR

            thread_ladder = type(template_model) is _GPR
        self.thread_ladder = bool(thread_ladder)
        if self.thread_ladder:
            from ..utils.pytree import replace as _replace

            def obj_aux(uu, hint, model):
                m = packer.unpack(uu, reference=model)
                m = _replace(m, jitter_hint=hint, jitter_greedy=True)
                post = m.inference()
                return obj.tail(m, post.lml), post.rung.astype(jnp.float32)

        def run(model, key):
            u0 = packer.pack(model)
            n = u0.shape[0]
            if num_restarts > 1:
                z = jax.random.normal(key, (num_restarts - 1, n), dtype=u0.dtype)
                # route each draw through the per-leaf restart map (paramz
                # randomize() parity for Identity/Logexp; sane magnitudes for
                # bounded transforms — ADVICE round 1)
                rand = jax.vmap(packer.map_restart)(z)
                starts = jnp.concatenate([u0[None], rand])
            else:
                starts = u0[None]

            if self.thread_ladder:
                h0 = getattr(model, "jitter_hint", None)
                aux0 = (jnp.zeros((), jnp.float32) if h0 is None
                        else jnp.asarray(h0, jnp.float32).reshape(()))
            else:
                aux0 = None

            def solve(u):
                # max_ls=8: every backtrack is a full forward (Cholesky) for the
                # WHOLE restart batch; a lane that cannot improve within 8
                # halvings freezes (the scipy-lbfgsb ABNORMAL_TERMINATION
                # analog, optimizer.py:54-56) instead of gating the batch.
                # nonmonotone_eta: Zhang-Hager acceptance cuts the backtrack
                # tail that the vmapped restart batch pays at max-over-lanes.
                # OPT-IN (default 0 = monotone): a 6-seed CPU-f64 A/B showed
                # eta=0.5 degrading Hartmann6 median regret 0.064->0.099 and
                # one alpine1 seed 0.018->0.59: speed knobs that move regret
                # stay opt-in.
                if aux0 is not None:
                    return lbfgs.minimize(
                        lambda uu, hint: obj_aux(uu, hint, model), u,
                        maxiter=maxiter, tol=tol, history=history,
                        max_ls=max_ls, nonmonotone_eta=nonmonotone_eta,
                        grow_backtracked=grow_backtracked, aux0=aux0,
                    )
                return lbfgs.minimize(
                    lambda uu: obj(uu, model), u, maxiter=maxiter, tol=tol,
                    history=history, max_ls=max_ls,
                    nonmonotone_eta=nonmonotone_eta,
                    grow_backtracked=grow_backtracked,
                )

            res = jax.vmap(solve)(starts)
            f = jnp.where(jnp.isfinite(res.f), res.f, jnp.inf)
            best = jnp.argmin(f)
            fitted = packer.unpack(res.x[best], reference=model)
            return fitted, res

        self._run = jax.jit(run) if jit else run

    def __call__(self, model, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        return self._run(model, key)


def checkgrad(model, fix: tuple = (), transform_overrides: dict | None = None,
              priors=None, eps: float = 1e-4, rtol: float = 1e-3, atol: float = 1e-6,
              verbose: bool = False) -> bool:
    """paramz `m.checkgrad()` parity: central finite differences of the packed
    objective vs the autodiff gradient, in unconstrained optimizer space
    (SURVEY §4: 'gradient correctness is the backbone')."""
    import numpy as np

    packer = make_packer(model, fix=fix, transform_overrides=transform_overrides)
    obj = make_objective(packer, priors=priors)
    u0 = np.asarray(packer.pack(model), dtype=float)
    g = np.asarray(jax.grad(lambda u: obj(u, model))(jnp.asarray(u0)))
    fd = np.zeros_like(u0)
    for i in range(u0.size):
        up, um = u0.copy(), u0.copy()
        up[i] += eps
        um[i] -= eps
        fd[i] = (float(obj(jnp.asarray(up), model)) - float(obj(jnp.asarray(um), model))) / (2 * eps)
    ok = np.allclose(g, fd, rtol=rtol, atol=atol)
    if verbose or not ok:
        print("checkgrad: analytic", g, "numeric", fd)
    return bool(ok)


def fit(model, num_restarts: int = 5, maxiter: int = 1000, key=None,
        fix: tuple = (), transform_overrides: dict | None = None,
        priors: dict[str, Prior] | None = None, jit: bool = True, **kw):
    """One-shot convenience wrapper (GPy `m.optimize_restarts(...)`)."""
    fitter = Fitter(
        model, num_restarts=num_restarts, maxiter=maxiter, fix=fix,
        transform_overrides=transform_overrides, priors=priors, jit=jit, **kw
    )
    return fitter(model, key)
