"""Hybrid Monte Carlo over model hyperparameters.

Rebuild of GPy's HMC (``GPy/GPy/inference/mcmc/hmc.py:7``): leapfrog integration in
the *unconstrained* optimizer space (the packed vector of utils/packing, the analog
of paramz's optimizer_array) with identity mass matrix and Metropolis acceptance
(sample:31, _update:62, _computeH:68).

Accelerator-first: the whole chain is ONE jitted ``lax.scan`` (leapfrog inner loop is a
``fori_loop``); gradients of the potential come from autodiff through the GP
inference instead of the reference's hand-plumbed _transform_gradients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def hmc_sample(potential_fn, u0, key, num_samples, stepsize=1e-1, leapfrog_steps=20):
    """Sample from exp(-potential). Returns (samples (num_samples, dim), accept_rate).

    potential_fn(u) -> scalar (e.g. -(LML + log prior)); must be autodiff-able.
    Matches GPy HMC semantics: every iteration stores a sample (accepted state or
    the previous one) — the reference stores the pre-update state then overwrites on
    acceptance (hmc.py:41-58).
    """
    dim = u0.shape[0]
    vg = jax.value_and_grad(potential_fn)

    def leapfrog(u, p):
        def body(_, carry):
            u, p = carry
            p = p - 0.5 * stepsize * vg(u)[1]
            u = u + stepsize * p
            p = p - 0.5 * stepsize * vg(u)[1]
            return (u, p)

        return lax.fori_loop(0, leapfrog_steps, body, (u, p))

    def step(carry, key):
        u = carry
        k1, k2 = jax.random.split(key)
        p = jax.random.normal(k1, (dim,), dtype=u.dtype)
        H_old = potential_fn(u) + 0.5 * jnp.dot(p, p)
        u_new, p_new = leapfrog(u, p)
        H_new = potential_fn(u_new) + 0.5 * jnp.dot(p_new, p_new)
        log_accept = H_old - H_new
        accept = jnp.log(jax.random.uniform(k2, dtype=u.dtype)) < jnp.minimum(log_accept, 0.0)
        # NaN-proof: never accept a non-finite proposal
        accept = accept & jnp.all(jnp.isfinite(u_new)) & jnp.isfinite(H_new)
        u = jnp.where(accept, u_new, u)
        return u, (u, accept.astype(u.dtype))

    keys = jax.random.split(key, num_samples)
    _, (samples, accepts) = lax.scan(step, u0, keys)
    return samples, jnp.mean(accepts)


def metropolis_hastings(
    logpost_fn,
    u0,
    key,
    num_samples=10000,
    burnin=1000,
    thin=10,
    cov=None,
    tune=True,
    tune_throughout=False,
    tune_interval=400,
):
    """Random-walk Metropolis-Hastings with Gelman et al. adaptive tuning.

    Rebuild of GPy ``Metropolis_Hastings`` (``GPy/GPy/inference/mcmc/samplers.py:17-71``):
    proposal N(u, cov * scale^2) with initial scale 2.4/sqrt(D) (samplers.py:28), accept
    uphill moves and downhill with prob exp(f' - f) (samplers.py:49-58); every
    ``tune_interval`` iterations (during burn-in, or always if ``tune_throughout``)
    re-estimate the proposal covariance from the recent chain and rescale by the
    acceptance rate: >0.25 -> scale*1.1, <0.15 -> scale/1.1 (samplers.py:64-71).

    ``logpost_fn(u) -> scalar`` is the log posterior (LML + log prior) over the packed
    unconstrained vector — the analog of ``model.log_likelihood() + model.log_prior()``.

    Accelerator-first: each tuning window is ONE jitted ``lax.scan`` of ``tune_interval`` MH
    steps (compiled once, reused across windows — the host only touches the small
    (D, D) covariance between windows). Deviation from the reference, documented: the
    reference's tuning guard (samplers.py:65) mixes bitwise ``&`` with modulo and
    crashes when the stored chain is empty during burn-in; we implement the documented
    Gelman intent — covariance from ALL iterates of the current window chain (kept on
    device), guarded against degeneracy with a jitter floor.

    Returns (samples (num_kept, D), accept_rate, scale, cov).
    """
    import numpy as np

    u0 = jnp.asarray(u0)
    dim = u0.shape[0]
    if cov is None:
        cov = np.eye(dim)
    cov = np.asarray(cov, dtype=np.asarray(u0).dtype)
    scale = 2.4 / np.sqrt(dim)

    @jax.jit
    def run_window(u, f, chol_scaled, keys):
        def step(carry, k):
            u, f = carry
            k1, k2 = jax.random.split(k)
            z = jax.random.normal(k1, (dim,), dtype=u.dtype)
            prop = u + chol_scaled @ z
            fprop = logpost_fn(prop)
            # uphill always; downhill with prob exp(fprop - f) (samplers.py:49-58)
            accept = (fprop > f) | (
                jnp.log(jax.random.uniform(k2, dtype=u.dtype)) < fprop - f
            )
            accept = accept & jnp.isfinite(fprop)
            u = jnp.where(accept, prop, u)
            f = jnp.where(accept, fprop, f)
            return (u, f), (u, accept.astype(u.dtype))

        (u, f), (us, accs) = lax.scan(step, (u, f), keys)
        return u, f, us, jnp.mean(accs)

    u = u0
    f = logpost_fn(u0)
    all_states = []
    it = 0
    while it < num_samples:
        window = min(tune_interval, num_samples - it)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, window)
        # pad the last (short) window so the compiled program is reused
        if window < tune_interval:
            keys = jnp.concatenate(
                [keys, jax.random.split(key, tune_interval - window)]
            )
        chol = np.linalg.cholesky(
            cov + 1e-12 * np.eye(dim, dtype=cov.dtype)
        ) * scale
        u, f, us, acc_rate = run_window(u, f, jnp.asarray(chol), keys)
        us = np.asarray(us)[:window]
        all_states.append(us)
        it += window
        tuning_now = tune and (it <= burnin or tune_throughout)
        if tuning_now:
            pc = float(acc_rate)
            recent = np.concatenate(all_states)[-tune_interval:]
            if recent.shape[0] >= max(8, dim + 1):
                c = np.cov(recent.T).reshape(dim, dim)
                if np.all(np.isfinite(c)) and np.trace(c) > 1e-12:
                    cov = c
            if pc > 0.25:
                scale *= 1.1
            elif pc < 0.15:
                scale /= 1.1
    chain = np.concatenate(all_states)
    kept = chain[burnin + 1 :: thin] if burnin + 1 < chain.shape[0] else chain[-1:]
    total_acc = np.mean(
        [np.any(chain[i] != chain[i - 1]) for i in range(1, chain.shape[0])]
    )
    return jnp.asarray(kept), float(total_acc), scale, cov


def hmc_shortcut_sample(
    potential_fn,
    u0,
    key,
    num_samples,
    stepsize_range=(1e-6, 1e-1),
    groupsize=5,
    Hstd_th=(1e-5, 3.0),
    leapfrog_steps=20,
):
    """HMC with the 'shortcut' trajectory test of GPy ``HMC_shortcut``
    (``GPy/GPy/inference/mcmc/hmc.py:70-173``).

    Per sample: draw the stepsize log-uniformly from ``stepsize_range`` (hmc.py:87),
    integrate leapfrog steps storing (theta, p, H) in a trajectory buffer centered at
    the start state; once ``groupsize`` steps exist, test the std of the last
    ``groupsize`` H values (hmc.py:165-170) — outside ``Hstd_th`` means the
    trajectory went unstable:

    - first failure: reverse — restart from the center with negated momentum and
      integrate the remaining steps in the reverse direction (hmc.py:136-148);
    - second failure: stop and pick the state the leftover step count wraps onto
      within the explored segment (hmc.py:155-163).

    Finish with the standard Metropolis accept against H at the start (identity mass
    matrix, so the reference's log det(M) terms vanish, hmc.py:172-173).

    Accelerator-first: the whole chain is one jitted ``lax.scan``; the per-sample trajectory
    is a ``lax.while_loop`` over a fixed (2*leapfrog_steps+1)-slot buffer with
    branchless selects for the reversal bookkeeping.

    Returns (samples (num_samples, D), accept_rate).
    """
    dim = u0.shape[0]
    vg = jax.value_and_grad(potential_fn)
    log_lo, log_hi = jnp.log(jnp.asarray(stepsize_range[0])), jnp.log(
        jnp.asarray(stepsize_range[1])
    )
    C = leapfrog_steps  # buffer center
    nbuf = 2 * leapfrog_steps + 1

    def H_of(u, p):
        return potential_fn(u) + 0.5 * jnp.dot(p, p)

    def leapfrog_step(u, p, eps):
        p = p - 0.5 * eps * vg(u)[1]
        u = u + eps * p
        p = p - 0.5 * eps * vg(u)[1]
        return u, p

    def trajectory(u0_, p0_, eps):
        th_buf = jnp.zeros((nbuf, dim), u0_.dtype).at[C].set(u0_)
        p_buf = jnp.zeros((nbuf, dim), u0_.dtype).at[C].set(p0_)
        H_buf = jnp.full((nbuf,), jnp.inf, u0_.dtype).at[C].set(H_of(u0_, p0_))

        # carry: (u, p, th_buf, p_buf, H_buf, pos, i, rev_pos, done, fin_u, fin_p)
        def cond(c):
            return (c[6] < leapfrog_steps) & (~c[8])

        def window_std(H_buf, pos, reversed_):
            # forward: H at [pos-g+1 .. pos]; reversed: H at [pos .. pos+g-1]
            start = jnp.where(reversed_, C + pos, C + pos - groupsize + 1)
            w = lax.dynamic_slice(H_buf, (start,), (groupsize,))
            return jnp.std(w)

        def body(c):
            u, p, th_buf, p_buf, H_buf, pos, i, rev_pos, done, fu, fp = c
            u, p = leapfrog_step(u, p, eps)
            slot = C + pos
            th_buf = th_buf.at[slot].set(u)
            p_buf = p_buf.at[slot].set(p)
            H_buf = H_buf.at[slot].set(H_of(u, p))
            i = i + 1
            reversed_ = rev_pos != 0

            # test only once at least groupsize states exist along the current arm
            have = jnp.where(reversed_, rev_pos - pos + 1, pos + 1)
            can_test = (i >= groupsize) & (have >= groupsize)
            hstd = window_std(H_buf, pos, reversed_)
            ok = (hstd >= Hstd_th[0]) & (hstd <= Hstd_th[1])
            fail = can_test & (~ok)

            # --- first reversal (not yet reversed, test failed) ---
            first_fail = fail & (~reversed_)
            room = (leapfrog_steps - i) > pos
            #   room: go back to center, flip momentum, continue backward
            u_r = th_buf[C]
            p_r = -p_buf[C]
            #   no room: wrap onto the forward arm at pos - (steps remaining)
            pos_new1 = pos - leapfrog_steps + i
            u_w = th_buf[C + pos_new1]
            p_w = -p_buf[C + pos_new1]

            # --- second reversal (already reversed, test failed): stop, wrap ---
            second_fail = fail & reversed_
            seg = (rev_pos - pos) * 2
            r = jnp.where(seg > 0, (leapfrog_steps - i) % jnp.maximum(seg, 1), 0)
            pos_new2 = jnp.where(r > (rev_pos - pos), 2 * rev_pos - r - pos, pos + r)
            u_w2 = th_buf[C + pos_new2]
            p_w2 = p_buf[C + pos_new2]

            # select next state
            next_u = jnp.where(
                second_fail, u_w2, jnp.where(first_fail, jnp.where(room, u_r, u_w), u)
            )
            next_p = jnp.where(
                second_fail, p_w2, jnp.where(first_fail, jnp.where(room, p_r, p_w), p)
            )
            next_done = done | second_fail | (first_fail & (~room))
            next_rev = jnp.where(first_fail & room, pos, rev_pos)
            #   reference: pos=-1 and i += pos on reversal-with-room (hmc.py:140-141)
            next_i = jnp.where(first_fail & room, i - 1, i)
            next_pos = jnp.where(
                first_fail & room, -1, jnp.where(reversed_, pos - 1, pos + 1)
            )
            return (
                next_u,
                next_p,
                th_buf,
                p_buf,
                H_buf,
                next_pos,
                next_i,
                next_rev,
                next_done,
                jnp.where(next_done & ~done, next_u, fu),
                jnp.where(next_done & ~done, next_p, fp),
            )

        init = (
            u0_,
            p0_,
            th_buf,
            p_buf,
            H_buf,
            jnp.asarray(1),
            jnp.asarray(0),
            jnp.asarray(0),
            jnp.asarray(False),
            u0_,
            p0_,
        )
        out = lax.while_loop(cond, body, init)
        u, p, done, fu, fp = out[0], out[1], out[8], out[9], out[10]
        return jnp.where(done, fu, u), jnp.where(done, fp, p)

    def step(u, k):
        k1, k2, k3 = jax.random.split(k, 3)
        eps = jnp.exp(log_lo + jax.random.uniform(k1, dtype=u.dtype) * (log_hi - log_lo))
        p = jax.random.normal(k2, (dim,), dtype=u.dtype)
        H_old = H_of(u, p)
        u_new, p_new = trajectory(u, p, eps)
        H_new = H_of(u_new, p_new)
        accept = jnp.log(jax.random.uniform(k3, dtype=u.dtype)) < jnp.minimum(
            H_old - H_new, 0.0
        )
        accept = accept & jnp.all(jnp.isfinite(u_new)) & jnp.isfinite(H_new)
        u = jnp.where(accept, u_new, u)
        return u, (u, accept.astype(u.dtype))

    keys = jax.random.split(key, num_samples)
    _, (samples, accepts) = lax.scan(step, u0, keys)
    return samples, jnp.mean(accepts)
