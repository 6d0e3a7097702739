"""Affine-invariant ensemble sampler (Goodman & Weare stretch moves) —
JAX rebuild of GPyOpt's emcee-backed ``util/mcmc_sampler.py:31``
``AffineInvariantEnsembleSampler`` (used by Entropy Search to draw representer
points from an acquisition-proportional density, acquisitions/ES.py:11).

The whole chain is one jitted ``lax.scan``; the two half-ensembles update
alternately so every move is a big vmapped batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def ensemble_sample(log_prob_fn, lower, upper, n_walkers, n_steps, key, a=2.0,
                    init=None):
    """Sample from exp(log_prob) over the box [lower, upper].

    Returns (chain (n_steps, n_walkers, d), final_walkers). log_prob_fn must accept
    a batch (n, d) -> (n,). Out-of-box proposals get -inf (the reference bounds its
    walkers to the domain the same way).
    """
    d = lower.shape[0]
    k_init, k_run = jax.random.split(key)
    if init is None:
        init = jax.random.uniform(
            k_init, (n_walkers, d), minval=lower, maxval=upper, dtype=lower.dtype
        )
    half = n_walkers // 2

    def bounded_log_prob(x):
        inside = jnp.all((x >= lower) & (x <= upper), axis=-1)
        lp = log_prob_fn(x)
        return jnp.where(inside, lp, -jnp.inf)

    def move(walkers, lp, idx_move, idx_other, key):
        k1, k2, k3 = jax.random.split(key, 3)
        n_move = idx_move.shape[0]
        # stretch move: z ~ g(z) prop 1/sqrt(z) on [1/a, a]
        u = jax.random.uniform(k1, (n_move,), dtype=walkers.dtype)
        z = jnp.square(u * (jnp.sqrt(a) - 1.0 / jnp.sqrt(a)) + 1.0 / jnp.sqrt(a))
        partner = jax.random.randint(k2, (n_move,), 0, idx_other.shape[0])
        x_other = walkers[idx_other[partner]]
        x_move = walkers[idx_move]
        proposal = x_other + z[:, None] * (x_move - x_other)
        lp_prop = bounded_log_prob(proposal)
        log_accept = (d - 1) * jnp.log(z) + lp_prop - lp[idx_move]
        accept = jnp.log(jax.random.uniform(k3, (n_move,), dtype=walkers.dtype)) < log_accept
        new_x = jnp.where(accept[:, None], proposal, x_move)
        new_lp = jnp.where(accept, lp_prop, lp[idx_move])
        walkers = walkers.at[idx_move].set(new_x)
        lp = lp.at[idx_move].set(new_lp)
        return walkers, lp

    idx_a = jnp.arange(half)
    idx_b = jnp.arange(half, n_walkers)

    def step(carry, key):
        walkers, lp = carry
        ka, kb = jax.random.split(key)
        walkers, lp = move(walkers, lp, idx_a, idx_b, ka)
        walkers, lp = move(walkers, lp, idx_b, idx_a, kb)
        return (walkers, lp), walkers

    lp0 = bounded_log_prob(init)
    keys = jax.random.split(k_run, n_steps)
    (walkers, _), chain = lax.scan(step, (init, lp0), keys)
    return chain, walkers


class AffineInvariantEnsembleSampler:
    """GPyOpt-parity wrapper (util/mcmc_sampler.py:31): get_samples(n, log_p, burn)."""

    def __init__(self, space, seed=0):
        self.space = space
        self._key = jax.random.PRNGKey(seed)

    def get_samples(self, n_samples, log_p_function, burn_in_steps=50):
        import numpy as np

        bounds = self.space.get_bounds()
        lower = jnp.asarray([b[0] for b in bounds], dtype=float)
        upper = jnp.asarray([b[1] for b in bounds], dtype=float)
        n_walkers = max(2 * len(bounds) + 2, n_samples)
        if n_walkers % 2:
            n_walkers += 1
        self._key, sub = jax.random.split(self._key)

        def lp(x):
            return jnp.asarray(log_p_function(x)).reshape(-1)

        chain, walkers = ensemble_sample(
            lp, lower, upper, n_walkers, burn_in_steps + 1, sub
        )
        samples = np.asarray(walkers)[:n_samples]
        return samples, np.asarray(lp(jnp.asarray(samples))).reshape(-1, 1)
