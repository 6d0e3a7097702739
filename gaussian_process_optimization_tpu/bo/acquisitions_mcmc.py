"""MCMC-integrated acquisitions (GPyOpt/GPyOpt/acquisitions/{EI,MPI,LCB}_mcmc.py):
the acquisition averaged over the HMC hyperparameter samples (EI_mcmc.py:29).

Accelerator-first: the per-sample loop is a vmap over the stacked sample-models pytree;
the whole integrated acquisition stays one jittable pure core, so the sweep and
multi-start run exactly like the non-MCMC path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from .acquisitions import AcquisitionBase, get_quantiles


class _MCMCAcquisitionBase(AcquisitionBase):
    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None):
        super().__init__(model, space, optimizer, cost_withGradients)
        assert getattr(model, "MCMC_sampler", False), (
            "Samples from the hyper-parameters are needed to compute the integrated acquisition"
        )

    @property
    def supports_device(self):
        return hasattr(self.model, "device_state_mcmc")

    def device_args(self):
        stacked, fmins = self.model.device_state_mcmc()
        # factor ONCE per argmax: the per-sample posteriors are independent of
        # the candidate X, but computing them inside pure_raw_acq paid S
        # Choleskys on every sweep/line-search evaluation (round-2 review)
        posts = jax.vmap(lambda m: m.inference())(stacked)
        return None, None, None, (stacked, posts, fmins)

    def _sample_acq(self, mdl, posterior, fmin, X):
        raise NotImplementedError

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        stacked, posts, fmins = state

        def one(mdl, post, fm):
            mu, v = mdl.predict(X, posterior=post)
            v = jnp.clip(v, config.variance_floor, None)
            return self._sample_acq(mu, jnp.sqrt(v), fm)

        vals = jax.vmap(one)(stacked, posts, fmins)  # (S, n, 1)
        return jnp.mean(vals, axis=0)


class AcquisitionEI_MCMC(_MCMCAcquisitionBase):
    """(EI_mcmc.py:29)"""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None, jitter=0.01):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def _sample_acq(self, m, s, fmin):
        phi, Phi, _ = get_quantiles(self.jitter, fmin, m, s)
        return (fmin - m + self.jitter) * Phi + s * phi


class AcquisitionMPI_MCMC(_MCMCAcquisitionBase):
    """(MPI_mcmc.py)"""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None, jitter=0.01):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def _sample_acq(self, m, s, fmin):
        _, Phi, _ = get_quantiles(self.jitter, fmin, m, s)
        return Phi


class AcquisitionLCB_MCMC(_MCMCAcquisitionBase):
    """(LCB_mcmc.py) — ignores cost like the plain LCB."""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 exploration_weight=2):
        super().__init__(model, space, optimizer, None)
        self.exploration_weight = exploration_weight

    def _sample_acq(self, m, s, fmin):
        return -m + self.exploration_weight * s
