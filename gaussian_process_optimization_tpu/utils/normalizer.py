"""Y-normalization (GPy/GPy/util/normalizer.py:9 `Standardize`, and GPyOpt's 'stats'
normalization (Y-mean)/std used by the BO loop, GPyOpt/GPyOpt/util/general.py:203-217)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .pytree import pytree_dataclass


@pytree_dataclass
class Standardize:
    mean: jnp.ndarray = None
    std: jnp.ndarray = None

    @classmethod
    def fit(cls, Y):
        Y = jnp.asarray(Y)
        mean = jnp.mean(Y, axis=0)
        std = jnp.std(Y, axis=0)
        std = jnp.where(std <= 0, 1.0, std)
        return cls(mean=mean, std=std)

    def normalize(self, Y):
        return (Y - self.mean) / self.std

    def inverse_mean(self, mu):
        return mu * self.std + self.mean

    def inverse_variance(self, var):
        return var * jnp.square(self.std)

    def inverse_covariance(self, cov):
        # single-output: cov * std^2
        return cov * jnp.square(self.std).reshape(-1)[0]


def normalize_stats(Y):
    """GPyOpt 'stats' normalization (util/general.py:211): (Y - mean)/std, with the
    degenerate all-equal case falling back to mean-centering.

    Host numpy on purpose: this is per-iteration data prep in the BO loop
    (bo_loop._update_model), and the eager-jnp version cost several device
    dispatches plus a device->host fetch per suggest call for microseconds of
    math."""
    Y = np.asarray(Y)
    m = float(np.mean(Y))
    s = float(np.std(Y))
    return (Y - m) / s if s > 0 else Y - m
