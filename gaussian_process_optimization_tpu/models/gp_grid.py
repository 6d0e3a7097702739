"""Kronecker (grid) GP regression.

Rebuild of ``GPy/GPy/models/gp_grid_regression.py`` + ``GPy/GPy/core/gp_grid.py`` +
``GPy/GPy/inference/latent_function_inference/gaussian_grid_inference.py``: inputs on
a Cartesian grid X = X_1 x ... x X_D with a product kernel make
K = K_1 (x) ... (x) K_D; eigendecomposition per factor gives exact O(sum n_i^3)
inference instead of O((prod n_i)^3).

Notes: per-factor ``eigh`` + a chain of axis-wise tensordots (kron matvec) — all
matmuls; no giant Gram matrix is ever materialized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..kernels.base import Kernel
from ..utils.pytree import pytree_dataclass, static_field

LOG_2_PI = float(np.log(2 * np.pi))


def _kron_mv(mats, y_tensor):
    """(A_1 (x) ... (x) A_D) vec(y): apply each factor along its axis."""
    out = y_tensor
    d = len(mats)
    for axis, A in enumerate(mats):
        out = jnp.tensordot(A, out, axes=([1], [axis]))
        # tensordot moves the contracted axis to front; rotate back
        out = jnp.moveaxis(out, 0, axis)
    return out


@pytree_dataclass
class GPGridRegression:
    """Exact GP on a Cartesian grid with a product kernel."""

    kerns: tuple = ()  # one Kernel per grid axis
    likelihood_variance: jnp.ndarray = None
    axes: tuple = ()  # per-axis input arrays (n_i, d_i)
    Y: jnp.ndarray = None  # (n_1, ..., n_D)

    @classmethod
    def create(cls, axes, Y, kernels, noise_var=0.1):
        axes = tuple(jnp.atleast_2d(jnp.asarray(a, dtype=float).reshape(len(a), -1))
                     for a in axes)
        shape = tuple(a.shape[0] for a in axes)
        Y = jnp.asarray(Y, dtype=float).reshape(shape)
        return cls(
            kerns=tuple(kernels),
            likelihood_variance=jnp.asarray(noise_var, dtype=float).reshape(()),
            axes=axes,
            Y=Y,
        )

    def _eigs(self):
        Qs, lams = [], []
        for k, a in zip(self.kerns, self.axes):
            K = k.K(a)
            lam, Q = jnp.linalg.eigh(K)
            Qs.append(Q)
            lams.append(jnp.maximum(lam, 0.0))
        return Qs, lams

    def _lam_kron(self, lams):
        lam = lams[0]
        for l in lams[1:]:
            lam = (lam[:, None] * l[None, :]).reshape(-1)
        return lam

    def log_marginal_likelihood(self):
        Qs, lams = self._eigs()
        sigma2 = self.likelihood_variance + config.noise_jitter
        lam = self._lam_kron(lams) + sigma2
        Qt_y = _kron_mv([Q.T for Q in Qs], self.Y).reshape(-1)
        n = Qt_y.shape[0]
        quad = jnp.sum(jnp.square(Qt_y) / lam)
        return -0.5 * (n * LOG_2_PI + jnp.sum(jnp.log(lam)) + quad)

    def _alpha(self, Qs, lams):
        sigma2 = self.likelihood_variance + config.noise_jitter
        lam = self._lam_kron(lams) + sigma2
        Qt_y = _kron_mv([Q.T for Q in Qs], self.Y).reshape(-1)
        shape = self.Y.shape
        inner = (Qt_y / lam).reshape(shape)
        return _kron_mv(Qs, inner)  # alpha tensor, (K + s2 I)^-1 y

    def predict(self, Xnew, include_likelihood=True):
        """Mean/var at arbitrary points Xnew (n, sum d_i): per-point row-kron of the
        cross-covariances."""
        Qs, lams = self._eigs()
        sigma2 = self.likelihood_variance + config.noise_jitter
        lam = self._lam_kron(lams) + sigma2
        alpha = self._alpha(Qs, lams)

        # split Xnew columns per axis
        splits = np.cumsum([a.shape[1] for a in self.axes])[:-1]
        Xnew = jnp.atleast_2d(jnp.asarray(Xnew, dtype=float))
        parts = jnp.split(Xnew, splits, axis=1)

        def one(x_parts):
            ks = [k.K(a, xp[None, :])[:, 0] for k, a, xp in
                  zip(self.kerns, self.axes, x_parts)]
            # mean: contract k_1 (x) ... (x) k_D against alpha
            m = alpha
            for i, kv in enumerate(ks):
                m = jnp.tensordot(kv, m, axes=([0], [0]))
            # var: k** - sum_j (Q^T kstar)_j^2 / lam_j
            v_parts = [Q.T @ kv for Q, kv in zip(Qs, ks)]
            v = v_parts[0]
            for vp in v_parts[1:]:
                v = (v[:, None] * vp[None, :]).reshape(-1)
            kss = 1.0
            for k, xp in zip(self.kerns, x_parts):
                kss = kss * k.Kdiag(xp[None, :])[0]
            var = kss - jnp.sum(jnp.square(v) / lam)
            return m, jnp.clip(var, 1e-15, None)

        mus, vars_ = jax.vmap(lambda row: one(jnp.split(row, splits)))(Xnew)
        if include_likelihood:
            vars_ = vars_ + self.likelihood_variance
        return mus[:, None], vars_[:, None]
