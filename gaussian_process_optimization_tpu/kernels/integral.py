"""Integral kernel (GPy/GPy/kern/src/integral.py:10): a GP over a latent rate
f with RBF covariance k_ff, observed through its running integral
F(t) = int_0^t f(s) ds.

- K(X)        -> k_xx: Cov[F(t), F(t')], the double integral of k_ff
                 (integral.py:51-52, via g(z) = z sqrt(pi) erf(z) + e^{-z^2})
- K(X, X2)    -> k_xf: Cov[F(t), f(t')] (integral.py:58-59)
- Kdiag(X)    -> k_ff diag (integral.py:76-83's hack, kept for API parity)

The reference computes every entry in a Python double loop; here the closed
forms evaluate on full (N, M) grids (elementwise + erf). 1-D inputs.
tests/test_periodic_rkhs.py checks k_xx/k_xf against numerical quadrature of
k_ff and gradient-consistency through the LML.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .base import Kernel


def _g(z):
    """(integral.py:47-48)"""
    return z * jnp.sqrt(jnp.pi) * jax.scipy.special.erf(z) + jnp.exp(-(z**2))


@pytree_dataclass
class Integral(Kernel):
    variances: jnp.ndarray = None
    lengthscale: jnp.ndarray = None

    @classmethod
    def create(cls, input_dim=1, variances=1.0, lengthscale=1.0, active_dims=None):
        assert input_dim == 1, "Integral kernel is 1-D (integral.py:15-25)"
        return cls(
            input_dim=1,
            active_dims=tuple(active_dims) if active_dims is not None else None,
            variances=jnp.asarray(variances, dtype=float).reshape(()),
            lengthscale=jnp.asarray(lengthscale, dtype=float).reshape(()),
        )

    def k_xx(self, t, tprime):
        """Cov of the integrals: 0.5 l^2 (g(t/l) - g((t-t')/l) + g(t'/l) - 1)."""
        l = self.lengthscale
        return 0.5 * l**2 * (_g(t / l) - _g((t - tprime) / l) + _g(tprime / l) - 1.0)

    def k_xf(self, t, tprime):
        """Cov of integral vs latent: 0.5 sqrt(pi) l (erf((t-t')/l) + erf(t'/l))."""
        l = self.lengthscale
        erf = jax.scipy.special.erf
        return 0.5 * jnp.sqrt(jnp.pi) * l * (erf((t - tprime) / l) + erf(tprime / l))

    def k_ff(self, t, tprime):
        return jnp.exp(-jnp.square(t - tprime) / jnp.square(self.lengthscale))

    def K(self, X, X2=None):
        X = self._slice(X)
        t = X[:, 0]
        if X2 is None:
            return self.variances * self.k_xx(t[:, None], t[None, :])
        X2 = self._slice(X2)
        return self.variances * self.k_xf(t[:, None], X2[:, 0][None, :])

    def Kdiag(self, X):
        X = self._slice(X)
        t = X[:, 0]
        return self.variances * self.k_ff(t, t)


@pytree_dataclass
class IntegralLimits(Kernel):
    """Integral observations over per-row windows [s, t]
    (GPy kern/src/integral_limits.py:10): each input row is (t, s) and the
    observation is int_s^t f(u) du for a latent RBF f.

    k_xx(t,t',s,s') = 0.5 l^2 [g((t-s')/l) + g((t'-s)/l) - g((t-t')/l) - g((s-s')/l)]
    k_xf(t,t',s)    = 0.5 sqrt(pi) l [erf((t-t')/l) + erf((t'-s)/l)]
    (integral_limits.py:55-75), vectorized over full grids.
    """

    variances: jnp.ndarray = None
    lengthscale: jnp.ndarray = None

    @classmethod
    def create(cls, input_dim=2, variances=1.0, lengthscale=1.0, active_dims=None):
        assert input_dim == 2, "IntegralLimits takes (t, s) rows"
        return cls(
            input_dim=2,
            active_dims=tuple(active_dims) if active_dims is not None else None,
            variances=jnp.asarray(variances, dtype=float).reshape(()),
            lengthscale=jnp.asarray(lengthscale, dtype=float).reshape(()),
        )

    def _kxx(self, t, tp, s, sp):
        l = self.lengthscale
        return 0.5 * l**2 * (_g((t - sp) / l) + _g((tp - s) / l)
                             - _g((t - tp) / l) - _g((s - sp) / l))

    def K(self, X, X2=None):
        X = self._slice(X)
        t, s = X[:, 0], X[:, 1]
        if X2 is None:
            return self.variances * self._kxx(
                t[:, None], t[None, :], s[:, None], s[None, :]
            )
        X2 = self._slice(X2)
        tp = X2[:, 0]
        erf = jax.scipy.special.erf
        l = self.lengthscale
        k_xf = 0.5 * jnp.sqrt(jnp.pi) * l * (
            erf((t[:, None] - tp[None, :]) / l)
            + erf((tp[None, :] - s[:, None]) / l)
        )
        return self.variances * k_xf

    def Kdiag(self, X):
        X = self._slice(X)
        return self.variances * jnp.ones((X.shape[0],), dtype=X.dtype)


@pytree_dataclass
class MultidimensionalIntegralLimits(Kernel):
    """Product of per-dimension IntegralLimits factors
    (GPy kern/src/multidimensional_integral_limits.py): row layout
    (t_1, s_1, t_2, s_2, ...), one lengthscale per dimension."""

    variances: jnp.ndarray = None
    lengthscale: jnp.ndarray = None  # (D,)

    @classmethod
    def create(cls, input_dim, variances=1.0, lengthscale=None, active_dims=None):
        assert input_dim % 2 == 0, "row layout is (t_d, s_d) pairs"
        d = input_dim // 2
        if lengthscale is None:
            lengthscale = jnp.ones((d,))
        return cls(
            input_dim=input_dim,
            active_dims=tuple(active_dims) if active_dims is not None else None,
            variances=jnp.asarray(variances, dtype=float).reshape(()),
            lengthscale=jnp.broadcast_to(
                jnp.asarray(lengthscale, dtype=float).reshape(-1), (d,)),
        )

    def K(self, X, X2=None):
        X = self._slice(X)
        d = self.lengthscale.shape[0]
        out = None
        erf = jax.scipy.special.erf
        for q in range(d):
            l = self.lengthscale[q]
            t, s = X[:, 2 * q], X[:, 2 * q + 1]
            if X2 is None:
                f = 0.5 * l**2 * (
                    _g((t[:, None] - s[None, :]) / l)
                    + _g((t[None, :] - s[:, None]) / l)
                    - _g((t[:, None] - t[None, :]) / l)
                    - _g((s[:, None] - s[None, :]) / l)
                )
            else:
                tp = self._slice(X2)[:, 2 * q]
                f = 0.5 * jnp.sqrt(jnp.pi) * l * (
                    erf((t[:, None] - tp[None, :]) / l)
                    + erf((tp[None, :] - s[:, None]) / l)
                )
            out = f if out is None else out * f
        return self.variances * out

    def Kdiag(self, X):
        return self.variances * jnp.ones((X.shape[0],), dtype=X.dtype)
