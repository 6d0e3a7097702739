"""Stationary (isotropic) kernels: K = K_of_r(scaled distance).

Rebuild of ``GPy/GPy/kern/src/stationary.py`` (Stationary:23, _unscaled_dist:155,
_scaled_dist:176, subclasses Exponential:384, OU:427, Matern32:447, Matern52:546,
ExpQuad:613, Cosine:654, RatQuad:665) and ``rbf.py:12``.

Notes:
- the pairwise distance uses the -2*X@X2^T + |X|^2 + |X2|^2 trick (GPy
  stationary.py:155-173) so the O(N^2 D) work is a single matmul; elementwise
  K_of_r fuses into the matmul output under XLA.
- gradients come from autodiff; the reference's hand-written OpenMP loops
  (stationary_utils.c _grad_X / _lengthscale_grads) are mathematically plain
  contractions which XLA emits as matmuls.
- sqrt at zero distance is made autodiff-safe with a where-guard so dK/dX is exact
  (0) at coincident points.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field
from .base import Kernel


def _dist_matmul(A, B):
    """Full-precision cross term for the distance trick.

    CRITICAL: reduced-precision matmul operands (TF32 on a GPU keeps a 10-bit
    mantissa, ~3 decimal digits) corrupt the -2*X@X2^T cross term by O(1) for
    coordinates of magnitude ~10, making K badly non-PSD (observed: eigenvalue
    -0.23 on Branin-scale inputs). Precision.HIGHEST forces IEEE float32.
    """
    from jax import lax

    return jnp.matmul(A, B, precision=lax.Precision.HIGHEST)


def sq_dist(X, X2=None):
    """Pairwise squared Euclidean distance, clipped at 0 (GPy _unscaled_dist:155)."""
    if X2 is None:
        Xsq = jnp.sum(jnp.square(X), axis=-1)
        r2 = -2.0 * _dist_matmul(X, X.T) + Xsq[:, None] + Xsq[None, :]
        r2 = jnp.maximum(r2, 0.0)
        # exact zeros on the diagonal (GPy sets them explicitly)
        n = X.shape[0]
        r2 = r2 * (1.0 - jnp.eye(n, dtype=X.dtype))
        return r2
    X1sq = jnp.sum(jnp.square(X), axis=-1)
    X2sq = jnp.sum(jnp.square(X2), axis=-1)
    r2 = -2.0 * _dist_matmul(X, X2.T) + X1sq[:, None] + X2sq[None, :]
    # value == max(r2, 0) but the gradient passes through UNCHANGED: the clamp
    # only repairs FP cancellation, and jnp.maximum's 50/50 tie gradient at
    # r2 == 0 would halve d2K/dx1 dx2 exactly at x1 == x2 where
    # predict_jacobian evaluates it
    from jax import lax

    return r2 - lax.stop_gradient(jnp.minimum(r2, 0.0))


def safe_sqrt(r2):
    """sqrt with zero (not NaN) gradient at r2 == 0."""
    zero = r2 == 0.0
    safe = jnp.where(zero, 1.0, r2)
    return jnp.where(zero, 0.0, jnp.sqrt(safe))


@pytree_dataclass
class Stationary(Kernel):
    variance: jnp.ndarray = None
    lengthscale: jnp.ndarray = None

    @classmethod
    def create(
        cls,
        input_dim,
        variance=1.0,
        lengthscale=None,
        ARD=False,
        active_dims=None,
        **extra,
    ):
        """GPy-style constructor (stationary.py:61-83): non-ARD gets a scalar
        lengthscale; ARD broadcasts to one lengthscale per input dim."""
        if lengthscale is None:
            lengthscale = jnp.ones((input_dim,)) if ARD else jnp.ones(())
        else:
            lengthscale = jnp.asarray(lengthscale, dtype=float)
            if ARD:
                lengthscale = jnp.broadcast_to(lengthscale, (input_dim,))
            else:
                lengthscale = lengthscale.reshape(())
        return cls(
            input_dim=input_dim,
            active_dims=tuple(active_dims) if active_dims is not None else None,
            variance=jnp.asarray(variance, dtype=float).reshape(()),
            lengthscale=lengthscale,
            **extra,
        )

    def input_sensitivity(self, summarize=True):
        """variance / lengthscale^2 per dim (GPy stationary.py:270
        input_sensitivity) — the ARD relevance used by plot_ARD."""
        return jnp.broadcast_to(self.variance / self.lengthscale**2,
                                (self.input_dim,))

    # --- the subclass contract (GPy stationary.py:92-97) ---
    def K_of_r(self, r):
        raise NotImplementedError

    # Kernels that are smooth functions of the SQUARED distance (RBF, RatQuad)
    # override K_of_r2; K() then skips the sqrt entirely, which both saves the
    # op and keeps SECOND derivatives exact at r == 0 (safe_sqrt's where-guard
    # zeroes them, losing the prior curvature d2k/dx dx' = v/l^2 that
    # predict_jacobian / gradients_XX need — GPy computes those analytically,
    # stationary.py:108-140).
    K_of_r2 = None

    def dK_dr(self, r):
        import jax

        return jax.grad(lambda rr: jnp.sum(self.K_of_r(rr)))(r)

    # --- distances ---
    def _scaled_dist(self, X, X2=None):
        """r scaled by lengthscale; ARD divides per-dim first (GPy :176-190)."""
        if self.lengthscale.ndim > 0 and self.lengthscale.shape[-1] > 1:
            Xs = X / self.lengthscale
            X2s = None if X2 is None else X2 / self.lengthscale
            return safe_sqrt(sq_dist(Xs, X2s))
        return safe_sqrt(sq_dist(X, X2)) / self.lengthscale

    def _scaled_dist2(self, X, X2=None):
        """r^2 scaled by lengthscale, sqrt-free (for K_of_r2 kernels)."""
        if self.lengthscale.ndim > 0 and self.lengthscale.shape[-1] > 1:
            Xs = X / self.lengthscale
            X2s = None if X2 is None else X2 / self.lengthscale
            return sq_dist(Xs, X2s)
        return sq_dist(X, X2) / jnp.square(self.lengthscale)

    def curvature0(self):
        """-2 * d(K_of_r2)/d(r2) at r2 == 0 (r2 in lengthscale-scaled units):
        the diagonal curvature d2k/dx_a dx'_a of the kernel at coincident
        points equals curvature0 / lengthscale_a^2. GPy reaches the same limit
        inside each kernel's hand-written dK2_drdr (stationary.py:108-140).
        Derived by AD from K_of_r2 when available; sqrt-family subclasses
        supply the analytic constant; Exponential/OU are not twice
        differentiable at r=0 and raise."""
        import jax

        if self.K_of_r2 is not None:
            u0 = jnp.zeros((), dtype=jnp.result_type(self.variance, float))
            return -2.0 * jax.grad(lambda u: self.K_of_r2(u))(u0)
        raise NotImplementedError(
            f"{type(self).__name__} has no diagonal curvature "
            "(not C^2 at r=0, or curvature0 not implemented)")

    def d2K_dXdX2_diag(self, x):
        """Analytic prior curvature at the diagonal: curvature0/l_a^2 on the
        kernel's active dims, 0 elsewhere (nested AD through safe_sqrt would
        silently return 0 for the sqrt-family kernels — see Kernel base)."""
        c = self.curvature0()
        vec = jnp.broadcast_to(c / jnp.square(self.lengthscale),
                               (self.input_dim,))
        D = x.shape[-1]
        idx = jnp.asarray(self.active_dims if self.active_dims is not None
                          else tuple(range(self.input_dim)))
        return jnp.zeros((D, D), dtype=vec.dtype).at[idx, idx].set(vec)

    def K(self, X, X2=None):
        import jax

        X = self._slice(X)
        X2 = self._slice(X2)
        with jax.named_scope("k_build"):  # profiler attribution (fit_trace.py)
            if self.K_of_r2 is not None:
                return self.K_of_r2(self._scaled_dist2(X, X2))
            return self.K_of_r(self._scaled_dist(X, X2))

    def Kdiag(self, X):
        X = self._slice(X)
        return jnp.full((X.shape[0],), 1.0, dtype=X.dtype) * self.variance


@pytree_dataclass
class RBF(Stationary):
    """sigma^2 exp(-r^2/2) (GPy rbf.py:51)."""

    _family = "rbf"

    def K_of_r(self, r):
        return self.variance * jnp.exp(-0.5 * jnp.square(r))

    def K_of_r2(self, r2):
        return self.variance * jnp.exp(-0.5 * r2)

    def dK_dr(self, r):
        return -r * self.K_of_r(r)


# GPy aliases RBF as ExpQuad (stationary.py:613 defines it identically).
ExpQuad = RBF


@pytree_dataclass
class Exponential(Stationary):
    """sigma^2 exp(-r) (GPy stationary.py:384-388) — identical to OU/Matern-1/2."""

    _family = "exponential"

    def K_of_r(self, r):
        return self.variance * jnp.exp(-r)

    def dK_dr(self, r):
        return -self.K_of_r(r)


@pytree_dataclass
class OU(Stationary):
    """Ornstein-Uhlenbeck / Matern-1/2: sigma^2 exp(-r) (GPy stationary.py:427)."""

    _family = "ou"

    def K_of_r(self, r):
        return self.variance * jnp.exp(-r)


@pytree_dataclass
class Matern32(Stationary):
    """sigma^2 (1 + sqrt(3) r) exp(-sqrt(3) r) (GPy stationary.py:447)."""

    _family = "matern32"

    def K_of_r(self, r):
        s3r = jnp.sqrt(3.0) * r
        return self.variance * (1.0 + s3r) * jnp.exp(-s3r)

    def dK_dr(self, r):
        return -3.0 * self.variance * r * jnp.exp(-jnp.sqrt(3.0) * r)

    def curvature0(self):
        # k(u) = v(1+sqrt(3u))exp(-sqrt(3u)) = v(1 - (3/2)u + O(u^{3/2}))
        return 3.0 * self.variance


@pytree_dataclass
class Matern52(Stationary):
    """sigma^2 (1 + sqrt(5) r + 5/3 r^2) exp(-sqrt(5) r) (GPy stationary.py:575)."""

    _family = "matern52"

    def K_of_r(self, r):
        s5r = jnp.sqrt(5.0) * r
        return self.variance * (1.0 + s5r + 5.0 / 3.0 * jnp.square(r)) * jnp.exp(-s5r)

    def curvature0(self):
        # k(u) = v(1+sqrt(5u)+5u/3)exp(-sqrt(5u)) = v(1 - (5/6)u + O(u^{3/2}))
        return 5.0 / 3.0 * self.variance


@pytree_dataclass
class Cosine(Stationary):
    """sigma^2 cos(r) (GPy stationary.py:654)."""

    _family = "cosine"

    def K_of_r(self, r):
        return self.variance * jnp.cos(r)

    def curvature0(self):
        # k(u) = v cos(sqrt(u)) = v(1 - u/2 + O(u^2))
        return self.variance


@pytree_dataclass
class Sinc(Stationary):
    """sigma^2 sinc(2r) — band-limited kernel (GPy stationary.py Sinc)."""

    _family = "sinc"

    def K_of_r(self, r):
        return self.variance * jnp.sinc(2.0 * r / jnp.pi)

    def curvature0(self):
        # k(u) = v sin(2 sqrt(u))/(2 sqrt(u)) = v(1 - (2/3)u + O(u^2))
        return 4.0 / 3.0 * self.variance


@pytree_dataclass
class RatQuad(Stationary):
    """Rational quadratic: sigma^2 (1 + r^2/2)^-power (GPy stationary.py:665)."""

    power: jnp.ndarray = None
    _family = "ratquad"

    @classmethod
    def create(cls, input_dim, variance=1.0, lengthscale=None, power=2.0, ARD=False, active_dims=None):
        return super().create(
            input_dim,
            variance,
            lengthscale,
            ARD,
            active_dims,
            power=jnp.asarray(power, dtype=float).reshape(()),
        )

    def K_of_r(self, r):
        r2 = jnp.square(r)
        # GPy computes via exp(-power * log1p(r2/2)) for stability
        return self.variance * jnp.exp(-self.power * jnp.log1p(r2 / 2.0))

    def K_of_r2(self, r2):
        return self.variance * jnp.exp(-self.power * jnp.log1p(r2 / 2.0))
