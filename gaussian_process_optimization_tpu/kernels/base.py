"""Kernel (covariance function) base classes.

Rebuild of the GPy kernel contract (``GPy/GPy/kern/src/kern.py:12``):
``K``, ``Kdiag``, plus ``Add``/``Prod`` combination algebra (``add.py:10``, ``prod.py:24``)
and ``active_dims`` input slicing (``kernel_slice_operations.py``).

Design differences from the reference (functional, autodiff-first):
- Kernels are immutable pytree dataclasses; hyperparameters are array leaves, so
  ``jax.grad`` replaces the hand-written ``update_gradients_full``/``gradients_X``
  plumbing (and their Cython/OpenMP hot loops ``stationary_cython.pyx`` /
  ``stationary_utils.c`` — those contractions become XLA matmuls/reductions).
- No caching layer (paramz ``Cache_this``): under ``jit`` XLA CSE merges repeated
  subexpressions.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Kernel:
    """Abstract covariance function."""

    # Static metadata shared by all kernels.
    input_dim: int = static_field(default=1)
    active_dims: tuple | None = static_field(default=None)

    # --- slicing (GPy kernel_slice_operations metaclass equivalent) ---
    def _slice(self, X):
        if X is None or self.active_dims is None:
            return X
        return X[..., jnp.asarray(self.active_dims)]

    # --- public API ---
    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def _pairwise_diag(self, X):
        """O(N) fallback diagonal: vmapped single-pair K evaluations. For
        kernels whose closed forms live in K (LFM/RKHS families), this replaces
        the diagonal-of-full-K pattern that paid O(N^2) transcendental work for
        an O(N) result, while keeping the formulas single-sourced."""
        import jax

        return jax.vmap(lambda a: self.K(a[None, :], a[None, :])[0, 0])(X)

    # combination algebra
    def __add__(self, other):
        parts = self._flat_parts(Add) + other._flat_parts(Add)
        # propagate the widest member's input_dim — consumers (SplitKern,
        # MultioutputKern) size index columns from it, and the static default
        # of 1 misreports every composite
        return Add(parts=parts, input_dim=max(p.input_dim for p in parts))

    def __mul__(self, other):
        parts = self._flat_parts(Prod) + other._flat_parts(Prod)
        return Prod(parts=parts, input_dim=max(p.input_dim for p in parts))

    def _flat_parts(self, combo_cls):
        if isinstance(self, combo_cls):
            return tuple(self.parts)
        return (self,)

    def input_sensitivity(self, summarize=True):
        """Per-input-dim relevance, used by plot_ARD and the most-significant-
        dims selection in the latent plots (GPy kern.py Kern.input_sensitivity:
        zeros unless a subclass defines a meaningful notion)."""
        return jnp.zeros((self.input_dim,))

    def _scatter_sensitivity(self):
        """This kernel's sensitivity placed at its active_dims positions within
        a length-input_dim vector (GPy CombinationKernel.input_sensitivity)."""
        s = jnp.asarray(self.input_sensitivity())
        if self.active_dims is None:
            return jnp.broadcast_to(s, (self.input_dim,))
        out = jnp.zeros((max(self.active_dims) + 1,))
        return out.at[jnp.asarray(self.active_dims)].set(s)

    # gradients via autodiff (interface parity with GPy Kern.gradients_X,
    # kern.py / stationary.py:271). dL_dK-weighted variants are not needed —
    # jax.grad over any loss of K handles them — but gradients_X is used by
    # predictive_gradients and Lipschitz estimation.
    def gradients_X(self, dL_dK, X, X2=None):
        import jax

        if X2 is None:
            f = lambda Xv: jnp.sum(self.K(Xv) * dL_dK)
        else:
            f = lambda Xv: jnp.sum(self.K(Xv, X2) * dL_dK)
        return jax.grad(f)(X)

    def d2K_dXdX2_diag(self, x):
        """Prior mixed second derivative d2k(x1,x2)/dx1 dx2 at x1 == x2 == x,
        as a (D, D) matrix (D = x.shape[-1]).

        The prior-curvature term of Cov[df/dx] in
        ``GPRegression.predict_jacobian`` (GPy assembles it from hand-written
        ``kern.gradients_XX``, stationary.py:108-140). Default: nested
        forward-mode autodiff of K — exact for kernels smooth at coincident
        inputs (Linear, Bias, and the K_of_r2 stationary family). The
        sqrt-family stationary kernels override with the analytic r->0 limit:
        their K(r(x)) is C^2 only through a cancellation of sqrt terms that
        safe_sqrt's where-guard hides from AD (nested AD returns 0 there).
        """
        import jax

        f = lambda a, b: self.K(a[None, :], b[None, :])[0, 0]
        return jax.jacfwd(jax.jacfwd(f, argnums=0), argnums=1)(x, x)

    def _grad_X1_at_diag(self, x):
        """d k(x1, x2)/dx1 at x1 == x2 == x, shape (D,) — first-order AD is
        exact at the diagonal even for sqrt-family kernels (the guarded sqrt's
        zero gradient IS the correct limit there)."""
        import jax

        return jax.jacfwd(lambda a: self.K(a[None, :], x[None, :])[0, 0])(x)


@pytree_dataclass
class Add(Kernel):
    """Sum of kernels (GPy add.py:10)."""

    parts: tuple = ()

    def K(self, X, X2=None):
        return sum(p.K(X, X2) for p in self.parts)

    def Kdiag(self, X):
        return sum(p.Kdiag(X) for p in self.parts)

    def d2K_dXdX2_diag(self, x):
        return sum(p.d2K_dXdX2_diag(x) for p in self.parts)

    def input_sensitivity(self, summarize=True):
        return _combined_sensitivity(self)


@pytree_dataclass
class Prod(Kernel):
    """Product of kernels (GPy prod.py:24)."""

    parts: tuple = ()

    def K(self, X, X2=None):
        import jax

        # rematerialized: the product chain's autodiff residuals are two (N,N)
        # operand buffers per part (see kernels/gower.py Gower.K) — remat keeps
        # the fit's vjp-carrying line search from hauling them in its carry
        def build(kern, X, X2):
            out = None
            for p in kern.parts:
                k = p.K(X, X2)
                out = k if out is None else out * k
            return out

        return jax.checkpoint(build)(self, X, X2)

    def Kdiag(self, X):
        out = None
        for p in self.parts:
            k = p.Kdiag(X)
            out = k if out is None else out * k
        return out

    def d2K_dXdX2_diag(self, x):
        """Product rule at the diagonal: for F = prod_i k_i,
        d2F/dx1 dx2 = sum_i H_i prod_{j!=i} v_j
                    + sum_{i!=j} g1_i g2_j^T prod_{l not in {i,j}} v_l,
        with v_i = k_i(x,x), g1/g2 the first partials at the diagonal
        (zero for stationary parts, nonzero for e.g. Linear), H_i each part's
        own d2K_dXdX2_diag (GPy prod.py gradients_XX equivalent)."""
        import jax

        parts = self.parts
        v = [p.K(x[None, :], x[None, :])[0, 0] for p in parts]
        g1 = [p._grad_X1_at_diag(x) for p in parts]
        g2 = [jax.jacfwd(lambda b, p=p: p.K(x[None, :], b[None, :])[0, 0])(x)
              for p in parts]
        H = [p.d2K_dXdX2_diag(x) for p in parts]
        n = len(parts)
        out = 0.0
        for i in range(n):
            rest = 1.0
            for j in range(n):
                if j != i:
                    rest = rest * v[j]
            out = out + H[i] * rest
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                rest = 1.0
                for l in range(n):
                    if l != i and l != j:
                        rest = rest * v[l]
                out = out + jnp.outer(g1[i], g2[j]) * rest
        return out

    def input_sensitivity(self, summarize=True):
        return _combined_sensitivity(self)


def _combined_sensitivity(combo):
    """Summed per-dim sensitivity over a combination's parts, each scattered to
    its active_dims (GPy kern.py CombinationKernel.input_sensitivity:592 —
    which also just sums parts when summarize=True)."""
    width = combo.input_dim
    pieces = [p._scatter_sensitivity() for p in combo.parts]
    width = max([width] + [int(p.shape[0]) for p in pieces])
    out = jnp.zeros((width,))
    for s in pieces:
        out = out.at[: s.shape[0]].add(s)
    return out
