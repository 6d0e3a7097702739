"""User-expression ("symbolic") kernel (GPy kern/src/symbolic.py:8).

The reference takes a sympy expression k(x, z; theta), lambdifies it, and
hand-assembles symbolic derivatives for update_gradients_full/gradients_X
(symbolic.py:48-75); the whole class is gated on `import sympy` (absent in
this environment, as upstream allows).

JAX-native replacement: the expression is any JAX-traceable python callable
``k(x, z, params) -> scalar`` over single points — jax.grad IS the symbolic
differentiation engine, so the sympy dependency disappears while keeping the
same capability (user-defined covariance with exact derivatives). When sympy
IS installed, ``SymbolicKernel.from_sympy`` lambdifies a sympy expression to
jnp and wraps it the same way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field
from .base import Kernel


@pytree_dataclass
class SymbolicKernel(Kernel):
    """K[i, j] = expr(X[i], X2[j], params); params is a dict pytree of trainable
    array leaves (positivity etc. by field naming, models/parameters.py)."""

    params: dict = None
    expr: callable = static_field(default=None)

    @classmethod
    def create(cls, input_dim, expr, params=None, active_dims=None):
        params = {k: jnp.asarray(v, dtype=float)
                  for k, v in (params or {}).items()}
        return cls(
            input_dim=input_dim,
            active_dims=tuple(active_dims) if active_dims is not None else None,
            params=params, expr=expr,
        )

    @classmethod
    def from_sympy(cls, input_dim, sym_expr, x_syms, z_syms, param_syms,
                   params=None, active_dims=None):
        """Lambdify a sympy expression to jnp (requires sympy; gated like the
        reference — symbolic.py:2 `import sympy`)."""
        try:
            import sympy
        except ImportError as e:  # pragma: no cover - sympy absent in CI env
            raise ImportError(
                "SymbolicKernel.from_sympy requires sympy (not installed); "
                "pass a JAX callable to SymbolicKernel.create instead"
            ) from e
        names = [str(s) for s in param_syms]
        f = sympy.lambdify(list(x_syms) + list(z_syms) + list(param_syms),
                           sym_expr, modules=jnp)

        def expr(x, z, p):
            return f(*x, *z, *[p[n] for n in names])

        return cls.create(input_dim, expr, params=params,
                          active_dims=active_dims)

    def K(self, X, X2=None):
        X = self._slice(X)
        X2c = X if X2 is None else self._slice(X2)
        f = lambda x, z: self.expr(x, z, self.params)
        return jax.vmap(lambda x: jax.vmap(lambda z: f(x, z))(X2c))(X)

    def Kdiag(self, X):
        X = self._slice(X)
        return jax.vmap(lambda x: self.expr(x, x, self.params))(X)
