"""Packed-triangular Cholesky utilities (GPy/GPy/util/choleskies.py +
choleskies_cython.pyx): flat <-> lower-triangular packing for per-output Cholesky
factors, used by SVGP's variational covariance parameterization.

The reference's Cython `backprop_gradient` (reverse-mode Cholesky derivative,
choleskies_cython.pyx:48-80) exists here as the custom VJP on ops.linalg.jitchol and
as the standalone `backprop_gradient` below (two triangular solves).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def _tri_indices(m):
    return np.tril_indices(m)


def flat_to_triang(flat, m=None):
    """(num_tri, P) -> (P, M, M) lower-triangular (choleskies.py flat_to_triang)."""
    flat = jnp.asarray(flat)
    num_tri = flat.shape[0]
    if m is None:
        m = int((np.sqrt(8 * num_tri + 1) - 1) / 2)
    rows, cols = _tri_indices(m)
    p = flat.shape[1]
    out = jnp.zeros((p, m, m), dtype=flat.dtype)
    return out.at[:, rows, cols].set(flat.T)


def triang_to_flat(L):
    """(P, M, M) -> (num_tri, P) (choleskies.py triang_to_flat)."""
    L = jnp.asarray(L)
    m = L.shape[-1]
    rows, cols = _tri_indices(m)
    return L[:, rows, cols].T


def backprop_gradient(dL, L):
    """Reverse-mode derivative of the Cholesky decomposition: given dF/dL and L,
    return dF/dA where A = L L^T (choleskies_cython.pyx:48; Murray 2016).
    Implemented as two triangular solves."""
    from .linalg import _phi

    dL = jnp.tril(dL)
    P = _phi(L.T @ dL)  # shared with linalg._jitchol_bwd — one pullback to fix
    tmp = lax.linalg.triangular_solve(L, P, left_side=True, lower=True, transpose_a=True)
    S = lax.linalg.triangular_solve(
        L, tmp.T, left_side=True, lower=True, transpose_a=True
    ).T
    return 0.5 * (S + S.T)


def indexes_to_fix_for_low_rank(rank, size):
    """(choleskies.py) indices of a flat triangular array to fix at zero to emulate a
    low-rank covariance."""
    fixed = []
    rows, cols = _tri_indices(size)
    for i, (r, c) in enumerate(zip(rows, cols)):
        if c >= rank and r != c:
            fixed.append(i)
        # diagonal entries beyond the rank are kept (jitter-like), matching GPy
    return fixed
