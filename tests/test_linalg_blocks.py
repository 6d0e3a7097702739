"""The blocked factorization stack on its diagonal-block shapes, against LAPACK.

`blocked_cholesky` and `tri_inv_lower` factor / invert their diagonal blocks as
ONE batched XLA op over all lanes (cuSOLVER / cuBLAS on a GPU). These cases run
them at the (lanes, size) shapes those batched ops see, with blocks small enough
that the blocked path (not the whole-matrix fallback) is taken, and check the
properties the jitter ladder relies on: NaN confined to a failed lane, vmap,
and the unbatched / small-n fallbacks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_optimization_tpu.ops import linalg as la


def _spd(rng, G, n):
    X = rng.standard_normal((G, n, n))
    return X @ np.swapaxes(X, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("G,n", [(1, 32), (5, 64), (3, 128)])
def test_blocked_cholesky_matches_lapack(G, n, rng):
    A = _spd(rng, G, n)
    L = np.asarray(la.blocked_cholesky(jnp.asarray(A), nb=n // 4))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-9, atol=1e-9)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("G,n", [(2, 32), (5, 64), (3, 128)])
def test_tri_inv_lower_matches_lapack(G, n, rng):
    L = np.linalg.cholesky(_spd(rng, G, n))
    Li = np.asarray(la.tri_inv_lower(jnp.asarray(L), block=n // 4))
    np.testing.assert_allclose(Li, np.linalg.inv(L), rtol=1e-8, atol=1e-10)
    assert np.all(np.triu(Li, 1) == 0.0)


def test_nonpd_lane_reports_nonfinite_only_there(rng):
    """The jitter ladder's per-lane finiteness check relies on NaN locality:
    a lane that fails in a late panel poisons only itself."""
    n = 64
    A = _spd(rng, 3, n)
    A[1, n - 5, n - 5] = -1.0
    L = np.asarray(la.blocked_cholesky(jnp.asarray(A), nb=16))
    assert np.all(np.isfinite(L[0])) and np.all(np.isfinite(L[2]))
    assert not np.all(np.isfinite(L[1]))
    np.testing.assert_allclose(L[[0, 2]], np.linalg.cholesky(A[[0, 2]]),
                               rtol=1e-9, atol=1e-9)
    _, _, ok, rung = la.jitchol_full(jnp.asarray(A))
    assert [bool(v) for v in ok] == [True, False, True]
    assert [int(v) for v in rung][::2] == [0, 0]


def test_vmap_over_blocked_ops(rng):
    """vmap over blocked_cholesky and tri_inv_lower matches the batched call."""
    A = _spd(rng, 6, 64).reshape(2, 3, 64, 64)
    chol = jax.vmap(lambda a: la.blocked_cholesky(a, nb=16))
    Lv = np.asarray(chol(jnp.asarray(A)))
    np.testing.assert_allclose(Lv, np.linalg.cholesky(A), rtol=1e-9, atol=1e-9)
    inv = jax.vmap(lambda l: la.tri_inv_lower(l, block=16))
    Li = np.asarray(inv(jnp.asarray(Lv)))
    np.testing.assert_allclose(Li, np.linalg.inv(np.linalg.cholesky(A)),
                               rtol=1e-8, atol=1e-10)


def test_unbatched_and_fallback_shapes(rng):
    # 2-D input (no lane axis), blocked path
    A = _spd(rng, 1, 32)[0]
    L = np.asarray(la.blocked_cholesky(jnp.asarray(A), nb=8))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-9, atol=1e-9)
    # n < 2 nb: the whole-matrix XLA fallback, at a size no block divides
    B = _spd(rng, 2, 17)
    L2 = np.asarray(la.blocked_cholesky(jnp.asarray(B), nb=16))
    np.testing.assert_allclose(L2, np.linalg.cholesky(B), rtol=1e-10)
    Li2 = np.asarray(la.tri_inv_lower(jnp.asarray(L2), block=16))
    np.testing.assert_allclose(Li2, np.linalg.inv(L2), rtol=1e-8, atol=1e-12)


def test_blocked_cholesky_float32_ragged_panels(rng):
    """float32 (the on-device dtype) with a last panel narrower than nb."""
    n = 96
    X = rng.standard_normal((2, n, n))
    A = X @ np.swapaxes(X, -1, -2) + n * np.eye(n)
    L = np.asarray(la.blocked_cholesky(jnp.asarray(A, jnp.float32), nb=40))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=5e-4, atol=5e-4)
