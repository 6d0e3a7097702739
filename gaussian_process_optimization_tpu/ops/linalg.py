"""Core dense linear algebra for GP inference, jit-safe.

Rebuild of ``GPy/GPy/util/linalg.py`` (jitchol:56, dtrtrs:95, dpotrs:116,
dpotri:127, pdinv:193, tdot_blas:299, symmetrify:356, backsub_both_sides:381) and the
Cython helpers in ``GPy/GPy/util/linalg_cython.pyx`` (symmetrify, cholupdate). LAPACK
calls become XLA ops on device-resident data (cuSOLVER / cuBLAS on a GPU); the
exception-driven jitter retry becomes a ``lax.while_loop`` ladder (jit-safe, and in
the common case runs exactly one Cholesky).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import config


def tdot(X: jnp.ndarray) -> jnp.ndarray:
    """X @ X.T with symmetric output (GPy tdot_blas, util/linalg.py:299 — DSYRK)."""
    A = jnp.matmul(X, X.T, preferred_element_type=X.dtype)
    return symmetrify(A)


def symmetrify(A: jnp.ndarray, upper: bool = False) -> jnp.ndarray:
    """Force exact symmetry by copying one triangle (GPy util/linalg.py:356).
    Batch-safe: triangles and the transpose act on the last two dims."""
    if upper:
        return jnp.triu(A) + jnp.swapaxes(jnp.triu(A, 1), -1, -2)
    return jnp.tril(A) + jnp.swapaxes(jnp.tril(A, -1), -1, -2)


def _phi(X):
    """Lower triangle with halved diagonal — the Phi operator of the Cholesky pullback
    (Murray 2016; the reference implements this loop in Cython,
    GPy/GPy/util/choleskies_cython.pyx:48-80 `backprop_gradient`)."""
    return jnp.tril(X) - 0.5 * jnp.diag(jnp.diagonal(X))


def blocked_cholesky(A: jnp.ndarray, nb: int = 256) -> jnp.ndarray:
    """Batched blocked left-looking Cholesky (LAPACK potrf blocking, done as a
    statically-unrolled panel loop of BATCHED XLA ops).

    Why not ``jnp.linalg.cholesky`` directly: the restructuring makes every step
    one op over all lanes — the (B, nb, nb) diagonal-block Cholesky amortizes its
    latency over lanes and the (B, m, k)x(B, k, nb) panel updates are batched
    matmuls. It was written for an accelerator whose batched Cholesky ran the
    lanes one after another; whether it beats cuSOLVER's batched potrf on a GPU
    is an open measurement (ROADMAP A4). NaNs from a non-PD diagonal block
    propagate through the solves/updates, so the jitter ladder's finiteness
    check still works.

    Supports any leading batch dims (or none). Falls back to XLA below 2*nb.
    The diagonal-block factorizations run under the ``diag_chol`` name scope so
    a profiler trace can attribute them.
    """
    n = A.shape[-1]
    if n < 2 * nb:
        return jnp.linalg.cholesky(A)
    L = jnp.zeros_like(A)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        Akk = A[..., k0:k1, k0:k1]
        if k0 > 0:
            Lrow = L[..., k0:k1, :k0]
            Akk = Akk - jnp.matmul(Lrow, jnp.swapaxes(Lrow, -1, -2))
        with jax.named_scope("diag_chol"):
            Lkk = jnp.linalg.cholesky(Akk)
        L = L.at[..., k0:k1, k0:k1].set(Lkk)
        if k1 < n:
            Ap = A[..., k1:, k0:k1]
            if k0 > 0:
                Ap = Ap - jnp.matmul(L[..., k1:, :k0],
                                     jnp.swapaxes(L[..., k0:k1, :k0], -1, -2))
            Lp = lax.linalg.triangular_solve(
                Lkk, Ap, left_side=False, lower=True, transpose_a=True)
            L = L.at[..., k1:, k0:k1].set(Lp)
    return L


def tri_tdot(Li: jnp.ndarray, nb: int = 512, precision=None) -> jnp.ndarray:
    """Li^T @ Li for LOWER-triangular Li (the LAPACK `lauum` shape), blocked so
    only the nonzero panel participates in each product — ~2x fewer FLOPs than
    the dense matmul.
    Output is exactly symmetric by construction (the lower block area is the
    written transpose of the upper). Any leading batch dims."""
    n = Li.shape[-1]
    if n < 2 * nb:
        W = jnp.matmul(jnp.swapaxes(Li, -1, -2), Li, precision=precision)
        return symmetrify(W)
    W = jnp.zeros_like(Li)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        # W[k0:k1, k0:] = sum_{k>=k0} Li[k, k0:k1]^T Li[k, k0:]  (rows above k0
        # contribute zeros in these columns, so the shrunk product is exact)
        blk = jnp.matmul(jnp.swapaxes(Li[..., k0:, k0:k1], -1, -2),
                         Li[..., k0:, k0:], precision=precision)
        W = W.at[..., k0:k1, k0:].set(blk)
        if k1 < n:  # mirror into the strictly-lower block area
            W = W.at[..., k1:, k0:k1].set(
                jnp.swapaxes(blk[..., :, k1 - k0:], -1, -2))
    return W


def _jitchol_loop(A, maxtries, k_start=None, greedy=False):
    """Minimal-rung jitter-ladder Cholesky via bidirectional BINARY search.

    GPy's ladder (util/linalg.py:56-74) walks rungs 0, 1, 2, ... sequentially
    and stops at the FIRST success, i.e. it returns the smallest rung whose
    factorization is finite. Success is monotone in the jitter (more diagonal
    mass = more positive-definite), so the same minimal rung can be found by
    binary search: at most 1 + ceil(log2(maxtries + 1)) full factorizations
    instead of rung + 1. Every failed attempt is a FULL batched Cholesky, and an
    ill-conditioned exact fit (Gower kernel, exact_feval noise 1e-6 in f32)
    would otherwise re-climb 5 rungs on every line-search trial.

    `k_start` (float/int, clipped to [0, maxtries]): first rung to probe —
    e.g. the rung the previous refit accepted (carried by the BO wrappers via
    GPRegression.jitter_hint). The result is the SAME minimal rung regardless
    of the hint; a good hint just reaches it in ~2 attempts. k_start == 0
    (the default) keeps the well-conditioned fast path at exactly one
    factorization with zero jitter, as before.

    `greedy=True` drops the downward minimality verification: each lane walks
    the sequential GPy ladder UP from `k_start` and accepts the FIRST success —
    exactly GPy's semantics started at the hint instead of 0 (identical result
    when k_start == 0). Steady state with a sufficient hint is ONE batched
    factorization per call, vs 2-4 for the verified search when per-lane
    minimal rungs straddle the hint (each extra while iteration is a full
    batched Cholesky). The accepted rung may
    exceed the true minimum when the hint overshoots, so greedy is reserved
    for FIT line-search trials where the hint comes from the same model one
    refit earlier; posterior factorizations re-verify minimality and re-anchor
    the hint (models/bo_models.py updateModel).

    Batch-aware: each lane carries its own search interval (a failing lane
    escalates without touching already-factored lanes). Returns
    ``(L, jitter, ok, rung)`` with `jitter`/`ok`/`rung` in the batch shape;
    failed lanes (even the largest jitter non-finite) report ok=False and
    rung = maxtries + 1.
    """
    n = A.shape[-1]
    batch = A.shape[:-2]
    eye = jnp.eye(n, dtype=A.dtype)
    diag_mean = jnp.mean(jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1)  # batch

    def _attempt(k):
        # k: int32 with the batch shape
        jitter = jnp.where(
            k == 0,
            jnp.zeros_like(diag_mean),
            diag_mean * config.jitchol_base * 10.0 ** jnp.maximum(k - 1, 0),
        ).astype(A.dtype)
        L = blocked_cholesky(A + jitter[..., None, None] * eye)
        ok = jnp.all(jnp.isfinite(L), axis=(-2, -1))  # per-lane verdict
        return L, jitter, ok

    if k_start is None:
        h = jnp.zeros(batch, jnp.int32)
    else:
        # nan_to_num: a NaN/inf hint (e.g. from a diverged upstream state)
        # must degrade to the fresh ladder, not poison the int cast
        h = jnp.clip(
            jnp.floor(jnp.nan_to_num(jnp.asarray(k_start))).astype(jnp.int32),
            0, maxtries)
        h = jnp.broadcast_to(h, batch)
    L0, j0, ok0 = _attempt(h)

    if greedy:
        # sequential GPy ladder from the hint: first success per lane is final
        def g_cond(state):
            return jnp.any(~state[-1])

        def g_body(state):
            k, L_b, j_b, ok_b, done = state
            k = jnp.where(done, k, k + 1)
            L, jitter, ok = _attempt(k)
            take = ~done  # searching lanes record this attempt (success, or
            # the climb's latest failure — all-fail lanes report the last
            # rung tried, like the verified walk)
            keep = ~take[..., None, None] if batch else ~take
            L_b = jnp.where(keep, L_b, L)
            j_b = jnp.where(take, jitter, j_b)
            ok_b = ok_b | (take & ok)
            done = done | (take & ok) | (k >= maxtries)
            return (k, L_b, j_b, ok_b, done)

        done0 = ok0 | (h >= maxtries)
        k, L, jitter, ok, _ = lax.while_loop(
            g_cond, g_body, (h, L0, j0, ok0, done0))
        rung = jnp.where(ok, k, maxtries + 1)
        return L, jitter, ok, rung

    # search interval [lo, hi] for the minimal successful rung; invariant: when
    # a success has been stored (ok flag), the stored factor is the one at `hi`
    lo = jnp.where(ok0, jnp.zeros_like(h), h + 1)
    hi = jnp.where(ok0, h, jnp.full_like(h, maxtries))
    done0 = (ok0 & (lo == hi)) | (lo > hi)

    def cond(state):
        return jnp.any(~state[-1])

    def body(state):
        lo, hi, step, L_b, j_b, ok_b, done = state
        # probe position, per lane, exponential (galloping) search:
        # - success in hand (ok_b): verify minimality downward from hi —
        #   hi-1, hi-2, hi-4, ... When the hint was exactly right (the steady
        #   state of a BO refit loop) ONE probe at hi-1 confirms it (2
        #   factorizations total); stale hints converge in O(log maxtries).
        # - no success yet: gallop UP from lo — lo, lo+1, lo+3, lo+7, ... so
        #   a shallow true rung costs what the old sequential walk paid
        #   (rung 1 with no hint = 2 factorizations), while a deep rung is
        #   reached in O(log) probes instead of rung+1.
        mid = jnp.where(ok_b,
                        jnp.maximum(lo, hi - step),
                        jnp.minimum(hi, lo + step - 1))
        L, jitter, ok = _attempt(mid)
        succ = ~done & ok
        fail = ~done & ~ok
        # record on success, or on failure while no success has been found yet
        # (so an all-fail lane ends up reporting the LAST attempt — which the
        # binary walk always finishes at rung maxtries — like the sequential
        # ladder did)
        take = succ | (fail & ~ok_b)
        keep = ~take[..., None, None] if batch else ~take
        L_b = jnp.where(keep, L_b, L)
        j_b = jnp.where(take, jitter, j_b)
        ok_b = ok_b | succ
        hi = jnp.where(succ, mid, hi)
        lo = jnp.where(fail, mid + 1, lo)
        done = done | (ok_b & (lo == hi)) | (lo > hi)
        return (lo, hi, step * 2, L_b, j_b, ok_b, done)

    step0 = jnp.ones_like(lo)
    _, hi, _, L, jitter, ok, _ = lax.while_loop(
        cond, body, (lo, hi, step0, L0, j0, ok0, done0))
    rung = jnp.where(ok, hi, maxtries + 1)
    return L, jitter, ok, rung


from functools import partial as _partial

import jax as _jax


@_partial(_jax.custom_vjp, nondiff_argnums=(2, 3))
def _jitchol_core(A, k_start, maxtries, greedy):
    return _jitchol_loop(A, maxtries, k_start, greedy)


def _jitchol_fwd(A, k_start, maxtries, greedy):
    out = _jitchol_loop(A, maxtries, k_start, greedy)
    return out, (out[0], k_start)


def _jitchol_bwd(maxtries, greedy, res, cts):
    """Cholesky pullback: A_bar = 0.5 (S + S^T), S = L^-T Phi(L^T L_bar) L^-1.

    This is `backprop_gradient` (reference choleskies_cython.pyx:48) with the
    sequential Cython loop replaced by two batched triangular solves. The jitter
    choice is treated as a constant (the reference never differentiates it either);
    the rung hint gets a zero cotangent for the same reason.
    """
    L, k_start = res
    L_bar = cts[0]
    W = _phi(L.T @ L_bar)
    tmp = lax.linalg.triangular_solve(L, W, left_side=True, lower=True, transpose_a=True)
    S = lax.linalg.triangular_solve(
        L, tmp.T, left_side=True, lower=True, transpose_a=True
    ).T
    A_bar = 0.5 * (S + S.T)
    return (A_bar, jnp.zeros_like(k_start))


_jitchol_core.defvjp(_jitchol_fwd, _jitchol_bwd)

# Module-level jit so eager callers hit the compile cache (a bare lax.while_loop with
# fresh closures re-traces on every eager call). Inlined when called under an outer jit.
_jitchol_jit = _jax.jit(_jitchol_core, static_argnums=(2, 3))


def jitchol_full(A: jnp.ndarray, maxtries: int | None = None, k_start=None,
                 greedy: bool = False):
    """`jitchol` that also returns the accepted ladder RUNG (int, batch shape):
    ``(L, jitter, ok, rung)``. `k_start` is the first rung probed (see
    `_jitchol_loop`) — the minimal-rung result is hint-independent; a good hint
    (e.g. the previous refit's rung, GPRegression.jitter_hint) just reaches it
    in ~2 factorizations. `greedy=True` accepts the first success walking UP
    from the hint (no downward verification — see `_jitchol_loop`)."""
    if maxtries is None:
        maxtries = config.jitchol_maxtries
    if k_start is None:
        k_start = jnp.zeros((), jnp.float32)
    return _jitchol_jit(jnp.asarray(A),
                        jnp.asarray(k_start, dtype=jnp.float32), int(maxtries),
                        bool(greedy))


def jitchol(A: jnp.ndarray, maxtries: int | None = None):
    """Cholesky with a progressive jitter ladder, matching GPy jitchol semantics
    (util/linalg.py:56-74): try plain Cholesky; on failure add ``mean(diag)*1e-6`` to
    the diagonal, multiplying by 10 each retry, up to `maxtries` retries. (The
    retry WALK is a minimal-rung binary search — same accepted jitter, fewer
    factorizations; see `_jitchol_loop`.)

    Branch-by-``lax.while_loop`` (not exceptions): XLA's Cholesky returns NaNs for
    non-PD inputs, so failure detection is a finite-ness check. Returns
    ``(L, jitter_used, ok)``; `ok` is False if even the largest jitter failed.

    Reverse-mode differentiable via a custom VJP (the while_loop itself is not):
    backward is the standard Cholesky pullback, with the selected jitter held
    constant.
    """
    L, jitter, ok, _ = jitchol_full(A, maxtries)
    return L, jitter, ok


def solve_lower(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """L x = B with L lower triangular (GPy dtrtrs(..., lower=1), util/linalg.py:95)."""
    return lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=False
    )


def blocked_solve_lower(L: jnp.ndarray, B: jnp.ndarray, nb: int = 512) -> jnp.ndarray:
    """Forward substitution L x = B restructured as a panel loop of BATCHED ops
    (the solve analog of :func:`blocked_cholesky`).

    Why: a full-size `triangular_solve` with a 1-column RHS is a LATENCY-bound
    sequential sweep per lane. Blocked: n/nb sequential steps, each ONE batched
    (B, nb, nb) small solve (latency amortized over lanes) plus a panel matvec
    L[k, :k] @ x[:k]. Exact — same arithmetic, no
    masking. Falls back to XLA's solve for small n or wide RHS (where the
    dense solve is already matmul-shaped). Any leading batch dims.
    """
    n = L.shape[-1]
    if n < 2 * nb or B.shape[-1] > nb:
        return solve_lower(L, B)
    x = jnp.zeros_like(B)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        rhs = B[..., k0:k1, :]
        if k0 > 0:
            rhs = rhs - jnp.matmul(L[..., k0:k1, :k0], x[..., :k0, :])
        xk = lax.linalg.triangular_solve(
            L[..., k0:k1, k0:k1], rhs, left_side=True, lower=True
        )
        x = x.at[..., k0:k1, :].set(xk)
    return x


def solve_lower_t(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """L^T x = B with L lower triangular (dtrtrs trans=1)."""
    return lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=True
    )


def cho_solve(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """(L L^T) x = B given lower Cholesky L (GPy dpotrs, util/linalg.py:116)."""
    return solve_lower_t(L, solve_lower(L, B))


def tri_inv_lower(L: jnp.ndarray, block: int = 256, precision=None) -> jnp.ndarray:
    """L^-1 for lower-triangular L, by divide-and-conquer blocking.

    `triangular_solve(L, I)` treats the identity RHS as dense — N^3 FLOPs through
    a sequential panel sweep. This exploits the triangular structure: invert all
    diagonal `block`-blocks in ONE batched small solve (under the ``diag_inv``
    name scope), then merge up a log-depth tree of matmuls using
        [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]
    (~N^3/3 FLOPs, matmul-bound). Supports leading batch dims. Exact in f32 —
    same arithmetic class as the solve it replaces.
    """
    n = L.shape[-1]
    if n <= block:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
        return lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    # pad to a power-of-two multiple of block with identity diagonal
    nb = -(-n // block)
    levels = max(0, (nb - 1).bit_length())
    n_pad = block * (1 << levels)
    if n_pad != n:
        batch = L.shape[:-2]
        Lp = jnp.zeros(batch + (n_pad, n_pad), L.dtype)
        Lp = Lp.at[..., :n, :n].set(L)
        Lp = Lp.at[..., n:, n:].add(jnp.eye(n_pad - n, dtype=L.dtype))
        L = Lp
    nb = n_pad // block
    # (..., nb, block, block) diagonal blocks -> one batched solve
    diag = jnp.stack(
        [L[..., i * block:(i + 1) * block, i * block:(i + 1) * block]
         for i in range(nb)],
        axis=-3,
    )
    with jax.named_scope("diag_inv"):
        eye = jnp.broadcast_to(jnp.eye(block, dtype=L.dtype), diag.shape)
        inv = lax.linalg.triangular_solve(diag, eye, left_side=True, lower=True)
    s = block
    while s < n_pad:
        g = inv.shape[-3]  # current number of inverted diagonal groups
        Ai, Di = inv[..., 0::2, :, :], inv[..., 1::2, :, :]
        C = jnp.stack(
            [L[..., (2 * i + 1) * s:(2 * i + 2) * s, 2 * i * s:(2 * i + 1) * s]
             for i in range(g // 2)],
            axis=-3,
        )
        B = -jnp.matmul(Di, jnp.matmul(C, Ai, precision=precision),
                        precision=precision)
        z = jnp.zeros_like(B)
        top = jnp.concatenate([Ai, z], axis=-1)
        bot = jnp.concatenate([B, Di], axis=-1)
        inv = jnp.concatenate([top, bot], axis=-2)
        s *= 2
    out = inv[..., 0, :, :]
    return out[..., :n, :n] if n_pad != n else out


def dpotri(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of A = L L^T from its Cholesky factor (GPy dpotri, util/linalg.py:127)."""
    return tri_tdot(tri_inv_lower(L))


def logdet_from_chol(L: jnp.ndarray) -> jnp.ndarray:
    """log|A| = 2 * sum(log(diag(L)))."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def pdinv(A: jnp.ndarray, maxtries: int | None = None):
    """(A^-1, L, L^-1, logdet) for symmetric PD A (GPy pdinv, util/linalg.py:193)."""
    L, _, _ = jitchol(A, maxtries)
    Li = tri_inv_lower(L)
    return tri_tdot(Li), L, Li, logdet_from_chol(L)


def backsub_both_sides(L: jnp.ndarray, X: jnp.ndarray, transpose: str = "left"):
    """L^-T X L^-1 ('left') or L^-1 X L^-T ('right'), cf. GPy util/linalg.py:381."""
    if transpose == "left":
        tmp = lax.linalg.triangular_solve(
            L, X, left_side=True, lower=True, transpose_a=True
        )
        return lax.linalg.triangular_solve(
            L, tmp.T, left_side=True, lower=True, transpose_a=True
        ).T
    tmp = solve_lower(L, X)
    return solve_lower(L, tmp.T).T


def cholupdate(L: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Rank-1 Cholesky update: chol(L L^T + x x^T).

    Replaces the Cython loop in ``GPy/GPy/util/linalg_cython.pyx`` (cholupdate) with a
    ``lax.fori_loop`` of full-vector masked Givens-style updates (O(n^2), vectorized
    across rows).
    """
    L = jnp.asarray(L)
    x = jnp.asarray(x).reshape(-1)
    n = x.shape[0]
    idx = jnp.arange(n)

    def body(k, state):
        # Orthogonal Givens form c = Lkk/r, s = xk/r (algebraically equal to the
        # divide-by-pivot form but defined for a SEMIDEFINITE factor: Lkk == 0
        # gives c=0, s=±1 instead of NaN; r == 0 is guarded to the identity
        # rotation). The reference Cython (linalg_cython.pyx cholupdate) divides
        # by the pivot unguarded — a flaw we do not replicate.
        L, x = state
        Lkk = L[k, k]
        xk = x[k]
        r = jnp.sqrt(Lkk**2 + xk**2)
        r_safe = jnp.where(r == 0.0, 1.0, r)
        c = jnp.where(r == 0.0, 1.0, Lkk / r_safe)
        s = xk / r_safe
        col = L[:, k]
        below = idx > k
        new_col = jnp.where(below, c * col + s * x, col)
        new_col = new_col.at[k].set(r)
        L = L.at[:, k].set(jnp.where(idx >= k, new_col, col))
        x = jnp.where(below, c * x - s * col, x)
        return L, x

    L, _ = lax.fori_loop(0, n, body, (L, x))
    return L


def masked_gram(K: jnp.ndarray, mask: jnp.ndarray | None) -> jnp.ndarray:
    """Pad-safe Gram matrix: rows/cols where mask==0 are replaced by identity.

    This keeps a padded buffer positive-definite with logdet contribution 0 from the
    padding block, so fit/predict compile once at a fixed max-N (SURVEY §7 'Dynamic
    shapes': X grows every BO iteration; padded buffers avoid recompilation).
    """
    if mask is None:
        return K
    m = mask.astype(K.dtype)
    outer = m[:, None] * m[None, :]
    return K * outer + jnp.diag(1.0 - m)


def trace_dot(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """trace(A @ B) without forming the product (GPy util/linalg.py trace_dot)."""
    return jnp.sum(A * B.T)
