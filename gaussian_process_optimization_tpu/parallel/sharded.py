"""Multi-chip scale-out over a jax.sharding.Mesh.

The reference's distributed layer is optional MPI: ``GPy/GPy/core/sparse_gp_mpi.py``
(scatter data, allreduce gradients) and
``GPy/GPy/inference/latent_function_inference/var_dtc_parallel.py`` (reduceArrays —
partial sums of sufficient statistics across ranks), plus a multiprocessing objective
fan-out (``GPyOpt/GPyOpt/core/task/objective.py:80``). Equivalent here: ONE
SPMD program over a device mesh with XLA collectives —

- 'data' axis: training rows / candidate points sharded; per-shard sufficient
  statistics (A_i A_i^T, A_i y_i, |y_i|^2, traces) are psum-reduced — the exact
  analog of var_dtc_parallel's allreduce.
- exact GP: the O(N^2 D) K build shards over row blocks (each device builds its
  rows against full X); the Cholesky consumes the gathered Gram. For N past one
  device's memory the supported scaling path is the sparse/SVGP bound whose per-device
  work is O(N_shard M^2) with an M x M psum — the same scaling axes the reference
  uses (SURVEY §5 'long-context analog').
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import config
from ..models.gp import LOG_2_PI
from ..ops import linalg

shard_map = jax.shard_map


def make_mesh(n_devices=None, axis_names=("data",)):
    """Build a Mesh over the first n_devices devices (1-D 'data' mesh by default;
    pass ('data','model') for a 2-D mesh split as evenly as possible)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        d = int(np.floor(np.sqrt(n)))
        while n % d:
            d -= 1
        shape = (d, n // d)
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


# ---------------------------------------------------------------------- exact GP
def make_sharded_exact_lml(mesh):
    """Returns lml(kern, X, Y, noise, mask) with the K-row-block build sharded over
    the 'data' axis. X must be padded to a multiple of the axis size."""

    def k_rows_shard(kern, X_rows, X_full):
        return kern.K(X_rows, X_full)

    k_rows = shard_map(
        k_rows_shard,
        mesh=mesh,
        in_specs=(P(), P("data", None), P(None, None)),
        out_specs=P("data", None),
    )

    def lml(kern, X, Y, noise, mask):
        n = X.shape[0]
        K = k_rows(kern, X, X)
        Ky = K + (noise + config.noise_jitter) * jnp.eye(n, dtype=K.dtype)
        Ky = linalg.masked_gram(Ky, mask)
        L, jitter, ok = linalg.jitchol(Ky)
        Yc = Y * mask[:, None]
        alpha = linalg.cho_solve(L, Yc)
        n_real = jnp.sum(mask)
        p = Y.shape[1]
        val = 0.5 * (
            -n_real * p * LOG_2_PI
            - p * linalg.logdet_from_chol(L)
            - jnp.sum(alpha * Yc)
        )
        return val, (L, alpha, ok)

    return lml


# --------------------------------------------------- distributed factorization
def _dist_chol_body(A_local, row0, n, nb, axis="data"):
    """Shard-local body of the distributed blocked right-looking Cholesky.

    `A_local`: this device's contiguous row block (rows_per, n) of a replicated-
    semantics SPD matrix; `row0` the traced global index of its first row. Per
    panel k (static unroll): all_gather the (n, nb) block column, factor/solve
    the PANEL replicated (O(n nb^2) — tiny vs the O(n^3/P) trailing updates),
    then each device applies its shard-local trailing update masked to global
    rows >= k1. The full factor never exists on one device: peak per-device
    memory is rows_per*n + 2*n*nb.
    """
    rows_per = A_local.shape[0]
    grow = row0 + jnp.arange(rows_per)  # global row indices of this shard
    for k0 in range(0, n, nb):
        k1 = k0 + nb
        col_full = lax.all_gather(A_local[:, k0:k1], axis, axis=0, tiled=True)
        Lkk = jnp.linalg.cholesky(col_full[k0:k1])
        L_col = jnp.zeros_like(col_full)
        L_col = L_col.at[k0:k1].set(Lkk)
        if k1 < n:
            below = jax.lax.linalg.triangular_solve(
                Lkk, col_full[k1:], left_side=False, lower=True,
                transpose_a=True)
            L_col = L_col.at[k1:].set(below)
        mine = lax.dynamic_slice(L_col, (row0, jnp.zeros_like(row0)),
                                 (rows_per, nb))
        A_local = A_local.at[:, k0:k1].set(mine)
        if k1 < n:
            panel = jnp.where((grow >= k1)[:, None], mine, 0.0)
            A_local = A_local.at[:, k1:].add(
                -jnp.matmul(panel, L_col[k1:].T))
    # zero this shard's strictly-upper triangle (never touched by the panels)
    col_idx = jnp.arange(n)
    return jnp.where(col_idx[None, :] <= grow[:, None], A_local, 0.0)


def _dist_solve_lower_body(L_local, row0, B, nb, axis="data"):
    """Forward substitution L x = B with L row-sharded (this device holds
    (rows_per, n) rows starting at `row0`) and B replicated (n, p). Sequential
    over the n/nb block rows: the owner computes its x block, a psum
    replicates it (everyone else contributes zeros). Returns x replicated."""
    rows_per, n = L_local.shape
    x = jnp.zeros_like(B)
    for k0 in range(0, n, nb):
        k1 = k0 + nb
        # the [k0, k1) block row is owned by exactly one device (rows_per is a
        # multiple of nb); everyone computes with a clamped local slice and the
        # non-owners are masked out of the psum
        loc = jnp.clip(k0 - row0, 0, rows_per - nb)
        blk = lax.dynamic_slice(L_local, (loc, jnp.zeros_like(loc)), (nb, n))
        rhs = B[k0:k1] - jnp.matmul(blk[:, :k0], x[:k0]) if k0 > 0 \
            else B[k0:k1]
        is_owner = (row0 <= k0) & (k0 < row0 + rows_per)
        # non-owners hold upper-triangle (zero-diagonal) garbage here: solve
        # against identity instead, or the masked-out NaNs poison reverse mode
        # (the where-NaN trap — solve VJP evaluates T^-T even at zero cotangent)
        T = jnp.where(is_owner, blk[:, k0:k1], jnp.eye(nb, dtype=blk.dtype))
        z = jax.lax.linalg.triangular_solve(T, rhs, left_side=True, lower=True)
        z = jnp.where(is_owner, z, 0.0)
        z = lax.psum(z, axis)
        x = x.at[k0:k1].set(z)
    return x


def make_distributed_cholesky(mesh, nb=256):
    """chol(A) with A AND L row-block-sharded over 'data' — the factorization
    itself distributed, unlike `make_sharded_exact_lml` which gathers the Gram
    and factors it replicated on every device.

    Strictly beyond the reference, whose only distributed inference is the
    sparse sufficient-stats allreduce (GPy var_dtc_parallel.py reduceArrays);
    its dense path is one host's LAPACK potrf (GPy/util/linalg.py:56). Here the
    N^2 Gram memory and the N^3/3 trailing-update FLOPs both scale with the
    mesh; per-panel comms are one (N, nb) all_gather.

    Returns chol_fn(A) -> L for a GLOBAL (n, n) array laid out (or to be laid
    out) with rows sharded P('data', None); n must be a multiple of
    axis_size * nb. Differentiable (the panel loop is plain jnp + collectives);
    note reverse-mode stores O(n*nb) residuals per panel — for memory-critical
    sizes wrap the call in `jax.checkpoint`.
    """
    def body(A_local):
        rows_per = A_local.shape[0]
        row0 = lax.axis_index("data") * rows_per
        return _dist_chol_body(A_local, row0, A_local.shape[1], nb)

    return shard_map(body, mesh=mesh, in_specs=P("data", None),
                     out_specs=P("data", None))


def make_distributed_exact_lml(mesh, nb=256):
    """Exact-GP log marginal likelihood with the Gram build, the Cholesky, and
    the logdet ALL row-sharded — per-device peak memory ~ N^2/P + 2*N*nb, so
    exact GP scales past one device's memory.

    Returns lml(kern, X, Y, noise) -> scalar (replicated). X (n, d) and Y
    (n, p) are replicated (they are O(N d) — small); n must be a multiple of
    axis_size * nb. No jitter ladder: the distributed path targets large-N
    fits where `noise` already dominates f32 round-off; callers needing ladder
    semantics use the single-chip `jitchol` or pre-condition the noise floor.
    Differentiable w.r.t. kernel params and noise (value+grad tested against
    the single-device LML on the 8-virtual-device CPU mesh).
    """
    def body(kern, X_rows, X_full, Y, noise):
        rows_per, n = X_rows.shape[0], X_full.shape[0]
        row0 = lax.axis_index("data") * rows_per
        grow = row0 + jnp.arange(rows_per)
        K_local = kern.K(X_rows, X_full)
        eye_rows = (jnp.arange(n)[None, :] == grow[:, None]).astype(K_local.dtype)
        K_local = K_local + (noise + config.noise_jitter) * eye_rows
        L_local = _dist_chol_body(K_local, row0, n, nb)
        c = _dist_solve_lower_body(L_local, row0, Y, nb)
        diag_local = jnp.sum(L_local * eye_rows, axis=1)
        logdet = 2.0 * lax.psum(jnp.sum(jnp.log(diag_local)), "data")
        p = Y.shape[1]
        return 0.5 * (-n * p * LOG_2_PI - p * logdet - jnp.sum(jnp.square(c)))

    smapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("data", None), P(None, None), P(None, None), P()),
        out_specs=P(),
    )

    def lml(kern, X, Y, noise):
        return smapped(kern, X, X, Y, noise)

    return lml


# ---------------------------------------------------------------------- sparse GP
def make_sharded_vardtc_lml(mesh):
    """Returns bound(kern, Z, X, Y, noise, mask): Titsias collapsed bound with
    data-parallel sufficient statistics psum-reduced over 'data' — the reference's
    var_dtc_parallel.reduceArrays as an XLA collective."""

    def stats_shard(kern, Z, X_s, Y_s, mask_s):
        m = Z.shape[0]
        # SCALED jitter, matching the single-device twin (models/sparse.py):
        # absolute 1e-6 is 100x too weak once the kernel variance fits to ~100
        # and broke the documented exact-parity contract
        Kmm = kern.K(Z)
        Kmm = Kmm + 1e-6 * jnp.mean(jnp.diagonal(Kmm)) * jnp.eye(m, dtype=X_s.dtype)
        Lm, _, okm = linalg.jitchol(Kmm)
        Kmn = kern.K(Z, X_s) * mask_s[None, :]
        Kdiag = kern.Kdiag(X_s) * mask_s
        A = linalg.solve_lower(Lm, Kmn)
        Yc = Y_s * mask_s[:, None]
        AAT = jax.lax.psum(A @ A.T, "data")
        Ay = jax.lax.psum(A @ Yc, "data")
        yy = jax.lax.psum(jnp.sum(jnp.square(Yc)), "data")
        tr = jax.lax.psum(jnp.sum(Kdiag) - jnp.sum(jnp.square(A)), "data")
        n_real = jax.lax.psum(jnp.sum(mask_s), "data")
        return AAT, Ay, yy, tr, n_real, okm

    stats = shard_map(
        stats_shard,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None), P("data")),
        out_specs=(P(), P(), P(), P(), P(), P()),
    )

    def bound(kern, Z, X, Y, noise, mask):
        sigma2 = noise + config.noise_jitter
        m = Z.shape[0]
        p = Y.shape[1]
        AAT, Ay, yy, tr, n_real, okm = stats(kern, Z, X, Y, mask)
        B = jnp.eye(m, dtype=AAT.dtype) + AAT / sigma2
        LB, _, okB = linalg.jitchol(B)
        c = linalg.solve_lower(LB, Ay) / sigma2
        return (
            -0.5 * n_real * p * (LOG_2_PI + jnp.log(sigma2))
            - 0.5 * p * linalg.logdet_from_chol(LB)
            - 0.5 * yy / sigma2
            + 0.5 * jnp.sum(jnp.square(c))
            - 0.5 * p * tr / sigma2
        )

    return bound


# ---------------------------------------------------------------------- SVGP step
def make_sharded_svgp_step(model_template, mesh, learning_rate=1e-2):
    """Data-parallel SVGP training step: batch rows sharded on 'data', parameters
    replicated; per-shard gradients are psum-ed so every device applies the same
    Adam update (the SVI analog of sparse_gp_mpi's gradient allreduce).

    Returns (packer, init(model) -> (u, opt_state), step(u, opt_state, model, X, Y)).
    Global batch size must be a multiple of the 'data' axis size.
    """
    import optax

    from ..models.parameters import make_packer

    opt = optax.adam(learning_rate)
    packer = make_packer(model_template, fix=("num_data",))
    p_data = mesh.shape["data"]

    def local_loss(u, model_ref, X_s, Y_s):
        # sum of local losses over shards == global loss:
        # -(scale * sum_i ell_i - KL)  ==  sum_shards[ -(scale * ell_shard - KL/p) ]
        mdl = packer.unpack(u, reference=model_ref)
        mu, var = mdl._predict_f(X_s)
        # model's own E_q[log p(y|f)] — Gaussian closed form OR Gauss-Hermite
        # for non-Gaussian likelihoods; the old inlined Gaussian formula
        # silently trained classification SVGPs against the wrong objective
        ell = mdl._expected_log_lik(Y_s, mu, var)
        b_global = X_s.shape[0] * p_data
        scale = mdl.num_data / b_global
        return -(scale * jnp.sum(ell) - mdl.kl() / p_data)

    def step_shard(u, opt_state, model_ref, X_s, Y_s):
        val, g = jax.value_and_grad(local_loss)(u, model_ref, X_s, Y_s)
        g = jax.lax.psum(g, "data")
        val = jax.lax.psum(val, "data")
        updates, opt_state = opt.update(g, opt_state, u)
        u = optax.apply_updates(u, updates)
        return u, opt_state, val

    sharded_step = shard_map(
        step_shard,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None), P("data", None)),
        out_specs=(P(), P(), P()),
    )

    step = jax.jit(sharded_step)

    def init(model):
        u0 = packer.pack(model)
        return u0, opt.init(u0)

    return packer, init, step


# ---------------------------------------------------------------------- sweeps
def make_sharded_sweep(score_fn, mesh):
    """Candidate-scoring sweep sharded over 'data' — the acquisition
    1000-25000-point sweep (anchor_points_generator.py) at multi-chip scale.
    score_fn(state, X_shard) -> (n_shard,) must be shard-local (pure predict)."""

    def sweep_shard(state, X_s):
        return score_fn(state, X_s)

    return jax.jit(
        shard_map(
            sweep_shard, mesh=mesh,
            in_specs=(P(), P("data", None)), out_specs=P("data"),
        )
    )


# ------------------------------------------------------------- multi-start fit
def make_sharded_multistart_fit(template_model, mesh, restarts_per_device=1,
                                maxiter=1000, tol=1e-5, max_ls=8, fix=(),
                                transform_overrides=None, priors=None):
    """Multi-restart hyperparameter fit with the RESTART axis sharded over the
    mesh: each device runs its own vmapped L-BFGS chains, the per-restart optima
    are gathered, and the global argmin picked.

    The reference runs restarts as a serial Python loop
    (``paramz model.optimize_restarts``, driven from
    ``GPyOpt/GPyOpt/models/gpmodel.py:88-93``); the single-chip port vmaps them
    (models/fit.Fitter); this scales them across chips — restart chains are
    embarrassingly parallel, so the collective cost is one small gather of the
    (R, n_params) optima. Total restarts = mesh axis size x restarts_per_device
    (the model's current parameters seed restart 0).

    Returns run(model, key) -> (fitted_model, (us, fs)); jit once, reuse.
    """
    from ..models.fit import make_objective
    from ..models.parameters import make_packer
    from ..ops import lbfgs

    packer = make_packer(template_model, fix=fix,
                         transform_overrides=transform_overrides)
    obj = make_objective(packer, priors=priors)
    n_dev = mesh.shape["data"]
    # at least one chain per device: a (1, n) start array cannot shard over a
    # multi-device axis (and idle devices would be pure waste anyway)
    restarts_per_device = max(1, int(restarts_per_device))
    total = n_dev * restarts_per_device

    def solve_shard(starts_s, model):
        def solve(u):
            res = lbfgs.minimize(lambda uu: obj(uu, model), u, maxiter=maxiter,
                                 tol=tol, max_ls=max_ls)
            return res.x, res.f

        return jax.vmap(solve)(starts_s)

    # check_vma=False: the shard body is collective-free (independent chains),
    # and the L-BFGS loop carries unvarying zeros that trip the varying-axes
    # type check under shard_map
    sharded_solve = shard_map(
        solve_shard, mesh=mesh,
        in_specs=(P("data", None), P()), out_specs=(P("data", None), P("data")),
        check_vma=False,
    )

    @jax.jit
    def run(model, key):
        u0 = packer.pack(model)
        n = u0.shape[0]
        # total >= n_dev by construction, so the shard always divides evenly
        z = jax.random.normal(key, (total - 1, n), dtype=u0.dtype)
        rand = jax.vmap(packer.map_restart)(z)
        starts = jnp.concatenate([u0[None], rand])
        us, fs = sharded_solve(starts, model)
        fs = jnp.where(jnp.isfinite(fs), fs, jnp.inf)
        best = jnp.argmin(fs)
        fitted = packer.unpack(us[best], reference=model)
        return fitted, (us, fs)

    return run


# -------------------------------------------------- multi-start acq argmax
def make_sharded_acq_argmax(neg_acq, mesh, lower, upper, num_samples=1000,
                            anchors_per_device=1, maxiter=200):
    """Acquisition argmax with BOTH phases sharded over the mesh: the random
    candidate sweep (anchor_points_generator.py:87-99) splits its rows across
    devices, and the anchor L-BFGS multistarts (acquisition_optimizer.py:45-79)
    run one vmapped batch per device.

    neg_acq(state, X) -> (n,) must be shard-local (pure predict — no
    collectives), `state` the pytree of posterior buffers. Returns
    argmax(state, key) -> (x_best, f_best); jit once per posterior structure.

    This is the standalone library variant (plain box bounds). The BO stack's
    AcquisitionOptimizer has its own mesh path with the same sharding layout
    plus design-space features (rounding, context, constraints, dedupe).
    """
    from ..ops import lbfgs

    n_dev = mesh.shape["data"]
    n_anchor = n_dev * anchors_per_device
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    d = lower.shape[0]
    # round the sweep up to a multiple of the axis size
    n_sweep = -(-num_samples // n_dev) * n_dev

    def sweep_shard(state, X_s):
        return neg_acq(state, X_s)

    sweep = shard_map(sweep_shard, mesh=mesh,
                      in_specs=(P(), P("data", None)), out_specs=P("data"))

    def polish_shard(state, anchors_s):
        def solve(a):
            res = lbfgs.minimize(
                lambda x: neg_acq(state, x[None, :])[0], a, lower=lower,
                upper=upper, maxiter=maxiter, carry_vjp=False)
            return res.x, res.f

        return jax.vmap(solve)(anchors_s)

    polish = shard_map(polish_shard, mesh=mesh,
                       in_specs=(P(), P("data", None)),
                       out_specs=(P("data", None), P("data")),
                       check_vma=False)  # collective-free, see above

    @jax.jit
    def argmax(state, key):
        cands = jax.random.uniform(key, (n_sweep, d), minval=lower,
                                   maxval=upper, dtype=lower.dtype)
        scores = sweep(state, cands)
        anchors = cands[jnp.argsort(scores)[:n_anchor]]
        xs, fs = polish(state, anchors)
        fs = jnp.where(jnp.isfinite(fs), fs, jnp.inf)
        best = jnp.argmin(fs)
        return xs[best], fs[best]

    return argmax
