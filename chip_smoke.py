"""Smoke test of the GP / BO main path on NVIDIA GPUs.

    python chip_smoke.py             # one GPU: phases 1-3 below
    python chip_smoke.py --chips 4   # the mesh path on four GPUs, and nothing else

One GPU, at the headline width (N=4096, D=6, ARD Matern52, float32 on the card):

1. device: what JAX sees, the card's name and power limit (nvidia-smi), the
   compile-cache directory. Anything but a GPU backend is a failure.
2. correctness: the K build, the exact-GP negative LML and its gradient with
   respect to every hyperparameter, against a float64 numpy/scipy twin on the
   host; the jitter ladder's contract on the card's Cholesky.
3. main path, through the public API: a BayesianOptimization ask-tell suggest
   (cold, then warm on perturbed Y), the thesis Gower local-penalization batch-5,
   and 15 Branin iterations; the fit step's compiled memory analysis.

No hand-written kernel is on the path (XLA compiles all of it), so there is no
kernel A/B phase.

Every error is printed beside its bound. Any failure raises, so the process
exits non-zero and prints no result line. The last line of stdout, on success
only, is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

N, D = 4096, 6
RESTARTS, STEPS = 5, 30
# Hyperparameters of the correctness phase (not fitted: a fixed, non-trivial
# point where every gradient component is O(1..1e3)).
VARIANCE = 1.3
LENGTHSCALES = (0.8, 1.1, 1.5, 0.9, 1.2, 2.0)
NOISE = 0.05

# Bounds of phase 2, with their reasons in CHANGES.md:
# - K: max |K - K64| / variance. The distance trick's r^2 = |x|^2 + |z|^2 - 2x.z
#   carries ~|x|^2 * 2^-23 absolute error (|x|^2 <= ~40 in lengthscale units) and
#   dK/dr^2 <= 5/6 variance, so ~1e-5 is expected.
# - LML: relative error of the negative LML; float32 logdet over 4096 pivots.
# - gradient: relative L2 error of the 8-vector (variance, 6 lengthscales,
#   noise); the trace terms go through Ky^-1 at condition ~1e5.
K_BOUND = 1e-4
LML_BOUND = 1e-4
GRAD_BOUND = 1e-3


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def check(name, err, bound):
    """Print `err` beside `bound`; raise unless it is finite and within it."""
    ok = bool(np.isfinite(err)) and err <= bound
    log(f"  {name}: {err:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err} exceeds {bound}")


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    import jax

    jax.block_until_ready(out)
    log(f"  {label}: {time.perf_counter() - t0:.3f} s")
    return out


# ------------------------------------------------------------------ phase 1
def device_phase(chips):
    import jax

    from bench import gpu_info
    from gaussian_process_optimization_tpu.utils.compile_cache import (
        enable_compile_cache)

    info = gpu_info()  # raises unless JAX's backend is a GPU
    devices = jax.devices()
    log(f"  devices: {devices}")
    log(f"  device_kind: {info['kind']}, count: {info['count']}")
    if info["count"] < chips:
        raise RuntimeError(f"--chips {chips} needs {chips} GPUs, found "
                           f"{info['count']}")
    log(f"  compile cache: {enable_compile_cache()}")
    for line in info["nvidia_smi"].splitlines():
        log(f"  nvidia-smi: {line}")
    return {"platform": info["platform"], "kind": info["kind"], "count": chips}


# ------------------------------------------------------------------ phase 2
def headline_model(X, Y, variance=VARIANCE, lengthscales=LENGTHSCALES,
                   noise=NOISE):
    import gaussian_process_optimization_tpu.kernels as kern
    from gaussian_process_optimization_tpu.models.gp import GPRegression

    d = X.shape[1]
    k = kern.Matern52.create(d, variance=variance,
                             lengthscale=np.asarray(lengthscales[:d]), ARD=True)
    return GPRegression.create(X, Y, kernel=k, noise_var=noise,
                               max_points=X.shape[0])


def matern52_twin(X, Y, variance, ls, noise, jitter=1e-8):
    """float64 numpy/scipy exact GP with ARD Matern52: (K, negative LML,
    gradient of the negative LML w.r.t. [variance, lengthscales..., noise])."""
    import scipy.linalg as sla

    n, d = X.shape
    Xs = X / ls
    r2 = np.zeros((n, n))
    for j in range(d):
        diff = Xs[:, j:j + 1] - Xs[None, :, j]
        r2 += diff * diff
    r = np.sqrt(r2)
    e = np.exp(-np.sqrt(5.0) * r)
    K = variance * (1.0 + np.sqrt(5.0) * r + 5.0 / 3.0 * r2) * e
    cf = sla.cho_factor(K + (noise + jitter) * np.eye(n), lower=True)
    alpha = sla.cho_solve(cf, Y)
    logdet = 2.0 * np.sum(np.log(np.diag(cf[0])))
    neg_lml = 0.5 * float(np.sum(Y * alpha)) + 0.5 * logdet \
        + 0.5 * n * Y.shape[1] * np.log(2.0 * np.pi)
    # dLML/dKy = 0.5 (alpha alpha^T - Ky^-1)  (GPy exact_gaussian_inference:70)
    W = alpha @ alpha.T - sla.cho_solve(cf, np.eye(n))
    g_var = -0.5 * np.sum(W * K) / variance
    C = (5.0 / 3.0) * variance * (1.0 + np.sqrt(5.0) * r) * e * W
    g_ls = [-0.5 * np.sum(C * (Xs[:, j:j + 1] - Xs[None, :, j]) ** 2) / ls[j]
            for j in range(d)]
    g_noise = -0.5 * np.trace(W)
    return K, neg_lml, np.asarray([g_var, *g_ls, g_noise])


def device_lml_grad(model, precision):
    """Negative LML and its gradient [variance, lengthscales, noise] on the
    device, with `precision` for the exact-GP gradient path."""
    import jax

    from gaussian_process_optimization_tpu.config import config
    from gaussian_process_optimization_tpu.utils.pytree import replace

    def neg_lml(kern, noise, m):
        return -replace(m, kern=kern, likelihood_variance=noise) \
            .log_marginal_likelihood()

    old = config.grad_matmul_precision
    config.grad_matmul_precision = precision
    try:  # a fresh jit per precision: the setting is read while tracing
        val, (gk, gn) = jax.jit(jax.value_and_grad(neg_lml, argnums=(0, 1)))(
            model.kern, model.likelihood_variance, model)
    finally:
        config.grad_matmul_precision = old
    g = np.concatenate([np.ravel(gk.variance), np.ravel(gk.lengthscale),
                        np.ravel(gn)]).astype(np.float64)
    return float(val), g


def correctness_phase(X, Y):
    """K, negative LML and gradient at the headline width vs the float64 twin."""
    import jax

    model = headline_model(X, Y)
    # the twin sees exactly the card's (float32-rounded) inputs
    X64 = np.asarray(model.X, np.float64)
    Y64 = np.asarray(model.Y, np.float64)
    var64 = float(model.kern.variance)
    ls64 = np.asarray(model.kern.lengthscale, np.float64)
    noise64 = float(model.likelihood_variance)
    t0 = time.perf_counter()
    K64, nlml64, g64 = matern52_twin(X64, Y64, var64, ls64, noise64)
    log(f"  float64 host twin: {time.perf_counter() - t0:.1f} s")

    K = np.asarray(jax.jit(lambda k, x: k.K(x))(model.kern, model.X))
    check("K build max|K - K64| / variance",
          float(np.max(np.abs(K - K64))) / var64, K_BOUND)
    del K, K64
    nlml, g = device_lml_grad(model, "highest")
    log(f"  negative LML: {nlml:.6f} (float64 {nlml64:.6f})")
    check("negative LML relative error", abs(nlml - nlml64) / abs(nlml64),
          LML_BOUND)
    log(f"  gradient: {np.array2string(g, precision=5)}")
    log(f"  float64:  {np.array2string(g64, precision=5)}")
    check("gradient relative L2 error ('highest')",
          float(np.linalg.norm(g - g64) / np.linalg.norm(g64)), GRAD_BOUND)
    _, g_tf32 = device_lml_grad(model, "high")
    log("  gradient relative L2 error ('high', TF32, no bound): "
        f"{np.linalg.norm(g_tf32 - g64) / np.linalg.norm(g64):.3e}")


def gram_with_spectrum(n, seed=0):
    """A Gram-like float32 matrix with a prescribed spectrum: decaying
    eigenvalues 10 exp(-i/200) down to exact_feval-like noise 1e-6, and three
    eigenvalues at -5e-4 mean(diag). The ladder's minimal rung is then set by
    the matrix, not by round-off: rung 3 (jitter 1e-4 mean(diag)) leaves it
    indefinite, rung 4 (1e-3) makes it positive definite with a wide margin."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = 10.0 * np.exp(-np.arange(n) / 200.0) + 1e-6
    mean_diag = lam.sum() / n
    lam[-3:] = -5e-4 * mean_diag
    return ((Q * lam) @ Q.T).astype(np.float32)


def host_ladder_rung(A, maxtries=5, base=1e-6):
    """GPy's sequential jitchol ladder (util/linalg.py:56-74) in float64 numpy:
    the first rung whose Cholesky succeeds (maxtries + 1 if none does)."""
    A = np.asarray(A, np.float64)
    mean_diag = np.mean(np.diag(A))
    for k in range(maxtries + 1):
        jitter = 0.0 if k == 0 else mean_diag * base * 10.0 ** (k - 1)
        try:
            np.linalg.cholesky(A + jitter * np.eye(A.shape[0]))
            return k
        except np.linalg.LinAlgError:
            continue
    return maxtries + 1


def ladder_phase(n):
    """The jitter ladder's contract on the card's Cholesky: a failed lane comes
    back non-finite in that lane only, and an ill-conditioned Gram stops on the
    rung the float64 host ladder stops on."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu.config import config
    from gaussian_process_optimization_tpu.ops import linalg

    G = jax.random.normal(jax.random.PRNGKey(0), (3, n, 64), jnp.float32)
    A = G @ jnp.swapaxes(G, -1, -2) / 64.0 + 0.1 * jnp.eye(n, dtype=jnp.float32)
    A = A.at[1, n - 100, n - 100].set(-1.0)  # lane 1 fails in a late panel
    L = jax.jit(linalg.blocked_cholesky)(A)
    finite = [bool(v) for v in jnp.all(jnp.isfinite(L), axis=(-2, -1))]
    log(f"  blocked_cholesky lane finiteness: {finite}")
    if finite != [True, False, True]:
        raise AssertionError(f"non-PD lane is not isolated: {finite}")
    L, jitter, ok, rung = linalg.jitchol_full(A)
    ok, rung = [bool(v) for v in ok], [int(v) for v in rung]
    log(f"  jitchol_full ok {ok}, rung {rung}")
    if ok != [True, False, True] or rung[0] != 0 or rung[2] != 0 \
            or rung[1] != config.jitchol_maxtries + 1:
        raise AssertionError(f"ladder verdicts wrong: ok {ok}, rung {rung}")
    if not bool(jnp.all(jnp.isfinite(L[0]))) or not bool(
            jnp.all(jnp.isfinite(L[2]))):
        raise AssertionError("a PD lane of the ladder came back non-finite")

    A = gram_with_spectrum(n)
    want = host_ladder_rung(A)
    got = [int(linalg.jitchol_full(jnp.asarray(A), greedy=g)[3])
           for g in (False, True)]
    log(f"  ill-conditioned Gram: rung {got[0]} (greedy {got[1]}), "
        f"float64 host ladder {want}")
    if got != [want, want]:
        raise AssertionError(f"ladder rung {got} != float64 host rung {want}")


# ------------------------------------------------------------------ phase 3
def headline_bo(X, Y):
    """(a) ask-tell EI suggest at N=4096, continuous, 5 restarts x 30 steps."""
    from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization

    d = X.shape[1]
    domain = [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)}
              for i in range(d)]
    bo = BayesianOptimization(f=None, domain=domain, X=X, Y=Y,
                              acquisition_type="EI", optimize_restarts=RESTARTS,
                              max_iters=STEPS, seed=0)
    for i, label in enumerate(("cold", "warm")):
        if i:
            bo.Y = Y + 0.01 * np.random.default_rng(1).standard_normal(Y.shape)
        x = timed(f"headline EI suggest ({label})", bo.suggest_next_locations)
        x = np.asarray(x)
        if x.shape != (1, d) or not np.all(np.isfinite(x)) \
                or np.any(np.abs(x) > 2.0):
            raise AssertionError(f"bad suggestion {x}")


def gower_lp_bo(n):
    """(b) the thesis Gower local-penalization batch-5 at N=n."""
    from bench import gower_lp_problem
    from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization

    X, Y, domain = gower_lp_problem(n)
    bo = BayesianOptimization(
        f=None, domain=domain, X=X, Y=Y, Gower=True, acquisition_type="EI",
        evaluator_type="local_penalization", batch_size=5, exact_feval=True,
        seed=0, max_iters=STEPS, optimize_restarts=RESTARTS)
    for i, label in enumerate(("cold", "warm")):
        if i:
            bo.Y = Y + 0.01 * np.random.default_rng(10).standard_normal(Y.shape)
        b = np.asarray(timed(f"Gower LP batch-5 suggest ({label})",
                             bo.suggest_next_locations))
        if b.shape != (5, 6) or not np.all(np.isfinite(b)):
            raise AssertionError(f"bad batch {b}")


def branin_bo():
    """(c) the verify recipe: 15 EI iterations on Branin from 5 latin points."""
    from gaussian_process_optimization_tpu.bo import (BayesianOptimization,
                                                      bounds_to_space, objectives)

    bo = BayesianOptimization(
        f=lambda x: np.asarray(objectives.branin(x)),
        domain=bounds_to_space(objectives.branin.bounds),
        acquisition_type="EI", initial_design_numdata=5,
        initial_design_type="latin", exact_feval=True, seed=0)
    t0 = time.perf_counter()
    bo.run_optimization(max_iter=15, eps=-1)
    log(f"  Branin 15 iterations: {time.perf_counter() - t0:.1f} s, "
        f"{bo.Y.shape[0]} evaluations, fx_opt {bo.fx_opt:.4f} (fmin 0.3979)")
    if bo.Y.shape[0] != 20 or not bo.fx_opt < 1.0:
        raise AssertionError("Branin run short or off the optimum")


def fit_memory(X, Y):
    """Compiled memory analysis of the headline fit (5 restarts x 30 steps)."""
    import jax

    from gaussian_process_optimization_tpu.models.fit import Fitter

    model = headline_model(X, Y)
    fitter = Fitter(model, num_restarts=RESTARTS, maxiter=STEPS, tol=0.0)
    compiled = jax.jit(fitter.__call__).lower(
        model, jax.random.PRNGKey(0)).compile()
    log(f"  fit step memory_analysis: {compiled.memory_analysis()}")


# ------------------------------------------------------------------ --chips 4
def _rel_l2(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree):
    import jax

    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])


def mesh_exact_lml(mesh, model):
    """(1) sharded exact LML + gradient vs models/gp.py on one card."""
    import jax

    from gaussian_process_optimization_tpu.parallel import sharded
    from gaussian_process_optimization_tpu.utils.pytree import replace

    lml_fn = sharded.make_sharded_exact_lml(mesh)

    def sharded_lml(k, noise):
        return lml_fn(k, model.X, model.Y, noise, model.mask)[0]

    def single_lml(k, noise):
        return replace(model, kern=k, likelihood_variance=noise) \
            .log_marginal_likelihood()

    v_s, g_s = jax.jit(jax.value_and_grad(sharded_lml, argnums=(0, 1)))(
        model.kern, model.likelihood_variance)
    with jax.default_device(jax.devices()[0]):
        v_1, g_1 = jax.jit(jax.value_and_grad(single_lml, argnums=(0, 1)))(
            model.kern, model.likelihood_variance)
    check("LML relative error", abs(float(v_s) - float(v_1)) / abs(float(v_1)),
          LML_BOUND)
    check("gradient relative L2 error", _rel_l2(_flat(g_s), _flat(g_1)),
          GRAD_BOUND)


def mesh_multistart_fit(mesh, model):
    """(2) restart-sharded multistart fit vs the unsharded Fitter, same starts."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu.models.fit import Fitter
    from gaussian_process_optimization_tpu.parallel import sharded

    chips = mesh.devices.size
    key = jax.random.PRNGKey(3)
    run = sharded.make_sharded_multistart_fit(model, mesh, restarts_per_device=2,
                                              maxiter=STEPS, tol=0.0)
    _, (us, fs) = jax.block_until_ready(run(model, key))
    held = len(us.sharding.device_set)
    log(f"  restart optima on {held} devices")
    if held != chips:
        raise AssertionError(f"restart optima on {held} devices, not {chips}")
    with jax.default_device(jax.devices()[0]):
        fitter = Fitter(model, num_restarts=2 * chips, maxiter=STEPS, tol=0.0)
        _, res = fitter(model, key)
    f_s, f_1 = float(jnp.min(fs)), float(jnp.min(res.f))
    log(f"  best -LML: sharded {f_s:.5f}, one card {f_1:.5f}")
    check("best -LML relative difference", abs(f_s - f_1) / abs(f_1), 1e-3)


def mesh_acq_argmax(mesh, model):
    """(3) sharded acquisition sweep + argmax vs the one-card replay, same key.

    A vmapped L-BFGS lane's result depends on the batch it runs in, so the
    replay polishes the anchors in the mesh's batch shape: one vmapped call per
    group of `anchors_per_device`, in the order the mesh hands them out. Its
    bound is the phase-2 LML bound; on 4 virtual CPU devices in float32 at
    N=1024 the two read 8.6e-07 apart."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu.ops import lbfgs
    from gaussian_process_optimization_tpu.parallel import sharded

    chips = mesh.devices.size
    state = (model, model.inference(precompute_inverse=True))

    def neg_lcb(state, Xc):
        mdl, p = state
        mu, v = mdl.predict(Xc, posterior=p)
        return mu[:, 0] - 2.0 * jnp.sqrt(v[:, 0])

    lo, hi = -2.0 * jnp.ones(D), 2.0 * jnp.ones(D)
    key = jax.random.PRNGKey(7)
    n_sweep = -(-1000 // chips) * chips
    cands = jax.random.uniform(key, (n_sweep, D), minval=lo, maxval=hi,
                               dtype=lo.dtype)
    per_device = 2
    s_s = sharded.make_sharded_sweep(neg_lcb, mesh)(state, cands)
    argmax = sharded.make_sharded_acq_argmax(
        neg_lcb, mesh, lo, hi, num_samples=1000, anchors_per_device=per_device,
        maxiter=50)
    x_s, f_s = argmax(state, key)
    with jax.default_device(jax.devices()[0]):
        scores = neg_lcb(state, cands)
        anchors = cands[jnp.argsort(scores)[:per_device * chips]]

        def solve(a):
            return lbfgs.minimize(lambda x: neg_lcb(state, x[None, :])[0], a,
                                  lower=lo, upper=hi, maxiter=50,
                                  carry_vjp=False).f

        polish = jax.jit(jax.vmap(solve))
        f_1 = min(float(jnp.min(polish(group)))
                  for group in anchors.reshape(chips, per_device, D))
        f_at_x = float(neg_lcb(state, x_s[None, :])[0])
    f_s, best_sweep = float(f_s), float(jnp.min(scores))
    check("sweep max |score difference| / max |score|",
          float(jnp.max(jnp.abs(s_s - scores)) / jnp.max(jnp.abs(scores))), 1e-5)
    check("reported -LCB vs -LCB at the reported point, relative",
          abs(f_s - f_at_x) / abs(f_at_x), 1e-5)
    log(f"  best -LCB: sharded {f_s:.6f}, one card {f_1:.6f}, "
        f"best sweep point {best_sweep:.6f}")
    if not f_s <= best_sweep:
        raise AssertionError("the polish lost to its own sweep")
    check("best -LCB relative difference", abs(f_s - f_1) / abs(f_1), 1e-4)


def mesh_distributed_cholesky(mesh, model, n_big=16384, nb=2048):
    """(4) distributed Cholesky LML + gradient vs a dense one-card LML, and
    every card holding its row block (nothing on card 0 alone).

    Runs before the other mesh checks, so each card's peak memory is this
    program's. The reference is the same LML as the distributed body (no jitter
    ladder) on one card with XLA's own Cholesky and triangular solve, so that
    at n_big its compile stays short. nb=2048 keeps the distributed panel loop,
    which is unrolled, at n_big/nb = 8 panels."""
    import jax
    import jax.numpy as jnp

    from bench import _data
    from gaussian_process_optimization_tpu.config import config
    from gaussian_process_optimization_tpu.models.gp import LOG_2_PI
    from gaussian_process_optimization_tpu.parallel import sharded

    chips = mesh.devices.size
    Xb, Yb = _data(n=n_big)
    Xb = jnp.asarray(Xb, model.X.dtype)
    Yb = jnp.asarray(Yb, model.X.dtype)
    dist = sharded.make_distributed_exact_lml(mesh, nb=nb)

    def dist_lml(k, noise):
        return dist(k, Xb, Yb, noise)

    def dense_lml(k, noise):
        n, p = Yb.shape
        Ky = k.K(Xb) + (noise + config.noise_jitter) * jnp.eye(n, dtype=Xb.dtype)
        L = jnp.linalg.cholesky(Ky)
        c = jax.scipy.linalg.solve_triangular(L, Yb, lower=True)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        return 0.5 * (-n * p * LOG_2_PI - p * logdet - jnp.sum(jnp.square(c)))

    noise = jnp.asarray(NOISE, Xb.dtype)
    v_d, g_d = timed("distributed value+grad (first call)",
                     jax.jit(jax.value_and_grad(dist_lml, argnums=(0, 1))),
                     model.kern, noise)
    for i, dev in enumerate(mesh.devices.flat):
        stats = dev.memory_stats()  # None on the CPU backend
        if stats is None and dev.platform != "gpu":
            continue
        peak = stats["peak_bytes_in_use"]
        log(f"  device {i} peak bytes in use: {peak}")
        if peak < n_big * n_big * 4 // chips:
            raise AssertionError(f"device {i} did not hold its row block")
    with jax.default_device(jax.devices()[0]):
        v_1, g_1 = timed("dense one-card value+grad (first call)",
                         jax.jit(jax.value_and_grad(dense_lml, argnums=(0, 1))),
                         model.kern, noise)
    log(f"  LML: distributed {float(v_d):.4f}, one card {float(v_1):.4f}")
    check("LML relative error", abs(float(v_d) - float(v_1)) / abs(float(v_1)),
          LML_BOUND)
    check("gradient relative L2 error", _rel_l2(_flat(g_d), _flat(g_1)),
          GRAD_BOUND)


def mesh_bo_iteration(mesh):
    """(5) one BayesianOptimization(mesh=...) iteration on Hartmann6."""
    from gaussian_process_optimization_tpu.bo import (BayesianOptimization,
                                                      bounds_to_space, objectives)

    bo = BayesianOptimization(
        f=lambda x: np.asarray(objectives.hartmann6(x)),
        domain=bounds_to_space(objectives.hartmann6.bounds),
        acquisition_type="EI", initial_design_numdata=20,
        initial_design_type="latin", exact_feval=True, seed=0, mesh=mesh,
        optimize_restarts=RESTARTS, max_iters=STEPS)
    t0 = time.perf_counter()
    bo.run_optimization(max_iter=1, eps=-1)
    log(f"  1 iteration: {time.perf_counter() - t0:.1f} s, "
        f"{bo.Y.shape[0]} evaluations, fx_opt {bo.fx_opt:.4f}")
    if bo.Y.shape[0] != 21 or not np.isfinite(bo.fx_opt):
        raise AssertionError("mesh BO iteration did not complete")


def make_mesh_of(chips, platform="gpu"):
    from gaussian_process_optimization_tpu.parallel import sharded

    mesh = sharded.make_mesh(chips)
    if mesh.devices.size != chips or any(d.platform != platform
                                         for d in mesh.devices.flat):
        raise AssertionError(f"mesh is not {chips} {platform} devices: "
                             f"{mesh.devices}")
    log(f"  mesh: {mesh.devices.tolist()}")
    return mesh


def multichip_phase(chips, n=N, n_big=16384, nb=2048, platform="gpu"):
    """Each mesh entry point beside the one-card result it must reproduce
    (`n`: headline rows; `n_big`, `nb`: rows and panel width of the distributed
    Cholesky check)."""
    from bench import _data

    mesh = make_mesh_of(chips, platform)
    model = headline_model(*_data(n))
    with phase(f"distributed Cholesky LML and gradient, N={n_big}"):
        mesh_distributed_cholesky(mesh, model, n_big, nb)
    with phase("sharded exact LML and gradient"):
        mesh_exact_lml(mesh, model)
    with phase("restart-sharded multistart fit"):
        mesh_multistart_fit(mesh, model)
    with phase("sharded acquisition sweep and argmax"):
        mesh_acq_argmax(mesh, model)
    with phase(f"BayesianOptimization(mesh=make_mesh({chips})) iteration"):
        mesh_bo_iteration(mesh)


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh path on four GPUs")
    args = ap.parse_args(argv)

    with phase("1. device"):
        device = device_phase(args.chips)
    if args.chips > 1:
        with phase(f"mesh path on {args.chips} GPUs"):
            multichip_phase(args.chips)
    else:
        from bench import _data

        X, Y = _data(N, D)
        with phase("2. correctness at N=4096, D=6"):
            correctness_phase(X, Y)
            ladder_phase(N)
        with phase("3. main path"):
            headline_bo(X, Y)
            gower_lp_bo(N)
            branin_bo()
            fit_memory(X, Y)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
