"""Benchmark harness — BASELINE.json headline metric.

Workload (one BO iteration at N=4096, the reference's hot loop, SURVEY §3.2):
  FIT: 5 restarts x 30 L-BFGS steps on the exact-GP negative LML
       (each step: K build O(N^2 D) + Cholesky O(N^3) + solves + full gradient)
  ACQ: EI argmax = 1000-candidate sweep (batch predict) + 5 anchors x 50 L-BFGS
       steps with analytic gradients (predict + d(mean,std)/dx per step)

Ours runs the whole workload as jitted GPU programs (vmapped restarts / anchors).
The baseline is the same mathematical workload implemented the reference's way —
float64 numpy/LAPACK on the host CPU, serial restarts — measured on a few steps and
extrapolated linearly (the per-step cost is shape-stationary). The reference itself
(GPy/GPyOpt, python 3.6 era) cannot run in this environment; this baseline
re-implements its exact per-step math (exact_gaussian_inference.py:37 + analytic
kernel gradients + posterior.py:274 predict), which is what its runtime is made of.

Prints ONE JSON line: {"metric", "value" (seconds, ours), "unit", "vs_baseline"
(baseline_seconds / ours_seconds, >1 = we are faster)}.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np


# Published dense peaks, keyed by jax's device_kind. H100 SXM: NVIDIA H100 data
# sheet (dense, no sparsity), at the full 700 W power limit. A device that is
# not listed has no assumed peak: peak_for() raises.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 67.0},
}


def peak_for(device_kind):
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peak for device_kind {device_kind!r}; "
                       f"add it to bench.PEAKS with its source") from None


def gpu_info():
    """The accelerator this run measures: platform, device_kind, count, and the
    card's name and power limit as nvidia-smi reports them. Raises RuntimeError
    unless JAX's default backend is a GPU — nothing here falls back to the CPU."""
    import subprocess

    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: jax default backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi.stdout.strip()}


N = 4096
D = 6
FIT_RESTARTS = 5
FIT_STEPS = 30
ACQ_SWEEP = 1000
ACQ_ANCHORS = 5
ACQ_STEPS = 50


def _data(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    Y = np.sin(X[:, :1] * 2.0) + 0.3 * np.cos(X.sum(1, keepdims=True)) \
        + 0.05 * rng.standard_normal((n, 1))
    return X, Y


# --------------------------------------------------------------------------- ours
def run_ours():
    import jax
    import jax.numpy as jnp

    import gaussian_process_optimization_tpu.kernels as kern
    from gaussian_process_optimization_tpu.bo.acquisitions import get_quantiles
    from gaussian_process_optimization_tpu.models import fit as fit_mod
    from gaussian_process_optimization_tpu.models.gp import GPRegression
    from gaussian_process_optimization_tpu.ops import lbfgs

    X, Y = _data()
    model = GPRegression.create(
        X, Y, kernel=kern.Matern52.create(D, ARD=True), noise_var=0.05, max_points=N
    )

    fitter = fit_mod.Fitter(model, num_restarts=FIT_RESTARTS, maxiter=FIT_STEPS,
                            tol=0.0)

    # ---- FIT ----
    # Each timed call draws other restart starts (a fresh PRNG key): the
    # while_loop trip counts are data-dependent, so the median is over starts.
    jax.block_until_ready(fitter(model, jax.random.PRNGKey(0)))  # compile
    fit_times = []
    num_ls = None
    for i in range(3):
        t0 = time.perf_counter()
        fitted, res = jax.block_until_ready(
            fitter(model, jax.random.PRNGKey(1 + i)))
        fit_times.append(time.perf_counter() - t0)
        # per-lane line-search trial counts: each trial is a full batched
        # forward and the batch pays the MAX over lanes per step, so this is
        # the data-dependent part of the fit cost — recorded so a fit-time
        # swing is explainable from the JSON
        num_ls = np.asarray(res.num_ls).tolist()
    t_fit = float(np.median(fit_times))

    # ---- ACQ ----
    post = fitted.inference(precompute_inverse=True)
    fmin = jnp.min(jnp.where(fitted.mask[:, None] > 0,
                             fitted.predict(fitted.X, posterior=post)[0], jnp.inf))

    def neg_ei(x_batch):
        mu, v = fitted.predict(x_batch, posterior=post)
        s = jnp.sqrt(jnp.clip(v, 1e-10, None))
        phi, Phi, u = get_quantiles(0.01, fmin, mu, s)
        return -(s * (u * Phi + phi))[:, 0]

    lo, hi = -2.0 * jnp.ones(D), 2.0 * jnp.ones(D)

    @jax.jit
    def acq_argmax(key):
        cands = jax.random.uniform(key, (ACQ_SWEEP, D), minval=lo, maxval=hi,
                                   dtype=fitted.X.dtype)
        scores = neg_ei(cands)
        anchors = cands[jnp.argsort(scores)[:ACQ_ANCHORS]]

        def solve(a):
            res = lbfgs.minimize(lambda x: neg_ei(x[None, :])[0], a,
                                 lower=lo, upper=hi, maxiter=ACQ_STEPS, tol=0.0,
                                 carry_vjp=False)
            return res.x, res.f

        xs, fs = jax.vmap(solve)(anchors)
        best = jnp.argmin(fs)
        return xs[best], fs[best]

    run_ours.num_ls = num_ls  # surfaced into detail by main()

    jax.block_until_ready(acq_argmax(jax.random.PRNGKey(1)))  # compile
    acq_times = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(acq_argmax(jax.random.PRNGKey(2 + i)))
        acq_times.append(time.perf_counter() - t0)
    t_acq = float(np.median(acq_times))

    return t_fit, t_acq


# ----------------------------------------------------------- thesis LP-batch path
def gower_lp_problem(n=N, seed=0):
    """The thesis workload's data: 4 continuous + 2 three-level discrete inputs,
    with its GPyOpt domain. Returns (X, Y, domain)."""
    rng = np.random.default_rng(seed)
    Xc = rng.uniform(-2.0, 2.0, (n, 4))
    Xd = rng.integers(0, 3, (n, 2)).astype(float)
    X = np.hstack([Xc, Xd])
    Y = (np.sin(Xc[:, :1] * 2.0) + 0.3 * np.cos(Xc.sum(1, keepdims=True))
         + 0.1 * Xd[:, :1] + 0.05 * rng.standard_normal((n, 1)))
    domain = (
        [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)}
         for i in range(4)]
        + [{"name": f"d{i}", "type": "discrete", "domain": (0, 1, 2)}
           for i in range(2)]
    )
    return X, Y, domain


def run_gower_lp():
    """Mixed-Gower local-penalization batch-5 iteration at N=4096: the thesis
    pipeline's hot path (reference
    GPyOpt/core/evaluators/batch_local_penalization.py:22-65 + the author's Gower
    kernel), timed as fit + estimate_L + 5 penalized acquisition argmaxes via
    suggest_next_locations (ask-tell). Returns the warm median over 3 calls on
    perturbed Y (suggest_next_locations returns host numpy, so each call has
    finished on the device when it returns)."""
    from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization

    X, Y, domain = gower_lp_problem()
    bo = BayesianOptimization(
        f=None, domain=domain, X=X, Y=Y, Gower=True, acquisition_type="EI",
        evaluator_type="local_penalization", batch_size=5, exact_feval=True,
        seed=0, max_iters=FIT_STEPS, optimize_restarts=FIT_RESTARTS,
    )
    batch = bo.suggest_next_locations()  # compile + warm
    assert batch.shape == (5, 6)
    times = []
    for i in range(3):
        bo.Y = Y + 0.01 * np.random.default_rng(10 + i).standard_normal((N, 1))
        t0 = time.perf_counter()
        batch = bo.suggest_next_locations()
        times.append(time.perf_counter() - t0)
        assert batch.shape == (5, 6)
    return float(np.median(times))


# ------------------------------------------------------------- dense-N scaling
def run_scaling(sizes, peak_tflops):
    """Opt-in (python bench.py --scaling): dense exact-GP fit at larger N, where
    the CPU reference becomes unusable. Reports wall seconds and effective
    TFLOP/s from the cubic FLOP model (per L-BFGS step, B=restarts lanes):

        forwards:  n_fwd * B * (N^3/3)            Cholesky
        backward:  1     * B * (N^3/3 + N^3/6 + N^3/3)
                   re-used chol factor + tri_inv_lower + tri_tdot
        (K build and solves are O(N^2) — <2% at these N, ignored)

    with n_fwd read from the fit result's num_ls (per-lane mean). Matmuls run
    at 'highest' (IEEE float32, no tensor cores), so the share is reported
    against the device's published float32 peak (`peak_for`)."""
    import jax

    import gaussian_process_optimization_tpu.kernels as kern
    from gaussian_process_optimization_tpu.models import fit as fit_mod
    from gaussian_process_optimization_tpu.models.gp import GPRegression

    rows = []
    for n in sizes:
        # Device memory: the fit carries ~5 Gram-sized f32 buffers per lane
        # (Ky, L, the carried-vjp residuals, Li + tri_tdot in the backward):
        # ~5.4 GB/lane at N=16384, ~21 GB/lane at N=32768. The same restart
        # counts per N on every device, so rows compare across devices.
        restarts = FIT_RESTARTS if n <= 8192 else (2 if n <= 16384 else 1)
        X, Y = _data(n=n)
        model = GPRegression.create(
            X, Y, kernel=kern.Matern52.create(D, ARD=True), noise_var=0.05,
            max_points=n)
        fitter = fit_mod.Fitter(model, num_restarts=restarts,
                                maxiter=FIT_STEPS, tol=0.0)
        jax.block_until_ready(fitter(model, jax.random.PRNGKey(0)))  # compile
        times = []
        n_ls = None
        for i in range(2):
            t0 = time.perf_counter()
            fitted, res = jax.block_until_ready(
                fitter(model, jax.random.PRNGKey(1 + i)))
            times.append(time.perf_counter() - t0)
            n_ls = np.asarray(res.num_ls)
        t = float(np.median(times))
        fwd_per_lane = float(n_ls.mean()) / FIT_STEPS  # accepted trials/step
        flops_step = restarts * (
            fwd_per_lane * n**3 / 3.0 + (n**3 / 3 + n**3 / 6 + n**3 / 3))
        tflops = flops_step * FIT_STEPS / t / 1e12
        rows.append({
            "N": n, "restarts": restarts, "fit_s": t,
            "per_step_ms": 1e3 * t / FIT_STEPS,
            "trials_per_step": fwd_per_lane,
            "eff_tflops": tflops,
            "pct_fp32_peak": 100.0 * tflops / peak_tflops,
        })
        print(f"# scaling N={n}: {rows[-1]}", file=sys.stderr)
    return rows


# ----------------------------------------------------------------------- baseline
def run_baseline():
    """Reference-equivalent math in float64 numpy/LAPACK on the host CPU. Measures
    several L-BFGS-step-equivalents and acquisition steps (warmup + median, BLAS
    thread count pinned) and extrapolates to the workload — per-step cost is
    shape-stationary, and the median over >=5 steps keeps the headline multiplier
    stable under host load (it swung ~5x between rounds off 2 measured steps)."""
    import scipy.linalg as sla

    try:  # pin BLAS threads so the baseline is load-stable and reproducible
        from threadpoolctl import threadpool_limits
    except Exception:  # pragma: no cover
        from contextlib import nullcontext

        def threadpool_limits(*a, **k):
            return nullcontext()

    X, Y = _data()
    Xf, Yf = X.astype(np.float64), Y.astype(np.float64)
    var, noise = 1.0, 0.05
    ls = np.ones(D)

    def kern_K(A, B=None):
        B = A if B is None else B
        d2 = ((A[:, None, :] / ls - B[None, :, :] / ls) ** 2).sum(-1)
        r = np.sqrt(np.maximum(d2, 0))
        return var * (1 + np.sqrt(5) * r + 5 / 3 * r**2) * np.exp(-np.sqrt(5) * r), r

    def one_fit_step():
        # the work inside ONE L-BFGS iteration of the reference fit (SURVEY 3.2):
        # K build + Cholesky + alpha + dL_dK + kernel gradient contractions
        K, r = kern_K(Xf)
        Ky = K + (noise + 1e-8) * np.eye(N)
        L = sla.cholesky(Ky, lower=True)
        alpha = sla.cho_solve((L, True), Yf)
        Wi = sla.cho_solve((L, True), np.eye(N))
        dL_dK = 0.5 * (alpha @ alpha.T - Wi)
        # stationary.update_gradients_full: variance grad + ARD lengthscale grads
        _ = np.sum(K * dL_dK) / var
        dK_dr = var * (-5.0 / 3.0) * r * (1 + np.sqrt(5) * r) * np.exp(-np.sqrt(5) * r)
        tmp = dL_dK * dK_dr
        for d in range(D):  # the stationary_utils.c lengthscale loop, vectorized
            dist2 = (Xf[:, None, d] - Xf[None, :, d]) ** 2
            _ = np.sum(tmp * dist2)
        return L, alpha

    import os

    # never oversubscribe: more BLAS threads than cores runs slower
    n_threads = max(1, min(4, os.cpu_count() or 1))
    with threadpool_limits(limits=n_threads):
        L, alpha = one_fit_step()  # warmup (page-in, BLAS pool spin-up)
        step_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            L, alpha = one_fit_step()
            step_times.append(time.perf_counter() - t0)
        per_fit_step = float(np.median(step_times))
        t_fit = per_fit_step * FIT_RESTARTS * FIT_STEPS

        # acquisition: candidate sweep + per-step predict-with-gradients
        rng = np.random.default_rng(1)

        def predict(Xs):
            Ks, _ = kern_K(Xf, Xs)
            mu = Ks.T @ alpha
            tmp = sla.solve_triangular(L, Ks, lower=True)
            v = np.maximum(var - (tmp**2).sum(0), 1e-10) + noise
            return mu, np.sqrt(v)

        cands = rng.uniform(-2, 2, size=(ACQ_SWEEP, D))
        predict(cands)  # warmup
        sweep_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            predict(cands)
            sweep_times.append(time.perf_counter() - t0)
        t_sweep = float(np.median(sweep_times))

        def one_acq_step():
            # one multistart L-BFGS step: predict + gradients at 1 pt
            x = rng.uniform(-2, 2, size=(1, D))
            Ks, r = kern_K(Xf, x)
            mu = Ks.T @ alpha
            tmp = sla.solve_triangular(L, Ks, lower=True)
            v = np.maximum(var - (tmp**2).sum(0), 1e-10)
            # dmu/dx, dv/dx via dK/dx (gradients_X path)
            dK_dr = var * (-5.0 / 3.0) * r * (1 + np.sqrt(5) * r) \
                * np.exp(-np.sqrt(5) * r)
            safe_r = np.where(r == 0, 1.0, r)
            w = dK_dr / safe_r
            diff = (x[None, :, :] - Xf[:, None, :]) / ls**2
            dKs = w[:, :, None] * diff
            _ = (dKs * alpha[:, None, :]).sum(0)
            _ = sla.cho_solve((L, True), Ks)

        one_acq_step()  # warmup
        acq_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            one_acq_step()
            acq_times.append(time.perf_counter() - t0)
        per_acq_step = float(np.median(acq_times))
        t_acq = t_sweep + per_acq_step * ACQ_ANCHORS * ACQ_STEPS

    detail = {
        "fit_step_median_s": round(per_fit_step, 3),
        "fit_step_min_s": round(float(np.min(step_times)), 3),
        "acq_step_median_s": round(per_acq_step, 4),
        "blas_threads": n_threads,
    }
    return t_fit, t_acq, detail


def main():
    try:
        device = gpu_info()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        sys.exit(1)
    peak = peak_for(device["kind"])
    from gaussian_process_optimization_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    if "--scaling" in sys.argv:
        # `--scaling` runs the default N grid; `--scaling=4096,32768` selects
        # sizes (budget a long first compile at the largest N).
        sizes = (4096, 8192, 16384)
        for a in sys.argv:
            if a.startswith("--scaling="):
                sizes = tuple(int(s) for s in a.split("=", 1)[1].split(","))
        print(json.dumps({"device": device, "scaling": run_scaling(
            sizes, peak_tflops=peak["fp32_tflops"])}))
        return
    ours_fit, ours_acq = run_ours()
    t_gower_lp = run_gower_lp()
    base_fit, base_acq, base_detail = run_baseline()
    ours = ours_fit + ours_acq
    base = base_fit + base_acq
    # BASELINE.json's north star is "a 32-core CPU host"; the companion figure
    # assumes IDEAL 32-way scaling of the measured arm (conservative in the
    # baseline's favor: LAPACK potrf/solve never scale ideally, and the
    # O(N^2 D) kernel-gradient loops are memory-bound).
    base_32 = base / 32.0
    result = {
        "metric": f"BO iteration wall-clock @ N={N} (fit {FIT_RESTARTS}x{FIT_STEPS} "
                  f"L-BFGS + EI argmax {ACQ_SWEEP}-sweep + {ACQ_ANCHORS}x{ACQ_STEPS})",
        "value": round(ours, 4),
        "unit": "s",
        "vs_baseline": round(base / ours, 2),
        "device": device,
        "detail": {
            # north-star companion: BASELINE.json names a 32-core host; ideal
            # 32-way scaling of the measured arm — see base_32 above.
            "baseline_32core_est_s": round(base_32, 2),
            "vs_baseline_32core": round(base_32 / ours, 2),
            "ours_fit_s": round(ours_fit, 4),
            "ours_acq_s": round(ours_acq, 4),
            # per-lane line-search forwards over the 30 fit steps (see run_ours)
            "fit_num_ls": getattr(run_ours, "num_ls", None),
            # thesis pipeline hot path: mixed-Gower LP batch-5 iteration
            # (fit + estimate_L + 5 penalized argmaxes), warm median
            "gower_lp_batch_s": round(t_gower_lp, 4),
            "baseline_fit_s": round(base_fit, 2),
            "baseline_acq_s": round(base_acq, 2),
            "baseline": "float64 numpy/LAPACK reference-equivalent math on host CPU "
                        "(warmup + median of 5 steps, BLAS threads pinned, "
                        "extrapolated)",
            **base_detail,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
