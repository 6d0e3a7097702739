"""Thesis-workload parity benchmark .

The EI-sequential parity study (regret_compare.py) certifies the exact-GP/EI
path; THIS certifies the pipeline the reference thesis actually runs:

Part A — mixed-space Gower + LP batch (reference ``test.py:439-508``):
  the `balance` objective (test.py:15-82, replicated below with its exact
  constants), 2-D mixed space {position_L in [1,10] continuous, item_L in
  {0..5} discrete}, LatinMixed initial design of 20, then 20 ask-tell
  iterations: rebuild BayesianOptimization(f=None, X, Y, EI, Gower=True,
  normalize_Y=True, exact_feval=False, local_penalization batch 5,
  de_duplication=True) -> suggest_next_locations() -> evaluate -> append.
  10 seeds on each backend; parity = overlapping IQRs of final simple regret
  (fmin computed by dense grid over the mixed space).

Part B — finite-pool selection (reference ``run.py:1234-1267``):
  a fixed 300-row mixed candidate pool, 20 evaluated rows, EI acquisition
  with LP batch 5 picked via ``suggest_from_pool``. Agreement stats between
  GPU f32 and CPU f64: per-seed batch overlap (|intersection|/5) and
  Spearman rank correlation of the pool's EI scores.

Part A2 — multimodal selector-surface regret (reference ``test2.py:10-66``):
  the same LP-batch pipeline on the 10-function selector surface (each level
  a classic multimodal 1-D test function mapped into [0,1]^2). Unlike
  `balance`, per-seed final regret genuinely varies, making the IQR-overlap
  parity statement discriminative (VERDICT r3 weak #3).

Part C — surrogate accuracy (reference ``test2.py:116-258``
  compare_with_actual): Hammersley 200 design over (x, selector), one GP fit,
  per-level actual-vs-predicted RMSE on 1000-point grids; backends compared
  level by level.

Each backend runs in its own child process, one after another (the platform is
fixed at jax init, and one JAX process holds the card; the parent never imports
jax). Raw results merge into thesis_raw.json; the report is appended/refreshed
in RESULTS.md under '# Thesis workload parity'.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RAW = ROOT / "benchmarks" / "thesis_raw.json"
RESULTS = ROOT / "benchmarks" / "RESULTS.md"

SEEDS = 10
ITERS = 20
BATCH = 5

CHILD = r"""
import sys, json
sys.path.insert(0, {root!r})
import jax
from gaussian_process_optimization_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
if {cpu}:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", {x64})
import numpy as np
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization
from gaussian_process_optimization_tpu.bo.space import DesignSpace
from gaussian_process_optimization_tpu.bo.designs import initial_design
from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu.bo.acquisitions import AcquisitionEI, AcquisitionLP
from gaussian_process_optimization_tpu.bo.pool import suggest_from_pool, score_pool

# ---- the reference balance objective (test.py:15-82, exact constants) ----
WEIGHTS_L = (100, 55, 20, 88, 75, 42)
WEIGHT_R = 16  # weights_R[1]; item_R fixed to 1 (test.py:31)

def get_y(x):
    return 9 * np.sin(2.8 * x) ** 2 * np.sin(7 * x + 3) * np.cos(2.5 * x)

def transform(x):
    return np.sqrt(x ** 2 + get_y(x) ** 2)

def balance(x_array):
    pos = x_array[:, [0]]
    item = x_array[:, [1]].astype(int)
    w_l = np.asarray(WEIGHTS_L, dtype=float)[item[:, 0]][:, None]
    return w_l * transform(pos) / WEIGHT_R

DOMAIN = [
    {{'name': 'position_L', 'type': 'continuous', 'domain': (1, 10)}},
    {{'name': 'item_L', 'type': 'discrete', 'domain': tuple(range(6))}},
]

# true optimum by dense grid (regret reference)
_grid = np.linspace(1, 10, 200001)[:, None]
FMIN = float(min(WEIGHTS_L) * transform(_grid).min() / WEIGHT_R)

# ---- the reference test2.py selector surface (test2.py:10-66, exact
# regions): 10 classic 1-D test functions, each affinely mapped so its
# region of interest fills [0,1]^2; the discrete column picks the function.
# Multimodal per level -> seeds genuinely diverge (VERDICT r3 weak #3).
_REGIONS = {{
    1: ((2.7, 7.5), (-2.0, 1.0)),
    2: ((1.9, 3.9), (-4.0, -2.4)),
    3: ((0.0, 1.2), (-1.5, 2.5)),
    4: ((-10.0, 10.0), (-1.0, 1.0)),
    5: ((2.7, 7.5), (-2.0, 3.0)),
    6: ((0.0, 10.0), (-8.0, 6.0)),
    7: ((0.0, 2.0 * np.pi), (-1.0, 1.0)),
    8: ((0.001, 0.99), (-1.6, -1.0)),
    9: ((0.0, 4.0), (-0.8, 0.6)),
    10: ((-5.0, 5.0), (-1.0, 8.0)),
}}

def _raw_f(sel, h):
    if sel == 1:
        return np.sin(h) + np.sin(10 * h / 3)
    if sel == 2:
        return -(16 * h**2 - 24 * h + 5) * np.exp(-h)
    if sel == 3:
        return -(1.4 - 3 * h) * np.sin(18 * h)
    if sel == 4:
        return -(h + np.sin(h)) * np.exp(-(h**2))
    if sel == 5:
        return np.sin(h) + np.sin(10 * h / 3) + np.log(h) - 0.84 * h + 3
    if sel == 6:
        return -h * np.sin(h)
    if sel == 7:
        return np.sin(h) ** 3 + np.cos(h) ** 3
    if sel == 8:
        return -h ** (2 / 3) - np.cbrt(1 - h**2)
    if sel == 9:
        return -np.exp(-h) * np.sin(2 * np.pi * h)
    return (h**2 - 5 * h + 6) / (h**2 + 1)

def equation_vec(x, sel):
    (rx0, rx1), (ry0, ry1) = _REGIONS[int(sel)]
    h = np.asarray(x, dtype=float) * (rx1 - rx0) + rx0
    return (_raw_f(int(sel), h) - ry0) / (ry1 - ry0)

def equation_xy(X):
    X = np.atleast_2d(np.asarray(X, dtype=float))
    y = np.empty((X.shape[0], 1))
    for i in range(X.shape[0]):
        y[i, 0] = equation_vec(X[i, 0], int(round(X[i, 1])))
    return y

DOMAIN2 = [
    {{'name': 'x', 'type': 'continuous', 'domain': (0.0, 1.0)}},
    {{'name': 'sel', 'type': 'discrete', 'domain': tuple(range(1, 11))}},
]
_g2 = np.linspace(0, 1, 20001)
FMIN2 = float(min(equation_vec(_g2, lvl).min() for lvl in range(1, 11)))

out = {{"batch": [], "pool": [], "equation": [], "surrogate_rmse": {{}}}}

# parts to run (part-wise caching: a backend that already has Parts A/B from
# an earlier round only pays for the missing parts)
RUN = {parts!r}

# --------------------------------------------------- Part A: LP batch loop
for seed in range({seeds} if "batch" in RUN else 0):
    space = DesignSpace(DOMAIN)
    X = np.asarray(initial_design("latin_mixed", space, 20, seed=seed), dtype=float)
    Y = balance(X)
    for it in range({iters}):
        prob = BayesianOptimization(
            f=None, domain=DOMAIN, X=X, Y=Y,
            acquisition_type="EI", normalize_Y=True, exact_feval=False,
            evaluator_type="local_penalization", batch_size={batch},
            de_duplication=True, Gower=True, seed=seed)
        x_next = np.asarray(prob.suggest_next_locations(), dtype=float)
        X = np.vstack([X, x_next])
        Y = np.vstack([Y, balance(x_next)])
    regret = float(Y.min() - FMIN)
    out["batch"].append(regret)
    print("# batch seed {{}}: final regret {{:.4f}} (n={{}})".format(
        seed, regret, X.shape[0]), flush=True)

# ------------------------------------------------ Part B: pool selection
for seed in range({seeds} if "pool" in RUN else 0):
    rng = np.random.default_rng(1000 + seed)  # identical pools on both backends
    pool = np.column_stack([
        rng.uniform(1, 10, 300), rng.integers(0, 6, 300).astype(float)])
    space = DesignSpace(DOMAIN)
    X0 = np.asarray(initial_design("latin_mixed", space, 20, seed=seed), dtype=float)
    Y0 = balance(X0)
    prob = BayesianOptimization(
        f=None, domain=DOMAIN, X=X0, Y=Y0,
        acquisition_type="EI", normalize_Y=True, exact_feval=False,
        evaluator_type="local_penalization", batch_size={batch},
        de_duplication=True, Gower=True, seed=seed)
    prob._update_model()  # fit the surrogate on (X0, Y0)
    lp = prob.evaluator.acquisition
    idx, picks = suggest_from_pool(lp, pool, space, batch_size={batch})
    scores, _ = score_pool(lp.acquisition if hasattr(lp, "acquisition") else lp,
                           pool, space)
    out["pool"].append({{"idx": [int(i) for i in idx],
                        "scores": np.asarray(scores, dtype=float).tolist()}})
    print("# pool seed {{}}: picks {{}}".format(seed, list(idx)), flush=True)

# ------------------------- Part A2: multimodal mixed regret (VERDICT r3 #4)
# balance collapses to the same optimum under every seed (all 10 CPU seeds
# tie, thesis_raw.json r3) — the selector surface is multimodal per level,
# so final regret actually varies and parity is a real test.
for seed in range({seeds} if "equation" in RUN else 0):
    space = DesignSpace(DOMAIN2)
    X = np.asarray(initial_design("latin_mixed", space, 10, seed=seed), dtype=float)
    Y = equation_xy(X)
    for it in range(8):
        prob = BayesianOptimization(
            f=None, domain=DOMAIN2, X=X, Y=Y,
            acquisition_type="EI", normalize_Y=True, exact_feval=False,
            evaluator_type="local_penalization", batch_size={batch},
            de_duplication=True, Gower=True, seed=seed)
        x_next = np.asarray(prob.suggest_next_locations(), dtype=float)
        X = np.vstack([X, x_next])
        Y = np.vstack([Y, equation_xy(x_next)])
    regret = float(Y.min() - FMIN2)
    out["equation"].append(regret)
    print("# equation seed {{}}: final regret {{:.4f}}".format(seed, regret),
          flush=True)

# --------------- Part C: surrogate accuracy protocol (test2.py:116-258)
# Hammersley 200 design over (x, selector), one GP fit, per-level
# actual-vs-predicted RMSE on a 1000-point grid per discrete level.
from gaussian_process_optimization_tpu.bo.designs import hammersley_design
_space_unit = DesignSpace([
    {{'name': 'x', 'type': 'continuous', 'domain': (0.0, 1.0)}},
    {{'name': 'u', 'type': 'continuous', 'domain': (0.0, 1.0)}}])
_base = np.asarray(hammersley_design(_space_unit, 200), dtype=float)
Xc = np.column_stack([_base[:, 0], np.rint(_base[:, 1] * 9 + 1)])
Yc = equation_xy(Xc)
_xg = np.linspace(0, 1, 1000)
# fit-restart seeds (the design itself is deterministic)
for seed in range(3 if "surrogate_rmse" in RUN else 0):
    prob = BayesianOptimization(
        f=None, domain=DOMAIN2, X=Xc, Y=Yc,
        acquisition_type="EI", normalize_Y=True, exact_feval=False,
        evaluator_type="local_penalization", batch_size={batch},
        de_duplication=True, Gower=True, seed=seed)
    prob._update_model()
    # the surrogate is fit on 'stats'-normalized Y (bo_loop.py:167,
    # normalize_stats = (Y - mean)/std); predictions must be mapped back to
    # objective scale before comparing against the true function
    _ym, _ys = float(Yc.mean()), float(Yc.std())
    per_level = []
    for lvl in range(1, 11):
        Xg = np.column_stack([_xg, np.full_like(_xg, float(lvl))])
        mu, _ = prob.model.predict(Xg)
        mu = np.asarray(mu).ravel() * (_ys if _ys > 0 else 1.0) + _ym
        err = mu - equation_vec(_xg, lvl)
        per_level.append(float(np.sqrt(np.mean(err ** 2))))
    out["surrogate_rmse"][str(seed)] = per_level
    print("# surrogate seed {{}}: per-level RMSE {{}}".format(
        seed, [round(v, 4) for v in per_level]), flush=True)

print("RESULT::" + json.dumps(out))
"""


ALL_PARTS = ("batch", "pool", "equation", "surrogate_rmse")


def run_backend(cpu, x64=True, parts=ALL_PARTS):
    code = CHILD.format(root=str(ROOT), cpu=cpu, x64=x64, seeds=SEEDS,
                        iters=ITERS, batch=BATCH, parts=tuple(parts))
    # Stream the child's combined ougput to a log file INCREMENTALLY (tee) so a
    # child killed mid-run still leaves its progress on disk for diagnosis.
    log = ROOT / "benchmarks" / "logs" / f"thesis_child_{'cpu' if cpu else 'gpu'}.log"
    log.parent.mkdir(exist_ok=True)
    result = None
    with open(log, "w") as lf:
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:
                lf.write(line)
                lf.flush()
                if line.startswith("#"):
                    print(line.rstrip("\n"), flush=True)
                if line.startswith("RESULT::"):
                    result = json.loads(line[len("RESULT::"):])
            proc.wait(timeout=4 * 3600)
        finally:
            if proc.poll() is None:
                proc.kill()
    if result is not None:
        return result
    raise RuntimeError(
        f"backend cpu={cpu} produced no RESULT (rc={proc.returncode}; "
        f"child ougput in {log})")


def spearman(a, b):
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))


def iqr(v):
    return float(np.percentile(v, 25)), float(np.percentile(v, 75))


def report(raw):
    gpu_b = np.asarray(raw["gpu"]["batch"])
    cpu_b = np.asarray(raw["cpu"]["batch"])
    f32_b = np.asarray(raw["cpu_f32"]["batch"]) if "cpu_f32" in raw else None
    lo_t, hi_t = iqr(gpu_b)
    lo_c, hi_c = iqr(cpu_b)
    # strict IQR overlap is brittle when a backend's seeds all collapse to the
    # same tiny regret (degenerate IQR); 0.01 is 1e-4 of the objective range
    tol = 0.01
    overlap = (lo_t <= hi_c + tol) and (lo_c <= hi_t + tol)

    overlaps, rhos = [], []
    for pt, pc in zip(raw["gpu"]["pool"], raw["cpu"]["pool"]):
        inter = len(set(pt["idx"]) & set(pc["idx"]))
        overlaps.append(inter / BATCH)
        rhos.append(spearman(np.asarray(pt["scores"]), np.asarray(pc["scores"])))

    lines = [
        "",
        "# Thesis workload parity (mixed Gower + LP batch; finite pool)",
        "",
        f"Reference pipeline: test.py:439-508 (balance objective, LatinMixed init 20, "
        f"{ITERS} iterations x batch {BATCH} local-penalization EI, Gower=True, "
        f"de_duplication) and run.py:1234-1267 (300-point pool, EI+LP batch "
        f"{BATCH}). {SEEDS} seeds per backend.",
        "",
        "## Batch-loop final simple regret",
        "",
        f"- CPU f64: median {np.median(cpu_b):.4f}, IQR [{lo_c:.4f}, {hi_c:.4f}] — "
        f"seeds: {[round(float(v), 4) for v in sorted(cpu_b)]}",
        f"- GPU f32: median {np.median(gpu_b):.4f}, IQR [{lo_t:.4f}, {hi_t:.4f}] — "
        f"seeds: {[round(float(v), 4) for v in sorted(gpu_b)]}",
        f"- IQRs overlap: **{overlap}**",
    ]
    if f32_b is not None:
        lo_f, hi_f = iqr(f32_b)
        lines += [
            f"- CPU f32 control (same pipeline, host CPU at f32 — isolates "
            f"precision from hardware): median {np.median(f32_b):.4f}, "
            f"IQR [{lo_f:.4f}, {hi_f:.4f}] — "
            f"seeds: {[round(float(v), 4) for v in sorted(f32_b)]}",
        ]
    lines += [
        "",
        "## Pool-selection agreement (GPU f32 vs CPU f64)",
        "",
        f"- batch overlap |∩|/{BATCH}: mean {np.mean(overlaps):.2f}, "
        f"per seed {[round(v, 2) for v in overlaps]}",
        f"- Spearman rank corr of pool EI scores: median {np.median(rhos):.4f}, "
        f"min {np.min(rhos):.4f}",
    ]

    # Part A2 (multimodal selector surface, test2.py): regret varies across
    # seeds, so IQR overlap here is a discriminative parity statement
    if raw["gpu"].get("equation") and raw["cpu"].get("equation"):
        eq_t = np.asarray(raw["gpu"]["equation"])
        eq_c = np.asarray(raw["cpu"]["equation"])
        lo_t2, hi_t2 = iqr(eq_t)
        lo_c2, hi_c2 = iqr(eq_c)
        ov2 = (lo_t2 <= hi_c2 + 1e-6) and (lo_c2 <= hi_t2 + 1e-6)
        lines += [
            "",
            "## Multimodal selector-surface regret (test2.py equation, "
            "LatinMixed 10 + 8 iters x batch 5)",
            "",
            f"- CPU f64: median {np.median(eq_c):.4f}, IQR [{lo_c2:.4f}, "
            f"{hi_c2:.4f}] — seeds: {[round(float(v), 4) for v in sorted(eq_c)]}",
            f"- GPU f32: median {np.median(eq_t):.4f}, IQR [{lo_t2:.4f}, "
            f"{hi_t2:.4f}] — seeds: {[round(float(v), 4) for v in sorted(eq_t)]}",
            f"- seed variance on CPU (discriminativeness): "
            f"{np.var(eq_c):.6f} (non-zero required)",
            f"- IQRs overlap: **{ov2}**",
        ]

    # Part C (surrogate accuracy, test2.py:116-258): per-level RMSE parity
    if raw["gpu"].get("surrogate_rmse") and raw["cpu"].get("surrogate_rmse"):
        rt = np.asarray([raw["gpu"]["surrogate_rmse"][k]
                         for k in sorted(raw["gpu"]["surrogate_rmse"])])
        rc = np.asarray([raw["cpu"]["surrogate_rmse"][k]
                         for k in sorted(raw["cpu"]["surrogate_rmse"])])
        mt, mc = rt.mean(axis=0), rc.mean(axis=0)
        lines += [
            "",
            "## Surrogate accuracy (test2.py compare_with_actual protocol: "
            "Hammersley 200, per-level RMSE over 1000-pt grids)",
            "",
            "| level | CPU f64 RMSE | GPU f32 RMSE |",
            "|---|---|---|",
        ] + [
            f"| {lvl + 1} | {mc[lvl]:.4f} | {mt[lvl]:.4f} |"
            for lvl in range(mc.shape[0])
        ] + [
            "",
            f"- max |GPU - CPU| per-level RMSE gap: {np.max(np.abs(mt - mc)):.4f}",
        ]
    lines += [""]
    return "\n".join(lines)


def main():
    fresh = "--fresh" in sys.argv
    only = None  # '--only cpu' / '--only gpu': run one backend
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1]
    raw = {}
    if RAW.exists() and not fresh:
        raw = json.loads(RAW.read_text())
    # cpu_f32 is an optional precision-sensitivity control (same pipeline on
    # host CPU at f32): isolates "f32 vs f64" from "GPU vs CPU".
    for name, cpu, x64 in (("cpu", True, True), ("gpu", False, True),
                           ("cpu_f32", True, False)):
        if (only and name != only) or (name == "cpu_f32" and only != "cpu_f32"):
            continue
        # part-wise caching: only the missing parts re-run (a backend that
        # already has Parts A/B from an earlier round pays only for A2/C)
        have = raw.get(name, {})
        missing = [p for p in ALL_PARTS
                   if (len(have.get(p, [])) < SEEDS if p != "surrogate_rmse"
                       else not have.get(p))]
        if not missing:
            print(f"# {name}: cached (all parts)")
            continue
        print(f"# running backend {name}: parts {missing} ...", flush=True)
        fresh_parts = run_backend(cpu, x64=x64, parts=missing)
        merged = dict(have)
        for p in missing:
            merged[p] = fresh_parts[p]
        raw[name] = merged
        RAW.write_text(json.dumps(raw))
    if only and ("cpu" not in raw or "gpu" not in raw):
        print(f"# backend {only} done; waiting for the other before reporting")
        return
    text = report(raw)
    md = RESULTS.read_text() if RESULTS.exists() else ""
    marker = "\n# Thesis workload parity"
    if marker in md:
        md = md[: md.index(marker)]
    RESULTS.write_text(md.rstrip("\n") + "\n" + text)
    print(text)


if __name__ == "__main__":
    main()
