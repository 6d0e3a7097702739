"""Regret-parity benchmark: the SAME BO configuration run on the GPU (f32, the
production path) and on CPU float64 (the reference-numerics proxy — identical math
to GPy/GPyOpt's LAPACK f64), across seeds. Writes benchmarks/RESULTS.md and a
regret-curve plot: the evidence for BASELINE.json's "matching regret curves".

Statistical protocol: >= 10 seeds per function on BOTH backends, same configs;
report median + IQR; parity = overlapping IQRs.

The function set mirrors the reference's own experiment modules
(`GPyOpt/GPyOpt/objective_examples/experiments{1d,2d,Nd}.py`: forrester, branin,
sixhumpcamel, alpine1, ackley) plus Hartmann6 (BASELINE.json's config-2 function).

Runs each backend in its own child process, one after another (the platform is
fixed at jax init, and one JAX process holds the card; the parent never imports
jax). The persistent XLA compile cache (utils/compile_cache.py) makes repeat
seeds cheap. Results merge incrementally into regret_raw.json:
functions already present with the same seed count are not re-run (delete the
entry or pass --fresh to force).
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RAW = ROOT / "benchmarks" / "regret_raw.json"

# name -> (iters, explicit bounds or None to use func.bounds)
FUNC_SPECS = {
    "forrester": (20, None),
    "branin": (20, None),
    "sixhumpcamel": (25, None),
    "alpine1": (25, [(-10.0, 10.0)] * 2),
    "ackley": (25, [(-32.768, 32.768)] * 2),
    "hartmann6": (30, None),
}

CHILD = r"""
import sys, json
sys.path.insert(0, {root!r})
import jax
from gaussian_process_optimization_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
if {cpu}:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
import numpy as np
from gaussian_process_optimization_tpu.bo import BayesianOptimization, bounds_to_space
from gaussian_process_optimization_tpu.bo import objectives

specs = {specs!r}
out = {{}}
for func_name, (iters, bounds) in specs.items():
    func = getattr(objectives, func_name)
    if bounds is None:
        bounds = func.bounds
    # N-D reference functions have fmin at a known point but no per-d bound attr
    fmin = float(func.fmin)
    curves = []
    for seed in range({seeds}):
        bo = BayesianOptimization(
            f=lambda x: np.asarray(func(x)),
            domain=bounds_to_space(bounds),
            acquisition_type="EI", initial_design_numdata=5,
            initial_design_type="latin", exact_feval=True, seed=seed)
        bo.run_optimization(max_iter=iters, eps=-1)
        best = np.minimum.accumulate(bo.Y[:, 0]) - fmin
        curves.append(best.tolist())
        print("# {{}} seed {{}}: final regret {{:.4f}}".format(
            func_name, seed, best[-1]), flush=True)
    out[func_name] = curves
print("RESULT::" + json.dumps(out))
"""


def run_backend(cpu, specs, seeds):
    code = CHILD.format(root=str(ROOT), cpu=cpu, specs=dict(specs), seeds=seeds)
    res = subprocess.run([sys.executable, "-c", code], capture_ougput=True, text=True,
                         timeout=14400)
    for line in res.stdout.splitlines():
        if line.startswith("RESULT::"):
            return json.loads(line[len("RESULT::"):])
    raise RuntimeError(f"child failed:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")


def main(funcs=tuple(FUNC_SPECS), seeds=10, fresh=False):
    import numpy as np

    prior = {"cpu_f64": {}, "gpu_f32": {}, "iters": {}}
    if RAW.exists() and not fresh:
        prior = json.loads(RAW.read_text())
        prior.setdefault("iters", {})

    def have(fn):
        return (fn in prior["cpu_f64"] and fn in prior["gpu_f32"]
                and len(prior["cpu_f64"][fn]) >= seeds)

    todo = {fn: FUNC_SPECS[fn] for fn in funcs if not have(fn)}
    cpu = {fn: prior["cpu_f64"][fn] for fn in funcs if have(fn)}
    gpu = {fn: prior["gpu_f32"][fn] for fn in funcs if have(fn)}
    if todo:
        print(f"running CPU f64 for {list(todo)} (reference-numerics proxy)...",
              flush=True)
        cpu.update(run_backend(True, todo, seeds))
        print(f"running GPU f32 for {list(todo)}...", flush=True)
        gpu.update(run_backend(False, todo, seeds))
    else:
        print("all functions already present in regret_raw.json", flush=True)

    iters = {fn: FUNC_SPECS[fn][0] for fn in funcs}

    def stats(v):
        v = np.asarray(v)
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        return med, q1, q3

    lines = [
        "# Regret parity: GPU f32 vs CPU f64 (same code, same config)\n",
        f"EI, latin init 5, {seeds} seeds, exact_feval. Iterations per function: "
        f"{iters}. Function set = the reference's own experiment modules "
        "(experiments1d/2d/Nd.py) + Hartmann6. Parity criterion: overlapping "
        "inter-quartile ranges of final simple regret.\n",
    ]
    all_overlap = True
    for fn in funcs:
        c = np.asarray([row[-1] for row in cpu[fn]])
        t = np.asarray([row[-1] for row in gpu[fn]])
        cm, c1, c3 = stats(c)
        tm, t1, t3 = stats(t)
        # 1e-6 resolution tolerance: on solved functions every seed's regret
        # is ~0 and f32 rounding can make it -1e-7, which would fail an exact
        # IQR-overlap check on ties
        tol = 1e-6
        overlap = (t1 <= c3 + tol) and (c1 <= t3 + tol)
        all_overlap &= overlap
        lines.append(f"## {fn}\n")
        lines.append(f"- CPU f64 final regret: median {cm:.4f}, IQR [{c1:.4f}, {c3:.4f}]"
                     f" — seeds: {np.round(np.sort(c), 4).tolist()}")
        lines.append(f"- GPU f32 final regret: median {tm:.4f}, IQR [{t1:.4f}, {t3:.4f}]"
                     f" — seeds: {np.round(np.sort(t), 4).tolist()}")
        lines.append(f"- IQRs overlap: **{overlap}**\n")
    lines.append(f"\nAll functions IQR-overlap: **{all_overlap}**\n")
    md = "\n".join(lines)
    (ROOT / "benchmarks" / "RESULTS.md").write_text(md)
    RAW.write_text(
        json.dumps({"cpu_f64": cpu, "gpu_f32": gpu, "seeds": seeds, "iters": iters})
    )
    print(md)

    # plot
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(funcs)
    ncol = min(n, 3)
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(6 * ncol, 4.5 * nrow))
    axes = np.atleast_1d(axes).ravel()
    for ax, fn in zip(axes, funcs):
        for label, data, color in [("CPU f64", cpu[fn], "C0"), ("GPU f32", gpu[fn], "C1")]:
            for i, row in enumerate(data):
                ax.semilogy(np.maximum(row, 1e-6), color=color, alpha=0.45,
                            label=label if i == 0 else None)
        ax.set_title(fn)
        ax.set_xlabel("evaluation")
        ax.set_ylabel("simple regret")
        ax.legend()
    for ax in axes[n:]:
        ax.axis("off")
    fig.savefig(ROOT / "benchmarks" / "regret_curves.png", bbox_inches="tight")
    print("wrote benchmarks/RESULTS.md, regret_raw.json, regret_curves.png")


if __name__ == "__main__":
    main(fresh="--fresh" in sys.argv)
