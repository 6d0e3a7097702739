"""A/B: line-search warm-start growth after a backtracked accept
(config.ls_grow_backtracked 2.0 vs 1.0 — the HOLD policy), on CPU float64.

Gate for flipping the Fitter default (speed knobs that can move regret need a
regret validation before becoming default).
The knob only affects the FIT line search, so CPU f64 regret captures its
effect; functions = the regret-sensitive subset of the parity suite.

Writes benchmarks/ls_policy_ab.json. Run: python benchmarks/ls_policy_ab.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FUNC_SPECS = {"branin": 20, "alpine1": 25, "hartmann6": 30}
SEEDS = 10

CHILD = r"""
import sys, json, os
sys.path.insert(0, {root!r})
import jax
from gaussian_process_optimization_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from gaussian_process_optimization_tpu.config import config
config.ls_grow_backtracked = {grow}
from gaussian_process_optimization_tpu.bo import BayesianOptimization, bounds_to_space
from gaussian_process_optimization_tpu.bo import objectives
specs = {specs!r}
out = {{}}
for func_name, iters in specs.items():
    func = getattr(objectives, func_name)
    bounds = [(-10.0, 10.0)] * 2 if func_name == "alpine1" else func.bounds
    fmin = float(func.fmin)
    finals = []
    for seed in range({seeds}):
        bo = BayesianOptimization(
            f=lambda x: np.asarray(func(x)), domain=bounds_to_space(bounds),
            acquisition_type="EI", initial_design_numdata=5,
            initial_design_type="latin", exact_feval=True, seed=seed)
        bo.run_optimization(max_iter=iters, eps=-1)
        finals.append(float(np.min(bo.Y[:, 0]) - fmin))
        print("# {{}} grow={grow} seed {{}}: regret {{:.4f}}".format(
            func_name, seed, finals[-1]), flush=True)
    out[func_name] = finals
print("RESULT::" + json.dumps(out))
"""


def main():
    import numpy as np

    results = {}
    for grow in (2.0, 1.0):
        code = CHILD.format(root=str(ROOT), grow=grow, specs=dict(FUNC_SPECS),
                            seeds=SEEDS)
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=14400)
        for line in res.stdout.splitlines():
            if line.startswith("RESULT::"):
                results[str(grow)] = json.loads(line[len("RESULT::"):])
                break
        else:
            raise RuntimeError(
                f"child grow={grow} failed:\n{res.stdout[-2000:]}\n"
                f"{res.stderr[-2000:]}")
        print(f"grow={grow} done", flush=True)

    summary = {}
    for fn in FUNC_SPECS:
        a = np.asarray(results["2.0"][fn])
        b = np.asarray(results["1.0"][fn])
        summary[fn] = {
            "grow2_median": float(np.median(a)),
            "grow2_iqr": [float(np.percentile(a, 25)), float(np.percentile(a, 75))],
            "hold_median": float(np.median(b)),
            "hold_iqr": [float(np.percentile(b, 25)), float(np.percentile(b, 75))],
        }
        print(fn, summary[fn], flush=True)
    out = {"seeds": SEEDS, "finals": results, "summary": summary}
    (ROOT / "benchmarks" / "ls_policy_ab.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
