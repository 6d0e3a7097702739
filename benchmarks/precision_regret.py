"""Regret validation for the gradient-path matmul precision knob.

Runs the GPU f32 side of benchmarks/regret_compare.py with
GPO_GRAD_MATMUL_PRECISION=high (TF32 operands for the exact-GP backward
contractions only — see config.grad_matmul_precision) and compares final-regret
IQRs against BOTH the stored CPU f64 reference curves and the stored
default-precision GPU curves in benchmarks/regret_raw.json (run
regret_compare.py first). Writes benchmarks/PRECISION.md.

Decision rule: adopt 'high' as the default only if every function's IQR overlaps
the CPU f64 IQR (the same parity criterion the main benchmark uses). The CPU f64
side is reusable as-is: CPU f64 LAPACK math is identical under either setting.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmarks"))

from regret_compare import CHILD, FUNC_SPECS, RAW  # noqa: E402


def main(seeds=10, reuse=False):
    prior = json.loads(RAW.read_text())
    funcs = [fn for fn in FUNC_SPECS if fn in prior["cpu_f64"]]
    stored = ROOT / "benchmarks" / "precision_raw.json"
    if reuse and stored.exists():
        out = json.loads(stored.read_text())
    else:
        specs = {fn: FUNC_SPECS[fn] for fn in funcs}
        code = CHILD.format(root=str(ROOT), cpu=False, specs=specs, seeds=seeds)
        env = dict(os.environ, GPO_GRAD_MATMUL_PRECISION="high")
        print(f"running GPU f32 GRAD=high for {funcs}...", flush=True)
        res = subprocess.run([sys.executable, "-c", code], capture_ougput=True,
                             text=True, timeout=14400, env=env)
        out = None
        for line in res.stdout.splitlines():
            if line.startswith("RESULT::"):
                out = json.loads(line[len("RESULT::"):])
        if out is None:
            raise RuntimeError(
                f"child failed:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")

    import numpy as np

    def stats(v):
        v = np.asarray(v)
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        return med, q1, q3

    lines = [
        "# Gradient-path precision (TF32) regret validation\n",
        f"GPU f32 with GPO_GRAD_MATMUL_PRECISION=high, {seeds} seeds, same EI "
        "config as RESULTS.md. Criterion: IQR overlap with CPU f64.\n",
    ]
    all_overlap = True
    for fn in funcs:
        c = np.asarray([row[-1] for row in prior["cpu_f64"][fn]])
        t0 = np.asarray([row[-1] for row in prior["gpu_f32"][fn]])
        th = np.asarray([row[-1] for row in out[fn]])
        cm, c1, c3 = stats(c)
        hm, h1, h3 = stats(th)
        dm, d1, d3 = stats(t0)
        tol = 1e-6  # resolution tolerance for all-seeds-solved ties (see regret_compare)
        overlap = (h1 <= c3 + tol) and (c1 <= h3 + tol)
        all_overlap &= overlap
        lines.append(f"## {fn}\n")
        lines.append(f"- CPU f64:              median {cm:.4f}, IQR [{c1:.4f}, {c3:.4f}]")
        lines.append(f"- GPU f32 grad=highest: median {dm:.4f}, IQR [{d1:.4f}, {d3:.4f}]")
        lines.append(f"- GPU f32 grad=high:    median {hm:.4f}, IQR [{h1:.4f}, {h3:.4f}]"
                     f" — seeds: {np.round(np.sort(th), 4).tolist()}")
        lines.append(f"- IQR overlap vs CPU: **{overlap}**\n")
    verdict = ("PASS: gradient-path TF32 is regret-neutral across the suite"
               if all_overlap else
               "FAIL: keep 'highest' as the default")
    lines.append(f"\n**{verdict}**\n")
    md = "\n".join(lines)
    (ROOT / "benchmarks" / "PRECISION.md").write_text(md)
    (ROOT / "benchmarks" / "precision_raw.json").write_text(json.dumps(out))
    print(md)


if __name__ == "__main__":
    main(reuse="--reuse" in sys.argv)
