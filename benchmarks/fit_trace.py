"""Profiler trace of the headline fit on a GPU, reduced to device time per scope.

    python benchmarks/fit_trace.py [--out DIR]

Traces one warm Fitter call (N=4096, D=6, ARD Matern52, 5 restarts x 30 L-BFGS
steps, the bench.py headline fit) and prints, over the trace window, the device
busy time and the device time of the kernels XLA emitted under each named scope:

- ``diag_chol``: diagonal-block Cholesky factorizations inside blocked_cholesky;
- ``diag_inv``: diagonal-block triangular inverses inside tri_inv_lower;
- ``k_build``: the stationary K build, split into forward and backward
  (the backward's op path reads ``transpose(jvp(k_build))``).

A kernel's op path comes from its ``name`` stat, or else from the compiled
module's metadata for the instruction its name or ``hlo_op`` stat gives, so a
fusion that spans scopes is attributed to the scope of its root op. Library
kernels (cuBLAS, cuSOLVER) that XLA launches inside a CUDA graph carry neither;
run with ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to launch them one by one
and attribute them too. The share of busy time with an op path is printed as
``attributed``. The trace stays in DIR (default chiprun_out/fit_trace).
"""
import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCOPES = ("diag_chol", "diag_inv", "k_build")


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]+)"', re.M)


def op_paths(hlo_text):
    """HLO instruction name -> the op path (jax name stack) in its metadata.
    Kernel names spell the instruction's dots as underscores; both are keys."""
    out = {}
    for m in _INSTR.finditer(hlo_text):
        out[m.group(1)] = out[m.group(1).replace(".", "_")] = m.group(2)
    return out


def reduce_trace(xplane_path, paths, top=15):
    """Device busy time, window and per-scope kernel time from one .xplane.pb;
    `paths` maps HLO instruction names to op paths (`op_paths`)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(str(xplane_path))
    out = {"planes": []}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        names = [ln.name for ln in lines]
        streams = [ln for ln in lines if ln.name.startswith("Stream")] or lines
        events = []
        for ln in streams:
            for ev in ln.events:
                stats = {k: str(v) for k, v in ev.stats}
                path = stats.get("name") or paths.get(
                    stats.get("hlo_op", ""), paths.get(ev.name, ""))
                text = ev.name + " " + path
                events.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                               ev.name, text))
        if not events:
            continue
        window = max(e for _, e, _, _ in events) - min(s for s, _, _, _ in events)
        busy = _union_ns([(s, e) for s, e, _, _ in events])
        attributed = sum(e - s for s, e, name, t in events if len(t) > len(name) + 1)
        scopes = {}
        for sc in SCOPES:
            hit = [(s, e, t) for s, e, _, t in events if sc in t]
            if sc == "k_build":
                bwd = [(s, e) for s, e, t in hit if "transpose(jvp(k_build" in t]
                fwd = [(s, e) for s, e, t in hit
                       if "transpose(jvp(k_build" not in t]
                scopes["k_build_fwd"] = sum(e - s for s, e in fwd)
                scopes["k_build_bwd"] = sum(e - s for s, e in bwd)
            else:
                scopes[sc] = sum(e - s for s, e, _ in hit)
        by_name = {}
        for s, e, name, _ in events:
            by_name[name] = by_name.get(name, 0) + (e - s)
        tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        sample = [t[:400] for _, _, _, t in events[:5]]
        out["planes"].append({
            "plane": plane.name, "lines": names, "n_events": len(events),
            "window_ns": window, "busy_ns": busy, "attributed_ns": attributed,
            "scopes_ns": scopes,
            "top_kernels_ns": tops, "sample_event_text": sample})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "fit_trace"))
    args = ap.parse_args()

    import jax

    from bench import FIT_RESTARTS, FIT_STEPS, _data, gpu_info
    from chip_smoke import headline_model
    from gaussian_process_optimization_tpu.models.fit import Fitter
    from gaussian_process_optimization_tpu.utils.compile_cache import (
        enable_compile_cache)

    device = gpu_info()
    enable_compile_cache()
    X, Y = _data()
    model = headline_model(X, Y)
    fitter = Fitter(model, num_restarts=FIT_RESTARTS, maxiter=FIT_STEPS, tol=0.0)
    key = jax.random.PRNGKey(1)
    # one executable for the warm run, the traced run and the op-path map
    compiled = jax.jit(fitter.__call__).lower(model, key).compile()
    jax.block_until_ready(compiled(model, key))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(model, key))
    untraced = time.perf_counter() - t0
    out = Path(args.out)
    jax.profiler.start_trace(str(out))
    try:
        jax.block_until_ready(compiled(model, key))
    finally:
        jax.profiler.stop_trace()
    xplane = sorted(out.glob("plugins/profile/*/*.xplane.pb"))[-1]
    res = reduce_trace(xplane, op_paths(compiled.as_text()))
    res["device"] = device
    res["fit_wall_s_untraced"] = untraced
    (out / "summary.json").write_text(json.dumps(res, indent=1))
    for p in res["planes"]:
        busy = p["busy_ns"]
        print(f"{p['plane']}: window {p['window_ns'] / 1e6:.3f} ms, busy "
              f"{busy / 1e6:.3f} ms ({100 * busy / p['window_ns']:.2f}%), "
              f"{p['n_events']} kernels on lines {p['lines']}")
        print(f"  attributed: {100 * p['attributed_ns'] / busy:.2f}% of busy")
        for sc, ns in p["scopes_ns"].items():
            print(f"  {sc}: {ns / 1e6:.3f} ms = {100 * ns / busy:.2f}% of busy")
        for name, ns in p["top_kernels_ns"]:
            print(f"  top {ns / 1e6:9.3f} ms  {name[:100]}")
        print("  sample:", p["sample_event_text"][:2])
    print(json.dumps({"device": device, "fit_wall_s_untraced": untraced}))


if __name__ == "__main__":
    main()
