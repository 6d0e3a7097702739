"""Multi-chip Bayesian optimization: the whole BO loop's device work — the
surrogate's multi-restart L-BFGS fits and both acquisition phases (candidate
sweep + anchor polish) — sharded over a jax.sharding.Mesh.

On a machine with several GPUs this is `make_mesh()` over the real cards
(`python chip_smoke.py --chips 4` runs the mesh path on four); without them it
runs on a virtual 8-device CPU mesh, so the SPMD program is exercised anywhere
(the same trick tests/conftest.py uses). The reference runs restarts and anchors as serial
Python loops (paramz optimize_restarts; GPyOpt acquisition_optimizer.py) — on a
mesh they are embarrassingly parallel, so the collective cost is one small
gather per phase.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

# Request 8 virtual CPU devices BEFORE any backend query — jax.default_backend()
# would initialize the backend and make this a silent no-op (1-device "mesh").
# Harmless on GPU machines: it only sizes the cpu backend.
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

import numpy as np

from gaussian_process_optimization_tpu.bo import (BayesianOptimization,
                                                  bounds_to_space, objectives)
from gaussian_process_optimization_tpu.parallel import sharded


def main(max_iter=10, seed=0):
    n_dev = min(8, jax.device_count())
    mesh = sharded.make_mesh(n_dev, ("data",))
    print(f"mesh: {n_dev} x {jax.devices()[0].platform} devices")
    bo = BayesianOptimization(
        f=lambda x: np.asarray(objectives.branin(x)),
        domain=bounds_to_space(objectives.branin.bounds),
        acquisition_type="EI",
        initial_design_numdata=5,
        initial_design_type="latin",
        exact_feval=True,
        seed=seed,
        mesh=mesh,                 # <- restart-parallel fits + sharded acquisition
        optimize_restarts=n_dev,   # one restart chain per device
    )
    bo.run_optimization(max_iter=max_iter, eps=-1)
    print(f"best f = {bo.fx_opt:.5f} (true fmin = {objectives.branin.fmin}) "
          f"at x = {bo.x_opt}")
    return bo


if __name__ == "__main__":
    main()
