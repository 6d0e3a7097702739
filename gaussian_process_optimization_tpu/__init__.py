"""gaussian_process_optimization_tpu — a Gaussian-process / Bayesian-optimization
framework on JAX / XLA (jit, vmap, shard_map).

Brand-new rebuild of the capabilities of the GPy 1.9.6 + GPyOpt 1.2.5 stack vendored in
the reference project (see SURVEY.md): exact and sparse GP regression, the stationary
kernel family (+ Gower mixed-variable kernel), multi-restart L-BFGS hyperparameter
fitting, and the full BO loop (EI/MPI/LCB, local penalization, mixed design spaces,
experiment designs, ask-tell).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# GP numerics are cancellation-heavy (distance trick, collapsed bounds, LML terms).
# On an NVIDIA GPU, XLA's default float32 matmul precision lets cuBLAS run TF32
# tensor-core products (10-bit mantissa, ~3 decimal digits), which corrupts Gram
# matrices badly enough to make them non-PSD. A GP library must default to
# full-precision matmuls, so 'highest' (IEEE float32) is pinned here.
# GPO_MATMUL_PRECISION overrides it (e.g. 'high' for TF32) for experiments.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("GPO_MATMUL_PRECISION", "highest"),
)

from . import config as _config  # noqa: F401
from .config import config  # noqa: F401


def __getattr__(name):
    # lazy top-level conveniences: gpo.GPRegression, gpo.BayesianOptimization, ...
    if name in ("GPRegression", "SparseGPRegression", "SVGP", "Fitter"):
        from . import models

        return getattr(models, name)
    if name in ("BayesianOptimization", "ModularBayesianOptimization", "DesignSpace",
                "bounds_to_space", "initial_design"):
        from . import bo

        return getattr(bo, name)
    if name == "kernels":
        from . import kernels

        return kernels
    raise AttributeError(name)
