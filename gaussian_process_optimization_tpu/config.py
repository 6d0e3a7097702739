"""Global runtime configuration.

The reference stack (GPy) uses an INI cascade (``GPy/GPy/util/config.py:17-29``) to toggle
cython/openmp/plotting. Here the analogous switches are numeric floors, the gradient-path
matmul precision, and the jitter ladder shape (``GPy/GPy/util/linalg.py:56-74``).
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # Additive noise floor on the Gaussian-likelihood variance, matching
    # GPy exact_gaussian_inference.py:52 (`Ky += (sigma2 + 1e-8) I`).
    noise_jitter: float = 1e-8
    # jitchol ladder: first jitter = mean(diag)*base, then *10 each try, `maxtries` tries.
    jitchol_base: float = 1e-6
    jitchol_maxtries: int = 5
    # Predictive-variance floor (GPyOpt gpmodel.py:99 clips at 1e-10 before sqrt).
    variance_floor: float = 1e-10
    # float32 minimum effective noise on the Gram diagonal. The reference runs
    # float64 LAPACK where exact_feval's 1e-6 noise is fine; in float32 that is
    # below Cholesky's resolution once the kernel variance grows, and the fit dies
    # with an unrecoverable non-PD matrix. Applied ONLY when the compute dtype is
    # float32 (f64 parity paths are unaffected).
    f32_noise_floor: float = 1e-4
    # Acquisition std floor (GPyOpt util/general.py:121 floors s at 1e-10).
    std_floor: float = 1e-10
    # Matmul precision for the exact-GP GRADIENT path only (the Wi = Li^T Li /
    # alpha alpha^T contractions in _exact_core_bwd and the tri_inv merge
    # matmuls feeding them). 'highest' (IEEE float32) by default, like the
    # global pin in __init__.py. On a GPU 'high' means TF32 operands (a 10-bit
    # mantissa); whether that is regret-neutral for the gradient path has not
    # been measured, so it stays opt-in via GPO_GRAD_MATMUL_PRECISION=high.
    grad_matmul_precision: str = os.environ.get(
        "GPO_GRAD_MATMUL_PRECISION", "highest")
    # Line-search warm-start growth after a BACKTRACKED accept (ops/lbfgs.py
    # `grow_backtracked`; Fitter reads this as its default). 1.0 = HOLD
    # (re-probe the accepted step) kills the grow->fail->re-backtrack
    # oscillation on structured LML surfaces (~6% fewer trials, max-over-lanes
    # 48->43 at N=1024 f32) — but the regret gate FAILED: hartmann6 median
    # +9%, alpine1 upper quartile 4x (benchmarks/ls_policy_ab.json, 10 seeds
    # x 3 functions CPU f64). Same verdict as nonmonotone_eta: speed knobs
    # that move regret stay OPT-IN; default 2.0.
    ls_grow_backtracked: float = float(os.environ.get(
        "GPO_LS_GROW_BACKTRACKED", "2.0"))


config = Config()
