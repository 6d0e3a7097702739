"""Model zoo — JAX rebuild of GPy models + GPyOpt surrogate wrappers."""
from .bo_models import BOModel, GPModel
from .gp import GPRegression, Posterior
from .sparse import SparseGPRegression, SparsePosterior
from .svgp import SVGP, fit_svgp
from .fit import Fitter
from . import fit  # noqa: F401  (the submodule, NOT shadowed by the fit() function)
from .mean_functions import (
    Additive,
    Compound,
    Constant,
    Identity,
    KernelMapping,
    LinearMapping,
    Mapping,
    MLPMapping,
    PiecewiseLinear,
)

__all__ = [
    "BOModel", "GPModel", "GPRegression", "Posterior", "SparseGPRegression",
    "SparsePosterior", "SVGP", "fit_svgp", "Fitter", "fit", "Additive", "Compound",
    "Constant", "Identity", "KernelMapping", "LinearMapping", "Mapping",
    "MLPMapping", "PiecewiseLinear",
]

# attach the m.plot() family (GPy plotting/__init__.py inject_plotting :41)
from ..utils.plotting_library import inject_plotting as _inject_plotting

_inject_plotting()
