"""Kernel (covariance function) zoo — JAX rebuild of GPy/GPy/kern."""
from .base import Add, Kernel, Prod
from .gower import Gower
from .linear import Linear, LinearFull
from .other import MLP, Brownian, Coregionalize, Poly, Spline, StandardPeriodic
from .integral import Integral, IntegralLimits, MultidimensionalIntegralLimits
from .lfm import EQ_ODE1, EQ_ODE2
from .misc import (
    BasisFuncKernel,
    ChangePointBasisFuncKernel,
    DomainKernel,
    Hierarchical,
    IndependentOutputs,
    LinearSlopeBasisFuncKernel,
    LogisticBasisFuncKernel,
    PolynomialBasisFuncKernel,
    Symmetric,
    TruncLinear,
    TruncLinear_inf,
    TruncLinearInf,
)
from .periodic_rkhs import PeriodicExponential, PeriodicMatern32, PeriodicMatern52
from .ode import ODE_UY, ODE_UYC, ODE_st, ODE_t
from .symbolic import SymbolicKernel
from .split import DEtime, MultioutputKern, SplitKern
from .static import Bias, Fixed, White, WhiteHeteroscedastic
from .stationary import (
    OU,
    RBF,
    Cosine,
    Exponential,
    ExpQuad,
    Matern32,
    Matern52,
    RatQuad,
    Sinc,
    Stationary,
    safe_sqrt,
    sq_dist,
)

__all__ = [
    "Add", "Kernel", "Prod", "Gower", "Linear", "MLP", "Brownian", "Coregionalize",
    "Poly", "Spline", "StandardPeriodic", "Bias", "Fixed", "White",
    "WhiteHeteroscedastic", "OU", "RBF", "Cosine",
    "Exponential", "ExpQuad", "Matern32", "Matern52", "RatQuad", "Sinc", "Stationary",
    "safe_sqrt", "sq_dist", "Integral", "PeriodicExponential", "PeriodicMatern32",
    "PeriodicMatern52", "GridRBF", "SplitKern", "DEtime", "MultioutputKern",
    "EQ_ODE1", "EQ_ODE2", "TruncLinear", "TruncLinearInf", "TruncLinear_inf",
    "LinearFull", "Hierarchical", "Symmetric", "BasisFuncKernel",
    "PolynomialBasisFuncKernel", "LinearSlopeBasisFuncKernel",
    "ChangePointBasisFuncKernel", "DomainKernel", "LogisticBasisFuncKernel",
    "IndependentOutputs", "IntegralLimits", "MultidimensionalIntegralLimits",
    "ODE_UY", "ODE_UYC", "ODE_t", "ODE_st", "SymbolicKernel",
]


from ..utils.pytree import pytree_dataclass as _pytree_dataclass


@_pytree_dataclass
class GridRBF(RBF):
    """RBF for Kronecker/grid inference (GPy kern/src/grid_kerns.py GridRBF).

    The reference subclass only adds hand-coded per-factor derivative helpers
    (dKd_dVar/dKd_dLen, grid_kerns.py:17-44) consumed by gaussian_grid_inference;
    here models/gp_grid.py differentiates through the per-axis K builds by
    autodiff, so the grid kernel IS the plain RBF — the alias records the parity
    point (a deliberate design collapse, like diag-utils into linalg).
    """
