"""Hyperparameter priors (GPy/GPy/core/parameterization/priors.py: Gaussian:40,
Uniform:94, LogGaussian, Gamma:264 with from_EV, InverseGamma, Exponential, StudentT,
HalfT, MultivariateGaussian:188, and the discriminative-GPLVM family
DGPLVM_KFDA:388 / DGPLVM:535 / DGPLVM_Lamda:749 / DGPLVM_T:994). Priors contribute
log-density on *constrained* parameter values; the fit objective is
-logL - logPrior (GPy core/model.py:101-127), with gradients by autodiff (the
reference's hand-written ``lnpdf_grad`` methods are replaced by ``jax.grad``
through the whole density — the tests keep numpy twins of those hand gradients
as the consistency oracle).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .pytree import pytree_dataclass, static_field


@pytree_dataclass
class Prior:
    def lnpdf(self, x):
        raise NotImplementedError


@pytree_dataclass
class GaussianPrior(Prior):
    mu: jnp.ndarray = 0.0
    sigma: jnp.ndarray = 1.0

    def lnpdf(self, x):
        s2 = jnp.square(self.sigma)
        return -0.5 * (jnp.log(2 * jnp.pi * s2) + jnp.square(x - self.mu) / s2)


@pytree_dataclass
class UniformPrior(Prior):
    lower: jnp.ndarray = 0.0
    upper: jnp.ndarray = 1.0

    def lnpdf(self, x):
        inside = jnp.logical_and(x >= self.lower, x <= self.upper)
        return jnp.where(inside, -jnp.log(self.upper - self.lower), -jnp.inf)


@pytree_dataclass
class LogGaussianPrior(Prior):
    mu: jnp.ndarray = 0.0
    sigma: jnp.ndarray = 1.0

    def lnpdf(self, x):
        s2 = jnp.square(self.sigma)
        lx = jnp.log(x)
        return -lx - 0.5 * (jnp.log(2 * jnp.pi * s2) + jnp.square(lx - self.mu) / s2)


@pytree_dataclass
class GammaPrior(Prior):
    """Shape/rate parameterization, matching GPy (priors.py:264)."""

    a: jnp.ndarray = 1.0
    b: jnp.ndarray = 1.0  # rate

    @classmethod
    def from_EV(cls, E, V):
        """Construct from expectation and variance (GPy Gamma.from_EV)."""
        a = jnp.square(E) / V
        b = E / V
        return cls(a=a, b=b)

    def lnpdf(self, x):
        return (
            self.a * jnp.log(self.b)
            - gammaln(self.a)
            + (self.a - 1.0) * jnp.log(x)
            - self.b * x
        )


@pytree_dataclass
class InverseGammaPrior(Prior):
    a: jnp.ndarray = 1.0
    b: jnp.ndarray = 1.0

    def lnpdf(self, x):
        return (
            self.a * jnp.log(self.b)
            - gammaln(self.a)
            - (self.a + 1.0) * jnp.log(x)
            - self.b / x
        )


@pytree_dataclass
class ExponentialPrior(Prior):
    l: jnp.ndarray = 1.0

    def lnpdf(self, x):
        return jnp.log(self.l) - self.l * x


@pytree_dataclass
class StudentTPrior(Prior):
    mu: jnp.ndarray = 0.0
    sigma: jnp.ndarray = 1.0
    nu: jnp.ndarray = 4.0

    def lnpdf(self, x):
        z = (x - self.mu) / self.sigma
        return (
            gammaln((self.nu + 1) / 2)
            - gammaln(self.nu / 2)
            - 0.5 * jnp.log(self.nu * jnp.pi)
            - jnp.log(self.sigma)
            - (self.nu + 1) / 2 * jnp.log1p(jnp.square(z) / self.nu)
        )


@pytree_dataclass
class HalfTPrior(Prior):
    A: jnp.ndarray = 1.0
    nu: jnp.ndarray = 4.0

    def lnpdf(self, x):
        t = StudentTPrior(mu=0.0, sigma=self.A, nu=self.nu)
        return jnp.where(x >= 0, jnp.log(2.0) + t.lnpdf(x), -jnp.inf)


@pytree_dataclass
class MultivariateGaussianPrior(Prior):
    """Multivariate normal over rows of x (priors.py:188 MultivariateGaussian).

    The reference precomputes ``pdinv(var)`` at construction; here the factor is
    computed inside ``lnpdf`` (d is small, and keeping only array leaves makes
    the prior jit/vmap/grad-transparent).
    """

    mu: jnp.ndarray = 0.0
    var: jnp.ndarray = 1.0  # (d, d) covariance

    def lnpdf(self, x):
        mu = jnp.atleast_1d(jnp.asarray(self.mu, dtype=jnp.result_type(x, float)))
        var = jnp.asarray(self.var, dtype=mu.dtype)
        d = mu.shape[0]
        x2 = jnp.reshape(jnp.asarray(x), (-1, d))
        L = jnp.linalg.cholesky(var)
        dev = x2 - mu[None, :]
        # solve L z = dev^T  ->  quadratic form = sum z^2 per row
        z = jax.scipy.linalg.solve_triangular(L, dev.T, lower=True)
        hld = jnp.sum(jnp.log(jnp.diagonal(L)))
        const = -0.5 * d * jnp.log(2 * jnp.pi) - hld
        return const - 0.5 * jnp.sum(jnp.square(z), axis=0)


def _class_scatter(x, lbl):
    """Vectorized between/within class scatter (the loops of priors.py:566-631
    as one-hot contractions — matmul-friendly; empty classes contribute zero).

    Returns (Sb, Sw) with the reference's N-normalized weighting:
    Sb = sum_i (N_i/N) (M_i-M_0)(M_i-M_0)^T, Sw = (1/N) sum_j (x_j-M_c(j))(.)^T.
    """
    lbl = jnp.asarray(lbl, dtype=x.dtype)
    n = x.shape[0]
    counts = jnp.sum(lbl, axis=0)  # (C,)
    safe = jnp.maximum(counts, 1.0)
    M_i = (lbl.T @ x) / safe[:, None]  # (C, d) class means
    M_0 = jnp.mean(x, axis=0)
    B = M_i - M_0[None, :]
    Sb = jnp.einsum("c,ci,cj->ij", counts / n, B, B)
    W = x - lbl @ M_i  # per-point deviation from own class mean
    Sw = (W.T @ W) / n
    return Sb, Sw


@pytree_dataclass
class DGPLVMPrior(Prior):
    """Discriminative GPLVM prior over latent X (priors.py:535 DGPLVM, the
    'DGPLVM for Classification' / Urtasun & Darrell LDA criterion):
    lnpdf(X) = -(1/sigma2) * tr((Sb + ridge*I)^{-1} Sw).

    ``lbl`` is the (N, C) one-hot label matrix; ``ridge`` is the reference's
    hard-coded 0.1 stabilizer (priors.py:695). Gradients come from autodiff
    (replacing lnpdf_grad's hand chain, priors.py:699-727).
    """

    lbl: jnp.ndarray = None
    sigma2: jnp.ndarray = 1.0
    ridge: float = static_field(default=0.1)

    def lnpdf(self, x):
        lbl = jnp.asarray(self.lbl)
        x2 = jnp.reshape(jnp.asarray(x), (lbl.shape[0], -1))
        Sb, Sw = _class_scatter(x2, lbl)
        A = Sb + self.ridge * jnp.eye(Sb.shape[0], dtype=x2.dtype)
        return (-1.0 / self.sigma2) * jnp.trace(
            jnp.linalg.solve(A, Sw))


@pytree_dataclass
class DGPLVMLamdaPrior(Prior):
    """DGPLVM with a learnable per-dimension scaling (priors.py:749
    DGPLVM_Lamda): X' = X @ diag(lamda), ridge 0.9 (priors.py:927). In the
    reference ``lamda`` is a linked Param with a hand gradient
    (priors.py:973); here it is an ordinary array leaf of this pytree, so
    d/d(lamda) falls out of autodiff with everything else."""

    lbl: jnp.ndarray = None
    lamda: jnp.ndarray = None  # (d,) per-latent-dimension scale
    sigma2: jnp.ndarray = 1.0
    ridge: float = static_field(default=0.9)

    def lnpdf(self, x):
        lbl = jnp.asarray(self.lbl)
        x2 = jnp.reshape(jnp.asarray(x), (lbl.shape[0], -1))
        x2 = x2 * jnp.asarray(self.lamda)[None, :]
        return DGPLVMPrior(lbl=lbl, sigma2=self.sigma2,
                           ridge=self.ridge).lnpdf(x2)


@pytree_dataclass
class DGPLVMTPrior(Prior):
    """DGPLVM on a fixed linear projection of the latents (priors.py:994
    DGPLVM_T): X' = X @ vec, ridge 0.1 (priors.py:1168)."""

    lbl: jnp.ndarray = None
    vec: jnp.ndarray = None  # (d, d') projection
    sigma2: jnp.ndarray = 1.0
    ridge: float = static_field(default=0.1)

    def lnpdf(self, x):
        lbl = jnp.asarray(self.lbl)
        x2 = jnp.reshape(jnp.asarray(x), (lbl.shape[0], -1))
        x2 = x2 @ jnp.asarray(self.vec)
        return DGPLVMPrior(lbl=lbl, sigma2=self.sigma2,
                           ridge=self.ridge).lnpdf(x2)


@pytree_dataclass
class DGPLVMKFDAPrior(Prior):
    """Kernel-Fisher-discriminant DGPLVM prior (priors.py:388 DGPLVM_KFDA,
    two classes): with K = kern.K(X), A the blockwise centering operator and
    a the signed class-indicator vector,

        J* = (1/lambda) * (a^T K a - a^T K A (lambda I + A K A)^{-1} A K a)
        lnpdf(X) = -(1/sigma2) * J*

    The reference builds ``a``/``A`` positionally assuming class-0 rows come
    first (priors.py:466-486); here both are built from the label matrix
    directly (indicator form A = sum_i (1/sqrt(N_i))(diag(m_i) -
    m_i m_i^T / N_i)), which coincides with the reference on class-sorted
    data and is order-invariant otherwise. Binary only, like the reference
    (it deletes classes >= 2, priors.py:441-443).
    """

    lbl: jnp.ndarray = None  # (N, 2) one-hot
    kern: object = None  # any kernel pytree with .K(X)
    lambdaa: jnp.ndarray = 1e-4
    sigma2: jnp.ndarray = 1.0

    def _aA(self, dtype):
        lbl = jnp.asarray(self.lbl, dtype=dtype)[:, :2]
        n = lbl.shape[0]
        counts = jnp.maximum(jnp.sum(lbl, axis=0), 1.0)  # (2,)
        a = lbl[:, 0] / counts[0] - lbl[:, 1] / counts[1]  # (N,)
        A = jnp.zeros((n, n), dtype=dtype)
        for i in range(2):
            m = lbl[:, i]
            A = A + (jnp.diag(m) - jnp.outer(m, m) / counts[i]) / jnp.sqrt(
                counts[i])
        return a, A

    def lnpdf(self, x):
        lbl = jnp.asarray(self.lbl)
        x2 = jnp.reshape(jnp.asarray(x), (lbl.shape[0], -1))
        K = self.kern.K(x2)
        a, A = self._aA(K.dtype)
        AKa = A @ (K @ a)
        P = self.lambdaa * jnp.eye(K.shape[0], dtype=K.dtype) + A @ K @ A
        J = a @ (K @ a) - AKa @ jnp.linalg.solve(P, AKa)
        return (-1.0 / self.sigma2) * (J / self.lambdaa)


def log_prior(priors, params) -> jnp.ndarray:
    """Sum of prior log-densities. `priors` mirrors the FULL structure of
    `params` leaf-for-leaf: leaves that are Prior instances are applied to the
    corresponding parameter leaf; None leaves contribute 0 (use None to skip a
    parameter, including slots where params itself holds None)."""
    import jax

    if priors is None:
        return jnp.asarray(0.0)
    total = 0.0
    # None IS a valid leaf on BOTH sides: priors uses it as "no prior here",
    # and params trees may hold None slots (e.g. mask=None on a model).
    # Flattening params WITHOUT is_leaf would drop its None nodes while the
    # priors side counts the mirroring None — a spurious count mismatch on
    # exactly the documented usage.
    flat_priors = jax.tree_util.tree_leaves(
        priors, is_leaf=lambda x: x is None or isinstance(x, Prior)
    )
    flat_params = jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: x is None
    )
    if len(flat_priors) != len(flat_params):
        raise ValueError(
            f"priors tree must mirror the params tree leaf-for-leaf "
            f"({len(flat_priors)} vs {len(flat_params)} leaves — use None "
            f"for unpriored slots)")
    for pr, v in zip(flat_priors, flat_params):
        if isinstance(pr, Prior):
            if v is None:
                raise ValueError("a Prior was placed on a None parameter slot")
            total = total + jnp.sum(pr.lnpdf(jnp.asarray(v)))
    return jnp.asarray(total)
