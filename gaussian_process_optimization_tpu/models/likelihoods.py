"""Likelihoods (GPy/GPy/likelihoods/: gaussian.py:22, bernoulli, poisson, student_t —
14 files, SURVEY §2.1 'Likelihoods'). Gaussian is the only one on the BO path; the
non-Gaussian ones pair with Laplace inference (models/laplace.py) for classification
and robust regression.

Each likelihood provides log p(y|f) and its first two derivatives in f (analytic —
used by the Newton mode-finding), and Gauss-Hermite predictive marginals (the
reference's quadrature fallback, likelihoods/likelihood.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import erfc, gammaln

from ..utils.pytree import pytree_dataclass


def _norm_logcdf(z):
    return jax.scipy.stats.norm.logcdf(z)


@pytree_dataclass
class Likelihood:
    def logpdf(self, f, y):
        raise NotImplementedError

    def dlogpdf_df(self, f, y):
        return jax.grad(lambda ff: jnp.sum(self.logpdf(ff, y)))(f)

    def d2logpdf_df2(self, f, y):
        # diagonal Hessian: likelihoods factorize over points, so
        # d/df_i sum_j dlogpdf_j == d2logpdf_i
        return jax.grad(lambda ff: jnp.sum(self.dlogpdf_df(ff, y)))(f)

    def predictive(self, mu, var, gh_points=20):
        """E[y*], V[y*] by Gauss-Hermite over the latent marginal."""
        gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
        gh_x = jnp.asarray(gh_x)
        gh_w = jnp.asarray(gh_w) / jnp.sqrt(jnp.pi)
        f = mu[..., None] + jnp.sqrt(2.0 * var[..., None]) * gh_x
        ey = jnp.sum(gh_w * self.conditional_mean(f), -1)
        ey2 = jnp.sum(gh_w * (self.conditional_variance(f) + self.conditional_mean(f) ** 2), -1)
        return ey, jnp.maximum(ey2 - ey**2, 1e-15)

    def conditional_mean(self, f):
        raise NotImplementedError

    def conditional_variance(self, f):
        raise NotImplementedError

    def samples(self, f, key):
        """One observation draw y ~ p(y|f) per latent entry, same shape as f
        (GPy likelihoods/likelihood.py samples:769 — there via numpy RNG)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement observation sampling")

    def predictive_quantiles(self, mu, var, quantiles, key=None, n_samples=300):
        """Sampling-based predictive quantiles (GPy likelihood.py:757-766):
        draw latent f_s ~ N(mu, var), corrupt through ``samples``, take
        percentiles. quantiles are in PERCENT; returns a list of (N, 1)
        arrays. Gaussian-family subclasses override with the closed form."""
        if key is None:
            key = jax.random.PRNGKey(0)
        mu = jnp.asarray(mu).reshape(-1)
        var = jnp.asarray(var).reshape(-1)
        kf, ky = jax.random.split(key)
        f = mu[:, None] + jnp.sqrt(var)[:, None] * jax.random.normal(
            kf, (mu.shape[0], n_samples), dtype=mu.dtype)
        y = self.samples(f, ky)
        return [jnp.percentile(y, q, axis=1)[:, None] for q in quantiles]

    def log_predictive_density(self, y, mu, var, gh_points=32):
        """log p(y*|D) = log int p(y*|f) N(f; mu, var) df by Gauss-Hermite in
        log space (GPy likelihood.py log_predictive_density quadrature path)."""
        from jax.scipy.special import logsumexp

        gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
        gh_x = jnp.asarray(gh_x)
        log_w = jnp.log(jnp.asarray(gh_w)) - 0.5 * jnp.log(jnp.pi)
        f = mu[..., None] + jnp.sqrt(2.0 * var[..., None]) * gh_x
        lp = self.logpdf(f, jnp.asarray(y)[..., None])
        return logsumexp(lp + log_w, axis=-1)

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=32):
        """EP moment matching against the cavity N(v/tau, 1/tau): returns
        (log Z_hat, mu_hat, sigma2_hat) — the quadrature fallback of GPy
        ``likelihoods/likelihood.py`` `moments_match_ep`, vectorized over sites
        and computed in log space for stability. Exact closed forms override
        this in Bernoulli (probit) and Gaussian.
        """
        gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
        gh_x = jnp.asarray(gh_x, dtype=jnp.result_type(tau_cav))
        log_gh_w = jnp.log(jnp.asarray(gh_w)) - 0.5 * jnp.log(jnp.pi)
        mu_cav = v_cav / tau_cav
        s_cav = jnp.sqrt(2.0 / tau_cav)
        f = mu_cav[..., None] + s_cav[..., None] * gh_x  # (n, gh)
        logp = self.logpdf(f, y[..., None])
        # log Z = logsumexp(log w + log p)
        a = log_gh_w + logp
        amax = jnp.max(a, axis=-1, keepdims=True)
        w = jnp.exp(a - amax)
        Z = jnp.sum(w, axis=-1)
        logZ = jnp.log(Z) + amax[..., 0]
        mu_hat = jnp.sum(w * f, axis=-1) / Z
        e2 = jnp.sum(w * jnp.square(f), axis=-1) / Z
        sigma2_hat = jnp.maximum(e2 - jnp.square(mu_hat), 1e-12)
        return logZ, mu_hat, sigma2_hat


@pytree_dataclass
class GaussianLik(Likelihood):
    """(likelihoods/gaussian.py:22)"""

    variance: jnp.ndarray = None

    @classmethod
    def create(cls, variance=1.0):
        return cls(variance=jnp.asarray(variance, dtype=float).reshape(()))

    def logpdf(self, f, y):
        return -0.5 * (jnp.log(2 * jnp.pi * self.variance) + jnp.square(y - f) / self.variance)

    def dlogpdf_df(self, f, y):
        return (y - f) / self.variance

    def d2logpdf_df2(self, f, y):
        return -jnp.ones_like(f) / self.variance

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return jnp.broadcast_to(self.variance, f.shape)

    def samples(self, f, key):
        return f + jnp.sqrt(self.variance) * jax.random.normal(key, f.shape,
                                                               dtype=f.dtype)

    def predictive_quantiles(self, mu, var, quantiles, key=None, n_samples=None):
        """Closed form (GPy gaussian.py predictive_quantiles): mu + ppf * sd
        with sd over latent var + noise."""
        from jax.scipy.special import ndtri

        mu = jnp.asarray(mu).reshape(-1, 1)
        sd = jnp.sqrt(jnp.asarray(var).reshape(-1, 1) + self.variance)
        return [mu + ndtri(q / 100.0) * sd for q in quantiles]

    def log_predictive_density(self, y, mu, var, gh_points=None):
        tot = var + self.variance
        return -0.5 * (jnp.log(2 * jnp.pi * tot) + jnp.square(y - mu) / tot)

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=None):
        """Exact Gaussian-site moments (GPy gaussian.py moments_match_ep):
        tilted = N(y | f, sigma2) N(f | mu_cav, s2_cav)."""
        s2_cav = 1.0 / tau_cav
        mu_cav = v_cav * s2_cav
        tot = self.variance + s2_cav
        logZ = -0.5 * (jnp.log(2 * jnp.pi * tot) + jnp.square(y - mu_cav) / tot)
        mu_hat = (self.variance * mu_cav + s2_cav * y) / tot
        sigma2_hat = self.variance * s2_cav / tot
        return logZ, mu_hat, sigma2_hat


@pytree_dataclass
class Bernoulli(Likelihood):
    """Probit-link Bernoulli (GPy likelihoods/bernoulli.py); y in {0,1} or {-1,1}."""

    def _z(self, f, y):
        ypm = jnp.where(y > 0, 1.0, -1.0)
        return ypm * f, ypm

    def logpdf(self, f, y):
        z, _ = self._z(f, y)
        return _norm_logcdf(z)

    def dlogpdf_df(self, f, y):
        z, ypm = self._z(f, y)
        # N(z)/Phi(z) computed stably via exp(logpdf - logcdf)
        ratio = jnp.exp(jax.scipy.stats.norm.logpdf(z) - _norm_logcdf(z))
        return ypm * ratio

    def d2logpdf_df2(self, f, y):
        z, ypm = self._z(f, y)
        ratio = jnp.exp(jax.scipy.stats.norm.logpdf(z) - _norm_logcdf(z))
        return -(ratio**2) - z * ratio

    def conditional_mean(self, f):
        return 0.5 * erfc(-f / jnp.sqrt(2.0))  # Phi(f)

    def conditional_variance(self, f):
        p = self.conditional_mean(f)
        return p * (1 - p)

    def predictive(self, mu, var, gh_points=None):
        """Closed-form probit predictive: p = Phi(mu / sqrt(1 + var))."""
        p = 0.5 * erfc(-(mu / jnp.sqrt(1.0 + var)) / jnp.sqrt(2.0))
        return p, p * (1 - p)

    def samples(self, f, key):
        return jax.random.bernoulli(key, self.conditional_mean(f)).astype(f.dtype)

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=None):
        """Exact probit moments (GPML 3.58-3.59 / GPy bernoulli.py moments_match_ep)."""
        ypm = jnp.where(y > 0, 1.0, -1.0)
        s2_cav = 1.0 / tau_cav
        mu_cav = v_cav * s2_cav
        denom = jnp.sqrt(1.0 + s2_cav)
        z = ypm * mu_cav / denom
        logZ = _norm_logcdf(z)
        ratio = jnp.exp(jax.scipy.stats.norm.logpdf(z) - logZ)
        mu_hat = mu_cav + ypm * s2_cav * ratio / denom
        sigma2_hat = s2_cav - jnp.square(s2_cav) * ratio * (z + ratio) / (1.0 + s2_cav)
        return logZ, mu_hat, jnp.maximum(sigma2_hat, 1e-12)


@pytree_dataclass
class Poisson(Likelihood):
    """Exp-link Poisson (GPy likelihoods/poisson.py); y non-negative counts."""

    def logpdf(self, f, y):
        lam = jnp.exp(f)
        return y * f - lam - gammaln(y + 1.0)

    def dlogpdf_df(self, f, y):
        return y - jnp.exp(f)

    def d2logpdf_df2(self, f, y):
        return -jnp.exp(f)

    def conditional_mean(self, f):
        return jnp.exp(f)

    def conditional_variance(self, f):
        return jnp.exp(f)

    def samples(self, f, key):
        return jax.random.poisson(key, jnp.exp(f), f.shape).astype(f.dtype)


@pytree_dataclass
class StudentT(Likelihood):
    """Student-t observation noise (GPy likelihoods/student_t.py)."""

    deg_free: jnp.ndarray = None
    sigma2: jnp.ndarray = None

    @classmethod
    def create(cls, deg_free=5.0, sigma2=2.0):
        return cls(deg_free=jnp.asarray(deg_free, dtype=float).reshape(()),
                   sigma2=jnp.asarray(sigma2, dtype=float).reshape(()))

    def logpdf(self, f, y):
        v, s2 = self.deg_free, self.sigma2
        e2 = jnp.square(y - f)
        return (
            gammaln((v + 1) / 2) - gammaln(v / 2)
            - 0.5 * jnp.log(s2 * v * jnp.pi)
            - (v + 1) / 2 * jnp.log1p(e2 / (v * s2))
        )

    def dlogpdf_df(self, f, y):
        v, s2 = self.deg_free, self.sigma2
        e = y - f
        return (v + 1) * e / (v * s2 + jnp.square(e))

    def d2logpdf_df2(self, f, y):
        v, s2 = self.deg_free, self.sigma2
        e2 = jnp.square(y - f)
        return (v + 1) * (e2 - v * s2) / jnp.square(v * s2 + e2)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return jnp.broadcast_to(self.deg_free / (self.deg_free - 2) * self.sigma2, f.shape)

    def samples(self, f, key):
        return f + jnp.sqrt(self.sigma2) * jax.random.t(key, self.deg_free,
                                                        f.shape, dtype=f.dtype)


@pytree_dataclass
class Binomial(Likelihood):
    """Binomial with probit link (GPy likelihoods/binomial.py): y successes out of
    `trials` with p = Phi(f)."""

    trials: jnp.ndarray = None

    @classmethod
    def create(cls, trials):
        return cls(trials=jnp.asarray(trials, dtype=float).reshape(-1))

    def _p(self, f):
        return jnp.clip(0.5 * erfc(-f / jnp.sqrt(2.0)), 1e-9, 1 - 1e-9)

    def _n(self, f):
        # trials is per-datapoint; broadcast over trailing (e.g. quadrature) axes
        return self.trials.reshape((-1,) + (1,) * (f.ndim - 1))

    def logpdf(self, f, y):
        n = self._n(f)
        p = self._p(f)
        return (
            gammaln(n + 1) - gammaln(y + 1) - gammaln(n - y + 1)
            + y * jnp.log(p) + (n - y) * jnp.log1p(-p)
        )

    def conditional_mean(self, f):
        return self._n(f) * self._p(f)

    def conditional_variance(self, f):
        p = self._p(f)
        return self._n(f) * p * (1 - p)

    def samples(self, f, key):
        n = jnp.broadcast_to(self._n(f), f.shape)
        return jax.random.binomial(key, n, self._p(f)).astype(f.dtype)


@pytree_dataclass
class GammaLik(Likelihood):
    """Gamma with exp link and fixed shape beta (GPy likelihoods/gamma.py):
    y ~ Gamma(shape=beta, rate=beta*exp(-f)) so E[y] = exp(f)."""

    beta: jnp.ndarray = None

    @classmethod
    def create(cls, beta=1.0):
        return cls(beta=jnp.asarray(beta, dtype=float).reshape(()))

    def logpdf(self, f, y):
        b = self.beta
        rate = b * jnp.exp(-f)
        return b * jnp.log(rate) - gammaln(b) + (b - 1) * jnp.log(y) - rate * y

    def conditional_mean(self, f):
        return jnp.exp(f)

    def conditional_variance(self, f):
        return jnp.exp(2 * f) / self.beta

    def samples(self, f, key):
        # y ~ Gamma(shape=beta, rate=beta e^-f)  =>  y = Gamma(beta) * e^f / beta
        g = jax.random.gamma(key, jnp.broadcast_to(self.beta, f.shape), dtype=f.dtype)
        return g * jnp.exp(f) / self.beta


@pytree_dataclass
class ExponentialLik(Likelihood):
    """Exponential with exp link (GPy likelihoods/exponential.py): rate exp(-f)."""

    def logpdf(self, f, y):
        return -f - y * jnp.exp(-f)

    def dlogpdf_df(self, f, y):
        return -1.0 + y * jnp.exp(-f)

    def d2logpdf_df2(self, f, y):
        return -y * jnp.exp(-f)

    def conditional_mean(self, f):
        return jnp.exp(f)

    def conditional_variance(self, f):
        return jnp.exp(2 * f)

    def samples(self, f, key):
        return jax.random.exponential(key, f.shape, dtype=f.dtype) * jnp.exp(f)


@pytree_dataclass
class HeteroscedasticGaussian(Likelihood):
    """Per-point noise variances (GPy likelihoods/gaussian.py HeteroscedasticGaussian:347)."""

    variances: jnp.ndarray = None  # (N,)

    @classmethod
    def create(cls, variances):
        return cls(variances=jnp.asarray(variances, dtype=float).reshape(-1))

    def logpdf(self, f, y):
        v = self.variances.reshape(f.shape)
        return -0.5 * (jnp.log(2 * jnp.pi * v) + jnp.square(y - f) / v)

    def dlogpdf_df(self, f, y):
        return (y - f) / self.variances.reshape(f.shape)

    def d2logpdf_df2(self, f, y):
        return -1.0 / self.variances.reshape(f.shape)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return jnp.broadcast_to(self.variances.reshape(f.shape), f.shape)

    def samples(self, f, key):
        v = self.variances.reshape((-1,) + (1,) * (f.ndim - 1))
        return f + jnp.sqrt(v) * jax.random.normal(key, f.shape, dtype=f.dtype)


# --------------------------------------------------------------------------- links
# First-class link functions (GPy likelihoods/link_functions.py): lambda = transf(f)
# maps the latent GP to the likelihood's natural parameter. Derivatives come from
# autodiff through transf (GPy hand-codes dtransf_df/d2/d3).


@pytree_dataclass
class Link:
    def transf(self, f):
        raise NotImplementedError

    def dtransf_df(self, f):
        return jax.grad(lambda ff: jnp.sum(self.transf(ff)))(f)


@pytree_dataclass
class IdentityLink(Link):
    """(link_functions.py:77)"""

    def transf(self, f):
        return f


@pytree_dataclass
class LogLink(Link):
    """lambda = exp(f) (link_functions.py:173)"""

    def transf(self, f):
        return jnp.exp(f)


@pytree_dataclass
class ProbitLink(Link):
    """lambda = Phi(f) (link_functions.py:109)"""

    def transf(self, f):
        return 0.5 * erfc(-f / jnp.sqrt(2.0))


@pytree_dataclass
class LogExp1Link(Link):
    """lambda = log(1 + exp(f)) — softplus (link_functions.py:192 Log_ex_1)"""

    def transf(self, f):
        return jnp.logaddexp(0.0, f)


@pytree_dataclass
class ReciprocalLink(Link):
    """lambda = 1/f (link_functions.py:217)"""

    def transf(self, f):
        return 1.0 / f


@pytree_dataclass
class CloglogLink(Link):
    """lambda = 1 - exp(-exp(f)) (link_functions.py:142)"""

    def transf(self, f):
        return -jnp.expm1(-jnp.exp(f))


@pytree_dataclass
class HeavisideLink(Link):
    """lambda = 1[f > 0] (link_functions.py:233) — not differentiable; only for
    Heaviside-classification sampling paths."""

    def transf(self, f):
        return jnp.where(f > 0, 1.0, 0.0)


@pytree_dataclass
class LinkedLikelihood(Likelihood):
    """Likelihood parameterized through a first-class link: subclasses implement
    ``logpdf_link(link_f, y)``; ``logpdf`` composes with ``gp_link.transf``
    (the GPy Likelihood/GPTransformation split, likelihoods/likelihood.py)."""

    gp_link: Link = None

    def logpdf_link(self, link_f, y):
        raise NotImplementedError

    def logpdf(self, f, y):
        return self.logpdf_link(self.gp_link.transf(f), y)


def _cens(censored, y):
    if censored is None:
        return jnp.zeros_like(y)
    return jnp.broadcast_to(jnp.asarray(censored, dtype=float), y.shape)


@pytree_dataclass
class Weibull(LinkedLikelihood):
    """Weibull survival likelihood, default Log link
    (GPy likelihoods/weibull.py:14-80): log p = log r - log(lam) + (r-1) log y
    - y^r / lam, censored entries contribute -y^r/lam only."""

    r: jnp.ndarray = None
    censored: jnp.ndarray = None

    @classmethod
    def create(cls, r=1.0, gp_link=None, censored=None):
        return cls(
            gp_link=gp_link if gp_link is not None else LogLink(),
            r=jnp.asarray(r, dtype=float).reshape(()),
            censored=None if censored is None else jnp.asarray(censored, dtype=float),
        )

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        yr = jnp.power(y, self.r)
        uncensored = (1 - c) * (
            jnp.log(self.r) - jnp.log(link_f) + (self.r - 1) * jnp.log(y)
            - yr / link_f
        )
        return uncensored + c * (-yr / link_f)

    def conditional_mean(self, f):
        lam = self.gp_link.transf(f)
        return jnp.power(lam, 1.0 / self.r) * jnp.exp(gammaln(1.0 + 1.0 / self.r))

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        m1 = jnp.exp(gammaln(1.0 + 1.0 / self.r))
        m2 = jnp.exp(gammaln(1.0 + 2.0 / self.r))
        return jnp.power(lam, 2.0 / self.r) * (m2 - m1**2)

    def samples(self, f, key):
        # CDF(y) = 1 - exp(-y^r/lam)  =>  y = (lam * E)^(1/r), E ~ Exp(1)
        lam = self.gp_link.transf(f)
        e = jax.random.exponential(key, f.shape, dtype=f.dtype)
        return jnp.power(lam * e, 1.0 / self.r)


@pytree_dataclass
class LogGaussian(LinkedLikelihood):
    """Log-normal observation model, default Identity link on the log-scale
    location (GPy likelihoods/loggaussian.py:13-60): log p = -0.5 log(2 pi s2)
    - log y - (log y - lam)^2/(2 s2); censored: log(1 - Phi((log y - lam)/s))."""

    variance: jnp.ndarray = None
    censored: jnp.ndarray = None

    @classmethod
    def create(cls, variance=1.0, gp_link=None, censored=None):
        return cls(
            gp_link=gp_link if gp_link is not None else IdentityLink(),
            variance=jnp.asarray(variance, dtype=float).reshape(()),
            censored=None if censored is None else jnp.asarray(censored, dtype=float),
        )

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        s2 = self.variance
        z = (jnp.log(y) - link_f) / jnp.sqrt(s2)
        uncensored = (1 - c) * (
            -0.5 * jnp.log(2 * jnp.pi * s2) - jnp.log(y) - 0.5 * jnp.square(z)
        )
        censored = c * _norm_logcdf(-z)  # log(1 - Phi(z)), stable
        return uncensored + censored

    def conditional_mean(self, f):
        lam = self.gp_link.transf(f)
        return jnp.exp(lam + self.variance / 2.0)

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        return jnp.expm1(self.variance) * jnp.exp(2 * lam + self.variance)

    def samples(self, f, key):
        lam = self.gp_link.transf(f)
        z = jax.random.normal(key, f.shape, dtype=f.dtype)
        return jnp.exp(lam + jnp.sqrt(self.variance) * z)


@pytree_dataclass
class LogLogistic(LinkedLikelihood):
    """Log-logistic (Fisk) survival likelihood, default Log link
    (GPy likelihoods/loglogistic.py:14-90): log p = log r + (r-1) log y
    - r log lam - 2 log1p((y/lam)^r); censored: -log1p((y/lam)^r)."""

    r: jnp.ndarray = None
    censored: jnp.ndarray = None

    @classmethod
    def create(cls, r=1.0, gp_link=None, censored=None):
        return cls(
            gp_link=gp_link if gp_link is not None else LogLink(),
            r=jnp.asarray(r, dtype=float).reshape(()),
            censored=None if censored is None else jnp.asarray(censored, dtype=float),
        )

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        log_ratio_r = self.r * (jnp.log(y) - jnp.log(link_f))
        log1p_term = jnp.log1p(jnp.exp(jnp.clip(log_ratio_r, None, 80.0)))
        uncensored = (1 - c) * (
            jnp.log(self.r) + (self.r - 1) * jnp.log(y)
            - self.r * jnp.log(link_f) - 2.0 * log1p_term
        )
        return uncensored + c * (-log1p_term)

    def conditional_mean(self, f):
        lam = self.gp_link.transf(f)
        b = jnp.pi / self.r
        return lam * b / jnp.sin(b)  # valid for r > 1

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        b = jnp.pi / self.r
        return jnp.square(lam) * (2 * b / jnp.sin(2 * b) - jnp.square(b / jnp.sin(b)))

    def samples(self, f, key):
        # CDF(y) = (y/lam)^r / (1 + (y/lam)^r)  =>  y = lam (u/(1-u))^(1/r)
        lam = self.gp_link.transf(f)
        u = jax.random.uniform(key, f.shape, dtype=f.dtype,
                               minval=1e-7, maxval=1.0 - 1e-7)
        return lam * jnp.power(u / (1.0 - u), 1.0 / self.r)


@pytree_dataclass
class MixedNoise(Likelihood):
    """Per-output Gaussian noise selected by an output index
    (GPy likelihoods/mixed_noise.py:14-60): entry n uses
    variances[output_index[n]]. The reference routes the index through
    Y_metadata; here it is carried as a field so the whole thing stays a pytree.
    """

    variances: jnp.ndarray = None  # (num_outputs,)
    output_index: jnp.ndarray = None  # (N,) int

    @classmethod
    def create(cls, variances, output_index):
        return cls(
            variances=jnp.asarray(variances, dtype=float).reshape(-1),
            output_index=jnp.asarray(output_index, dtype=int).reshape(-1),
        )

    def gaussian_variance(self):
        """(mixed_noise.py:23-30)"""
        return self.variances[self.output_index]

    def logpdf(self, f, y):
        v = self.gaussian_variance().reshape(f.shape)
        return -0.5 * (jnp.log(2 * jnp.pi * v) + jnp.square(y - f) / v)

    def dlogpdf_df(self, f, y):
        return (y - f) / self.gaussian_variance().reshape(f.shape)

    def d2logpdf_df2(self, f, y):
        return -1.0 / self.gaussian_variance().reshape(f.shape)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return jnp.broadcast_to(self.gaussian_variance().reshape(f.shape), f.shape)

    def predictive_values(self, mu, var):
        """(mixed_noise.py:45-52): adds the per-index noise variance."""
        v = self.gaussian_variance().reshape(mu.shape)
        return mu, var + v

    def samples(self, f, key):
        v = self.gaussian_variance().reshape((-1,) + (1,) * (f.ndim - 1))
        return f + jnp.sqrt(v) * jax.random.normal(key, f.shape, dtype=f.dtype)


@pytree_dataclass
class MultioutputLikelihood(Likelihood):
    """Per-output list of ARBITRARY likelihoods selected by an output index —
    GPy ``MultioutputLikelihood`` (``likelihoods/multioutput_likelihood.py:20``).
    Generalizes :class:`MixedNoise` (Gaussian-only) to any mix of observation
    models: row n uses ``likelihoods[output_index[n]]``.

    The reference dispatches per-row through ``Y_metadata['output_index']`` with
    boolean-mask numpy loops (multioutput_likelihood.py:79-130). JAX-native
    design: every sub-likelihood is evaluated on the FULL (N, ...) arrays (they
    are cheap elementwise ops) and rows are combined with a branchless
    ``jnp.where`` select — no data-dependent control flow, jit/vmap-safe.
    Derivatives select the sub-likelihoods' analytic derivatives (never autodiff
    through the select, so an invalid row of an unselected branch cannot
    poison gradients with NaNs).
    """

    likelihoods: tuple = None  # tuple of Likelihood pytrees (heterogeneous)
    output_index: jnp.ndarray = None  # (N,) int

    @classmethod
    def create(cls, likelihoods, output_index):
        import numpy as np

        idx = np.asarray(output_index, dtype=int).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= len(likelihoods)):
            # validate eagerly: the branchless _select would silently fall back
            # to likelihoods[0] for out-of-range rows while gaussian_variance's
            # gather would clamp to the LAST — two different silent answers
            raise ValueError(
                f"output_index values must lie in [0, {len(likelihoods) - 1}]; "
                f"got range [{idx.min()}, {idx.max()}]")
        return cls(
            likelihoods=tuple(likelihoods),
            output_index=jnp.asarray(idx),
        )

    def _idx_like(self, x):
        return self.output_index.reshape((-1,) + (1,) * (jnp.ndim(x) - 1))

    def _select(self, outs, like):
        idx = self._idx_like(like)
        res = outs[0]
        for j in range(1, len(outs)):
            res = jnp.where(idx == j, outs[j], res)
        return res

    def logpdf(self, f, y):
        return self._select([l.logpdf(f, y) for l in self.likelihoods], f)

    def dlogpdf_df(self, f, y):
        return self._select([l.dlogpdf_df(f, y) for l in self.likelihoods], f)

    def d2logpdf_df2(self, f, y):
        return self._select([l.d2logpdf_df2(f, y) for l in self.likelihoods], f)

    def conditional_mean(self, f):
        return self._select([l.conditional_mean(f) for l in self.likelihoods], f)

    def conditional_variance(self, f):
        return self._select([l.conditional_variance(f) for l in self.likelihoods], f)

    def samples(self, f, key):
        """Row-wise dispatch of the sub-likelihoods' samplers (branchless:
        every sub-likelihood samples the full array with its own key-split,
        rows selected by index — multioutput_likelihood.py samples)."""
        keys = jax.random.split(key, len(self.likelihoods))
        outs = [l.samples(f, k) for l, k in zip(self.likelihoods, keys)]
        return self._select(outs, f)

    def gaussian_variance(self):
        """Per-row noise when ALL sub-likelihoods are Gaussian — the exact-
        inference path (multioutput_likelihood.py:62-65 asserts the same)."""
        if not all(isinstance(l, GaussianLik) for l in self.likelihoods):
            raise TypeError(
                "gaussian_variance requires all sub-likelihoods Gaussian "
                "(use Laplace/EP inference for the general mix)")
        vs = jnp.stack([jnp.broadcast_to(l.variance, ()) for l in self.likelihoods])
        return vs[self.output_index]

    def predictive_values(self, mu, var):
        """Row-wise predictive through each sub-likelihood's observation model
        (multioutput_likelihood.py:79-88). mu/var are indexed like training rows."""
        outs = []
        for l in self.likelihoods:
            if hasattr(l, "predictive_values"):
                outs.append(l.predictive_values(mu, var))
            elif isinstance(l, GaussianLik):
                outs.append((mu, var + l.variance))
            else:
                outs.append(l.predictive(mu, var))
        m = self._select([o[0] for o in outs], mu)
        v = self._select([o[1] for o in outs], var)
        return m, v

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=32):
        """Site-wise EP moments through the matching sub-likelihood
        (multioutput_likelihood.py:59-60). ``gh_points`` is forwarded to
        quadrature-based sub-likelihoods; closed-form ones ignore it."""
        import inspect

        outs = []
        for l in self.likelihoods:
            # signature probe, not try/except TypeError: a TypeError raised
            # INSIDE a sub-likelihood's quadrature must propagate, not trigger
            # a silent retry at the default point count
            params = inspect.signature(l.moments_match_ep).parameters
            if "gh_points" in params:
                outs.append(l.moments_match_ep(y, tau_cav, v_cav,
                                               gh_points=gh_points))
            else:
                outs.append(l.moments_match_ep(y, tau_cav, v_cav))
        logZ = self._select([o[0] for o in outs], y)
        mu_hat = self._select([o[1] for o in outs], y)
        s2_hat = self._select([o[2] for o in outs], y)
        return logZ, mu_hat, s2_hat
