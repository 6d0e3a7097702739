"""Exact GP regression — the centerpiece.

JAX rebuild of GPy's exact inference and posterior algebra:
- ``GPy/GPy/inference/latent_function_inference/exact_gaussian_inference.py:37``:
  Ky = K + (sigma^2 + 1e-8) I;  L = jitchol(Ky);  alpha = Ky^-1 Yc;
  logL = 0.5(-ND log 2pi - D logdet - sum(alpha*Yc)).
- ``GPy/GPy/inference/latent_function_inference/posterior.py:274`` (PosteriorExact):
  mu* = Kx^T alpha;  tmp = L^-1 Kx;  var* = Kdiag(X*) - sum(tmp^2) (or full cov).
- ``GPy/GPy/core/gp.py``: predict:297 (latent -> +noise -> un-normalize),
  predictive_gradients:407, posterior_samples:611.
- ``GPy/GPy/models/gp_regression.py:9``: GPRegression = GP + Gaussian likelihood +
  default RBF kernel.

Design differences (accelerator-first):
- the model is an immutable pytree; ``jax.grad`` of :func:`log_marginal_likelihood`
  replaces the hand-plumbed dL_dK -> update_gradients_full machinery (and its
  OpenMP/Cython hot loops).
- optional fixed-size padding with a row mask: padded rows are replaced by identity
  rows in the Gram matrix, so BO loops (where N grows by 1 each iteration) reuse one
  compiled program per bucket size instead of recompiling every step (SURVEY §7
  "Dynamic shapes").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.normalizer import Standardize
from ..utils.pytree import pytree_dataclass, replace, static_field
from .mean_functions import Mapping

import math

# Pure-host constant: must NOT be a jnp computation — evaluating one at import
# time initializes the default device backend, which breaks entry points that
# need to pick the platform (e.g. the multi-chip CPU dryrun) after import.
LOG_2_PI = math.log(2.0 * math.pi)


def _exact_core_impl(Ky, Yc, k_hint, greedy=False):
    """Shared primal for _exact_core and its VJP fwd: returns (outputs, residuals)
    so the two traces cannot drift numerically."""
    from ..ops import linalg as _linalg

    # k_hint: first jitter rung to probe (min-rung binary search — the result
    # is hint-independent; the BO wrappers carry the previous refit's rung so
    # ill-conditioned fits pay ~2 factorizations per trial instead of rung+1).
    # greedy: accept the first success walking up from the hint (ONE batched
    # factorization steady state — fit line-search trials only; see
    # GPRegression.jitter_greedy)
    L, jitter, ok, rung = _linalg.jitchol_full(Ky, k_start=k_hint, greedy=greedy)
    # blocked 1-rhs forward substitution: XLA's full-size triangular solve is
    # latency-bound at this shape (~9-10 ms of the 21.6 ms LML value pass at
    # N=4096 B=5) and this is the line-search hot path
    t = _linalg.blocked_solve_lower(L, Yc)
    logdet = _linalg.logdet_from_chol(L)
    quad = jnp.sum(t * t)
    alpha = _linalg.solve_lower_t(L, t)  # DCE'd when only the LML is used
    return (logdet, quad, L, alpha, jitter, ok, rung), (L, t, k_hint)


from functools import partial as _partial


@_partial(jax.custom_vjp, nondiff_argnums=(3,))
def _exact_core(Ky, Yc, k_hint, greedy=False):
    """(logdet, quad, L, alpha, jitter, ok) for the exact-GP LML with the CLOSED-FORM
    pullback: d(logdet)/dKy = Ky^-1, d(quad)/dKy = -alpha alpha^T, d(quad)/dYc =
    2 alpha — exactly GPy's dL_dK = 0.5(alpha alpha^T - Wi)
    (exact_gaussian_inference.py:70), one dpotri instead of autodiff's two full-width
    triangular solves through the Cholesky. L/alpha/jitter/ok are returned
    NON-DIFFERENTIABLE (their cotangents are dropped — they feed predict paths that
    never differentiate w.r.t. them, matching GPy's posterior semantics).

    Cost shaping: a 1-rhs triangular solve is LATENCY-bound (a sequential sweep
    per lane), so the LML is computed from the single
    half-solve t = L^-1 Yc (quad = ||t||^2 = Yc^T Ky^-1 Yc); `alpha` is derived
    lazily (XLA dead-code-eliminates its second solve whenever the caller only
    consumes the LML, i.e. every fit/line-search step) and the backward pass
    rebuilds it as the matmul Li^T t from the Li it must form anyway."""
    return _exact_core_impl(Ky, Yc, k_hint, greedy)[0]


def _exact_core_fwd(Ky, Yc, k_hint, greedy=False):
    return _exact_core_impl(Ky, Yc, k_hint, greedy)


def _exact_core_bwd(greedy, res, cts):
    from ..ops import linalg as _linalg

    L, t, k_hint = res
    c_logdet, c_quad = cts[0], cts[1]  # cotangents on L/alpha/jitter/ok dropped
    # gradient-only precision knob (config.grad_matmul_precision): these
    # contractions steer the optimizer but never touch predictions
    prec = config.grad_matmul_precision
    prec = None if prec == "highest" else prec
    Li = _linalg.tri_inv_lower(L, precision=prec)
    # alpha = L^-T (L^-1 Yc) as a matmul instead of a latency-bound solve; it
    # feeds dYc (gradient) only — the posterior's alpha comes from the primal
    alpha = jnp.matmul(Li.T, t, precision=prec)
    # lauum-blocked Li^T Li: only the nonzero panels multiply (~2x fewer FLOPs
    # than the dense matmul; measured 5.5 vs 10.5 ms at N=4096 B=5)
    Wi = _linalg.tri_tdot(Li, precision=prec)
    dKy = c_logdet * Wi - c_quad * jnp.matmul(alpha, alpha.T, precision=prec)
    dYc = (2.0 * c_quad) * alpha
    return dKy, dYc, jnp.zeros_like(k_hint)


_exact_core.defvjp(_exact_core_fwd, _exact_core_bwd)


@jax.custom_vjp
def _assemble_ky(K, noise, mask):
    """Ky = masked_gram(K + diag(noise), mask) as ONE differentiable unit.

    Why a custom VJP for a couple of elementwise ops: autodiff saves each
    product's operands as residuals, and in the fit path those residuals ride
    the line-search while_loop carry — at N=4096, B=5 restarts that was ~2
    extra (B, N, N) float32 buffers plus an (N, N) bool written per trial and
    copied at every loop boundary (measured ~10-17 ms/step of pure structure).
    The hand-written pullback needs only the (N,) mask: dK = dKy * outer(mask)
    (recomputed on the fly), dnoise = masked diagonal of dKy.
    """
    return _assemble_ky_primal(K, noise, mask)


def _assemble_ky_primal(K, noise, mask):
    from ..ops import linalg as _linalg

    n = K.shape[-1]
    Ky = K + jnp.diag(jnp.broadcast_to(noise, (n,)).astype(K.dtype))
    return _linalg.masked_gram(Ky, mask)


def _assemble_ky_fwd(K, noise, mask):
    return _assemble_ky_primal(K, noise, mask), (jnp.shape(noise), mask)


def _assemble_ky_bwd(res, dKy):
    noise_shape, mask = res
    if mask is not None:
        m = mask.astype(dKy.dtype)
        dK = dKy * (m[:, None] * m[None, :])
        dnoise_vec = jnp.diagonal(dKy) * m
    else:
        dK = dKy
        dnoise_vec = jnp.diagonal(dKy)
    dnoise = jnp.sum(dnoise_vec) if noise_shape == () else dnoise_vec
    return dK, dnoise, None


_assemble_ky.defvjp(_assemble_ky_fwd, _assemble_ky_bwd)


@pytree_dataclass
class Posterior:
    """Woodbury representation of the exact posterior (GPy posterior.py:9).

    `Li` (= L^-1, optional) trades one N-rhs triangular solve at posterior-build
    time for MATMUL-only predictive variances afterwards: a triangular solve
    is a sequential blocked algorithm (latency-bound for the thin right-hand
    sides of acquisition optimization), while Li @ Kx is one matmul. Build it
    with `GPRegression.inference(precompute_inverse=True)` for predict-heavy
    phases (the acquisition argmax). Mirrors GPy's lazy `woodbury_inv`."""

    L: jnp.ndarray = None  # lower Cholesky of Ky (woodbury_chol)
    alpha: jnp.ndarray = None  # Ky^-1 (Y - m)      (woodbury_vector)
    jitter: jnp.ndarray = None
    ok: jnp.ndarray = None
    lml: jnp.ndarray = None
    Li: jnp.ndarray = None  # optional L^-1 (enables matmul-path prediction)
    # accepted jitchol ladder rung (int) — feed back as the next refit's
    # GPRegression.jitter_hint so ill-conditioned fits skip the ladder climb
    rung: jnp.ndarray = None


@pytree_dataclass
class GPRegression:
    """Exact GP regression with Gaussian likelihood.

    Fields `X (N,D)`, `Y (N,P)` may be padded to a fixed budget; `mask (N,)` flags
    real rows (None = all real). `Y` is stored raw; if `normalizer` is set the
    standardization is applied inside inference and inverted at predict
    (GPy util/normalizer.py Standardize).
    """

    kern: Kernel = None
    likelihood_variance: jnp.ndarray = None
    X: jnp.ndarray = None
    Y: jnp.ndarray = None
    mask: jnp.ndarray = None
    mean_function: Mapping = None
    normalizer: Standardize = None
    # first jitchol ladder rung to probe (f32 scalar; None = 0 = GPy's fresh
    # ladder). NOT a parameter (parameters.DATA_NAMES): the BO wrappers set it
    # to the previous refit's accepted rung (Posterior.rung) so every
    # line-search trial of an ill-conditioned fit pays ~2 Cholesky attempts
    # instead of re-climbing the ladder from 0 (the minimal-rung RESULT is
    # hint-independent; see ops/linalg._jitchol_loop)
    jitter_hint: jnp.ndarray = None
    # jitchol policy for THIS model's inference: False (default) = verified
    # minimal-rung search (GPy-parity jitter regardless of the hint); True =
    # accept the first success walking up from jitter_hint (1 batched
    # factorization steady state — the BO wrappers enable it for fit
    # line-search trials and re-verify minimality at the once-per-refit
    # posterior factorization, which re-anchors the hint; see
    # ops/linalg._jitchol_loop and bo_models.updateModel)
    jitter_greedy: bool = static_field(default=False)

    # ------------------------------------------------------------------ factory
    @classmethod
    def create(
        cls,
        X,
        Y,
        kernel: Kernel | None = None,
        noise_var: float = 1.0,
        normalizer: bool = False,
        mean_function: Mapping | None = None,
        max_points: int | None = None,
    ):
        X = jnp.atleast_2d(jnp.asarray(X, dtype=float))
        Y = jnp.asarray(Y, dtype=float)
        if Y.ndim == 1:
            Y = Y[:, None]
        n, d = X.shape
        if kernel is None:
            kernel = RBF.create(d)  # GPy GPRegression default (gp_regression.py:30)
        norm = Standardize.fit(Y) if normalizer else None
        mask = None
        if max_points is not None:
            if max_points < n:
                raise ValueError(f"max_points={max_points} < n={n}")
            pad = max_points - n
            X = jnp.concatenate([X, jnp.zeros((pad, d), X.dtype)])
            Y = jnp.concatenate([Y, jnp.zeros((pad, Y.shape[1]), Y.dtype)])
            # mask is ALWAYS present when padding is requested — even when pad == 0 —
            # so the pytree structure (and thus the cached jitted fit program) is
            # stable as the BO loop grows N to exactly the bucket size.
            mask = (jnp.arange(max_points) < n).astype(X.dtype)
        # scalar noise -> homoscedastic; (N,) vector -> heteroscedastic
        # (GPy gp_heteroscedastic_regression.py semantics)
        noise_arr = jnp.asarray(noise_var, dtype=float)
        noise_arr = noise_arr.reshape(()) if noise_arr.ndim == 0 or noise_arr.size == 1 \
            else noise_arr.reshape(-1)
        if noise_arr.ndim == 1:
            if noise_arr.shape[0] != n:
                raise ValueError(
                    f"heteroscedastic noise_var has {noise_arr.shape[0]} entries "
                    f"for {n} data points")
            if max_points is not None:
                # pad like X/Y; the value is irrelevant — masked_gram overwrites
                # padded rows with identity rows before the Cholesky
                noise_arr = jnp.concatenate(
                    [noise_arr, jnp.ones(max_points - n, noise_arr.dtype)])
        return cls(
            kern=kernel,
            likelihood_variance=noise_arr,
            X=X,
            Y=Y,
            mask=mask,
            mean_function=mean_function,
            normalizer=norm,
        )

    def with_data(self, X, Y, max_points: int | None = None):
        """set_XY equivalent (GPy gp.py set_XY); refits the normalizer like GPy does.

        A heteroscedastic (vector) noise cannot be carried to a different data
        set — the per-point variances belong to the OLD rows; pass them
        explicitly via create() instead."""
        norm = self.normalizer is not None
        noise = self.likelihood_variance
        if noise.ndim == 1:
            n_new = jnp.atleast_2d(jnp.asarray(X)).shape[0]
            n_old = int(self.num_data) if self.mask is not None else self.X.shape[0]
            if n_new != n_old:
                raise ValueError(
                    "with_data on a heteroscedastic model with a different "
                    "number of rows: per-point noise for the new rows is "
                    "unknown — rebuild with GPRegression.create(..., "
                    "noise_var=<per-point variances>)")
            noise = noise[:n_old]  # strip padding; create() re-pads
        new = GPRegression.create(
            X,
            Y,
            kernel=self.kern,
            noise_var=noise,
            normalizer=norm,
            mean_function=self.mean_function,
            max_points=max_points,
        )
        if self.jitter_hint is not None:  # carry the ladder warm start
            new = replace(new, jitter_hint=self.jitter_hint)
        if self.jitter_greedy:  # carry the ladder policy with the hint
            new = replace(new, jitter_greedy=True)
        return new

    # ------------------------------------------------------------------ internals
    @property
    def num_data(self):
        if self.mask is None:
            return self.X.shape[0]
        return jnp.sum(self.mask)

    def _normalized_Y(self):
        Yn = self.normalizer.normalize(self.Y) if self.normalizer is not None else self.Y
        if self.mean_function is not None:
            Yn = Yn - self.mean_function.f(self.X)
        if self.mask is not None:
            Yn = Yn * self.mask[:, None]
        return Yn

    def _effective_noise(self, dtype):
        """sigma^2 + 1e-8 (exact_gaussian_inference.py:52), with an f32-only floor
        relative to the kernel variance scale (see config.f32_noise_floor).
        A vector likelihood_variance (N,) gives the heteroscedastic model
        (GPy HeteroscedasticGPRegression / likelihoods/gaussian.py:347)."""
        noise = self.likelihood_variance + config.noise_jitter
        if dtype == jnp.float32:
            noise = jnp.maximum(noise, config.f32_noise_floor)
        return noise

    def _noise_at_test(self, noise_at_test=None):
        """Likelihood variance added at test points.

        Homoscedastic (scalar) model: the scalar (an explicit ``noise_at_test``
        overrides it). Heteroscedastic (vector) model: the training rows' noises
        don't determine test-point noise, so the caller MUST say what they mean —
        GPy requires the same via ``Y_metadata['output_index']``
        (``likelihoods/gaussian.py:347`` HeteroscedasticGaussian
        ``gaussian_variance`` indexes the per-point variance array):

        - ``'mean'``: mean of the per-TRAIN-point variances (real rows only);
        - scalar: that variance at every test point;
        - array (M,): per-test-point variances (the Y_metadata analog — e.g.
          ``likelihood_variance[:n]`` when predicting at the training inputs).
        """
        v = self.likelihood_variance
        if isinstance(noise_at_test, str) and noise_at_test != "mean":
            raise ValueError(f"unknown noise_at_test mode {noise_at_test!r}")
        if v.ndim == 0:
            if noise_at_test is None or isinstance(noise_at_test, str):
                return v
            return jnp.asarray(noise_at_test, dtype=v.dtype)
        if noise_at_test is None:
            raise ValueError(
                "heteroscedastic model: test-point likelihood variance is "
                "ambiguous — pass noise_at_test='mean', a scalar, or a per-test-"
                "point (M,) array (GPy's Y_metadata output_index analog), or use "
                "predict_noiseless()")
        if isinstance(noise_at_test, str):  # 'mean' (validated at the top)
            if self.mask is not None:
                return jnp.sum(v * self.mask) / jnp.maximum(jnp.sum(self.mask), 1.0)
            return jnp.mean(v)
        return jnp.asarray(noise_at_test, dtype=v.dtype)

    def inference(self, precompute_inverse: bool = False) -> Posterior:
        """Exact Gaussian inference (exact_gaussian_inference.py:37-75).

        precompute_inverse: also store Li = L^-1 so subsequent predictions are
        matmul-only (see Posterior.Li)."""
        Yc = self._normalized_Y()
        K = self.kern.K(self.X)
        noise = self._effective_noise(K.dtype)
        Ky = _assemble_ky(K, noise, self.mask)
        hint = self.jitter_hint
        if hint is None:
            hint = jnp.zeros((), jnp.float32)
        logdet, quad, L, alpha, jitter, ok, rung = _exact_core(
            Ky, Yc, hint, bool(self.jitter_greedy))
        p = Yc.shape[1]
        n_real = self.num_data
        lml = 0.5 * (-n_real * p * LOG_2_PI - p * logdet - quad)
        Li = None
        if precompute_inverse:
            Li = linalg.tri_inv_lower(L)
        return Posterior(L=L, alpha=alpha, jitter=jitter, ok=ok, lml=lml, Li=Li,
                         rung=rung)

    def log_marginal_likelihood(self) -> jnp.ndarray:
        return self.inference().lml

    # ------------------------------------------------------------------ prediction
    def _raw_predict(self, Xnew, full_cov=False, posterior: Posterior | None = None):
        """Latent predictive (normalized space), PosteriorExact._raw_predict:274."""
        post = posterior if posterior is not None else self.inference()
        Xnew = jnp.atleast_2d(Xnew)
        Kx = self.kern.K(self.X, Xnew)
        if self.mask is not None:
            Kx = Kx * self.mask[:, None]
        mu = Kx.T @ post.alpha
        if self.mean_function is not None:
            mu = mu + self.mean_function.f(Xnew)
        # matmul path when L^-1 was precomputed (see Posterior.Li)
        tmp = post.Li @ Kx if post.Li is not None else linalg.solve_lower(post.L, Kx)
        if full_cov:
            var = self.kern.K(Xnew) - tmp.T @ tmp
            var = linalg.symmetrify(var)
        else:
            var = self.kern.Kdiag(Xnew) - jnp.sum(jnp.square(tmp), axis=0)
            var = jnp.clip(var, 1e-15, None)[:, None]  # GPy posterior.py floor
        return mu, var

    def predict(self, Xnew, full_cov=False, include_likelihood=True,
                posterior: Posterior | None = None, noise_at_test=None):
        """Predict in original Y units; adds Gaussian noise if include_likelihood
        (GPy gp.py:297 + likelihoods/gaussian.py:102). ``noise_at_test`` selects
        the test-point likelihood variance for heteroscedastic models — see
        :meth:`_noise_at_test` (required there; ignored-if-None for scalar noise)."""
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, posterior=posterior)
        if include_likelihood:
            noise = self._noise_at_test(noise_at_test)
            if full_cov:
                var = var + jnp.diag(jnp.broadcast_to(noise, (var.shape[0],)).astype(var.dtype))
            else:
                noise = noise[:, None] if jnp.ndim(noise) == 1 else noise
                var = var + noise
        if self.normalizer is not None:
            mu = self.normalizer.inverse_mean(mu)
            if full_cov:
                var = self.normalizer.inverse_covariance(var)
            else:
                var = self.normalizer.inverse_variance(var)
        return mu, var

    def predict_noiseless(self, Xnew, full_cov=False):
        return self.predict(Xnew, full_cov=full_cov, include_likelihood=False)

    def predictive_gradients(self, Xnew, posterior: Posterior | None = None):
        """(dmu/dXnew (M,D,P), dvar/dXnew (M,D)) — GPy gp.py:407. Computed by
        forward-mode autodiff per test point (vmapped), replacing kern.gradients_X."""
        post = posterior if posterior is not None else self.inference()

        def mu_var(x):
            mu, var = self._raw_predict(x[None, :], full_cov=False, posterior=post)
            if self.normalizer is not None:
                mu = self.normalizer.inverse_mean(mu)
                var = self.normalizer.inverse_variance(var)
            return mu[0], var[0, 0]

        def dmu(x):
            return jax.jacfwd(lambda xx: mu_var(xx)[0])(x)  # (P, D)

        def dvar(x):
            return jax.jacfwd(lambda xx: mu_var(xx)[1])(x)  # (D,)

        Xnew = jnp.atleast_2d(Xnew)
        dm = jax.vmap(dmu)(Xnew)  # (M, P, D)
        dv = jax.vmap(dvar)(Xnew)  # (M, D)
        return jnp.swapaxes(dm, 1, 2), dv

    def posterior_samples_f(self, Xnew, size, key):
        """Samples of the latent function (GPy gp.py posterior_samples_f:585)."""
        mu, cov = self._raw_predict(Xnew, full_cov=True)
        m = Xnew.shape[0]
        cov = cov + 1e-10 * jnp.eye(m, dtype=cov.dtype)
        Lc, _, _ = linalg.jitchol(cov)
        z = jax.random.normal(key, (m, size), dtype=cov.dtype)
        samples = mu + Lc @ z  # broadcasting over output dim P=1
        if self.normalizer is not None:
            samples = self.normalizer.inverse_mean(samples)
        return samples

    def posterior_samples(self, Xnew, size, key, noise_at_test=None):
        """Samples of noisy observations (GPy gp.py posterior_samples:611)."""
        key_f, key_n = jax.random.split(key)
        f = self.posterior_samples_f(Xnew, size, key_f)
        noise = self._noise_at_test(noise_at_test)
        noise = noise[:, None] if jnp.ndim(noise) == 1 else noise
        noise_std = jnp.sqrt(noise)
        if self.normalizer is not None:
            noise_std = noise_std * self.normalizer.std.reshape(-1)[0]
        return f + noise_std * jax.random.normal(key_n, f.shape, dtype=f.dtype)

    def plot(self, bounds=None, filename=None, resolution=200, n_samples=0,
             key=None, title=None):
        """Posterior plot (GPy's injected m.plot(), plotting/gpy_plot)."""
        from ..utils.plotting import plot_gp

        return plot_gp(self, bounds=bounds, filename=filename, resolution=resolution,
                       n_samples=n_samples, key=key, title=title)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), noise_at_test=None,
                          posterior: Posterior | None = None):
        """Predictive quantiles in percent (GPy gp.py:384 + the Gaussian
        likelihood's predictive_quantiles = mu + sd * Phi^-1(q/100)). Returns a
        list of (M, P) arrays, one per requested quantile."""
        from scipy.stats import norm as _norm

        mu, var = self.predict(Xnew, full_cov=False, include_likelihood=True,
                               posterior=posterior, noise_at_test=noise_at_test)
        sd = jnp.sqrt(var)
        return [mu + float(_norm.ppf(q / 100.0)) * sd for q in quantiles]

    def log_predictive_density(self, x_test, y_test, noise_at_test=None):
        """Per-point log p(y*|D) under the Gaussian predictive (GPy gp.py:680
        -> likelihoods log_predictive_density). Computed in original Y units —
        when a normalizer is active this includes the change-of-variables the
        reference skips (its _raw_predict feeds normalized-space moments
        straight to the likelihood); identical when normalizer is None."""
        y_test = jnp.atleast_2d(jnp.asarray(y_test))
        mu, var = self.predict(x_test, full_cov=False, include_likelihood=True,
                               noise_at_test=noise_at_test)
        return -0.5 * (LOG_2_PI + jnp.log(var) + jnp.square(y_test - mu) / var)

    def log_predictive_density_sampling(self, x_test, y_test, key,
                                        num_samples=1000, noise_at_test=None):
        """Monte-Carlo log p(y*|D) = log mean_s p(y*|f_s), f_s ~ p(f*|D)
        (GPy gp.py:696). Converges to :meth:`log_predictive_density` for the
        Gaussian likelihood; kept for parity and as an MC cross-check."""
        y_test = jnp.atleast_2d(jnp.asarray(y_test))
        mu, var = self._raw_predict(jnp.atleast_2d(x_test), full_cov=False)
        z = jax.random.normal(key, (mu.shape[0], num_samples), dtype=mu.dtype)
        f = mu + jnp.sqrt(var) * z  # (M, S) latent samples, normalized space
        noise = self._noise_at_test(noise_at_test)
        noise = noise[:, None] if jnp.ndim(noise) == 1 else noise
        if self.normalizer is not None:
            f = self.normalizer.inverse_mean(f)
            noise = self.normalizer.inverse_variance(noise)
        lp = -0.5 * (LOG_2_PI + jnp.log(noise)
                     + jnp.square(y_test - f) / noise)  # (M, S)
        from jax.scipy.special import logsumexp

        return logsumexp(lp, axis=1, keepdims=True) - jnp.log(num_samples)

    def posterior_covariance_between_points(self, X1, X2,
                                            posterior: Posterior | None = None):
        """K(X1,X2) - K(X,X1)^T Ky^-1 K(X,X2) (GPy gp.py:714 ->
        posterior.covariance_between_points). Normalized (latent) space like
        the reference, which applies no un-normalization here either."""
        post = posterior if posterior is not None else self.inference()
        X1, X2 = jnp.atleast_2d(X1), jnp.atleast_2d(X2)
        Kx1, Kx2 = self.kern.K(self.X, X1), self.kern.K(self.X, X2)
        if self.mask is not None:
            Kx1 = Kx1 * self.mask[:, None]
            Kx2 = Kx2 * self.mask[:, None]
        if post.Li is not None:
            t1, t2 = post.Li @ Kx1, post.Li @ Kx2
        else:
            t1 = linalg.solve_lower(post.L, Kx1)
            t2 = linalg.solve_lower(post.L, Kx2)
        return self.kern.K(X1, X2) - t1.T @ t2

    def predict_jacobian(self, Xnew, posterior: Posterior | None = None):
        """Mean and covariance of the DERIVATIVE of the posterior GP (GPy
        gp.py:456 — not the derivative of the predictive moments, which is
        :meth:`predictive_gradients`). Returns (mean_jac (M, D, P),
        var_jac (M, D, D)): per test point, E[df/dx] and Cov[df/dx] =
        d2k/dx dx' - (dKx/dx)^T Ky^-1 (dKx/dx'). The prior curvature term is
        the kernel's analytic diagonal limit (``kern.d2K_dXdX2_diag`` —
        nested AD through the guarded sqrt silently returns 0 for Matern-type
        kernels); the data-fit term is smooth at generic test points and comes
        from nested forward-mode autodiff (replacing kern.gradients_XX).
        Normalized space like the reference."""
        post = posterior if posterior is not None else self.inference()
        mask = self.mask

        def post_mean(x):  # (D,) -> (P,)
            kx = self.kern.K(self.X, x[None, :])
            if mask is not None:
                kx = kx * mask[:, None]
            return (kx.T @ post.alpha)[0]

        def data_term(x1, x2):  # (dKx/dx1)^T Ky^-1 (dKx/dx2) scalar kernel
            k1 = self.kern.K(self.X, x1[None, :])
            k2 = self.kern.K(self.X, x2[None, :])
            if mask is not None:
                k1, k2 = k1 * mask[:, None], k2 * mask[:, None]
            t1 = linalg.solve_lower(post.L, k1)
            t2 = linalg.solve_lower(post.L, k2)
            return (t1.T @ t2)[0, 0]

        Xnew = jnp.atleast_2d(Xnew)
        mean_jac = jax.vmap(jax.jacfwd(post_mean))(Xnew)  # (M, P, D)
        d2 = jax.jacfwd(jax.jacfwd(data_term, argnums=0), argnums=1)
        var_jac = jax.vmap(
            lambda x: self.kern.d2K_dXdX2_diag(x) - d2(x, x))(Xnew)  # (M, D, D)
        return jnp.swapaxes(mean_jac, 1, 2), var_jac

    def predict_wishart_embedding(self, Xnew, mean=True, covariance=True,
                                  posterior: Posterior | None = None):
        """Expected metric G = J_mu^T J_mu + P * Cov[J] of the probabilistic
        mapping (GPy gp.py:521). (M, D, D)."""
        mean_jac, var_jac = self.predict_jacobian(Xnew, posterior=posterior)
        G = jnp.zeros_like(var_jac)
        if mean:
            G = G + jnp.einsum("idp,iep->ide", mean_jac, mean_jac)
        if covariance:
            G = G + self.Y.shape[1] * var_jac
        return G

    def predict_magnification(self, Xnew, mean=True, covariance=True,
                              dimensions=None,
                              posterior: Posterior | None = None):
        """sqrt(det(G)) per test point over the two most ARD-significant input
        dims (GPy gp.py:556)."""
        G = self.predict_wishart_embedding(Xnew, mean=mean,
                                           covariance=covariance,
                                           posterior=posterior)
        if dimensions is None:
            import numpy as _np

            try:
                rel = _np.asarray(self.kern.input_sensitivity()).reshape(-1)
            except Exception:
                rel = _np.ones(G.shape[1])
            dimensions = tuple(_np.argsort(rel)[::-1][:2].tolist())
        dims = jnp.asarray(dimensions, dtype=int)
        Gs = G[:, dims][:, :, dims]
        # det clamped at 0: G is PSD in exact arithmetic but f32 cancellation
        # (prior minus data term, both ~variance/l^2 scale) can leave a tiny
        # negative det; sqrt of that would be NaN
        return jnp.sqrt(jnp.maximum(jnp.linalg.det(Gs), 0.0))

    def log_likelihood_LOO(self):
        """Leave-one-out predictive density (exact_gaussian_inference.py LOO:77)."""
        post = self.inference()
        Yc = self._normalized_Y()
        n = self.X.shape[0]
        Ki = linalg.dpotri(post.L)
        diag_Ki = jnp.diagonal(Ki)
        mu_loo = Yc - post.alpha / diag_Ki[:, None]
        var_loo = 1.0 / diag_Ki
        lpd = -0.5 * (
            jnp.log(2 * jnp.pi)
            + jnp.log(var_loo)[:, None]
            + jnp.square(Yc - mu_loo) / var_loo[:, None]
        )
        if self.mask is not None:
            lpd = lpd * self.mask[:, None]
        return lpd
