"""Acquisition functions (GPyOpt/GPyOpt/acquisitions/: base.py:6 AcquisitionBase,
EI.py:7, MPI.py:7, LCB.py:7, LP.py:10 local-penalization wrapper, *_mcmc variants).

Two faces per acquisition:
- the GPyOpt-parity host API: ``acquisition_function(x) = -(raw * indicator)/cost``
  (base.py:33), ``acquisition_function_withGradients`` (:42), ``optimize`` (:52);
- a pure jnp core ``pure_neg_acq(gp, posterior, fmin, state, X) -> (n,)`` in
  minimize-convention, used by the acquisition optimizer to run the 1000-candidate
  sweep and the multi-start L-BFGS as ONE jitted vmapped device program (the reference
  evaluates these point-batches through Python/GPy on CPU).

Quantile math matches GPyOpt util/general.py:113 get_quantiles: s floored at 1e-10,
u=(fmin - m - xi)/s, phi = N(u), Phi = 0.5 erfc(-u/sqrt(2)).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import erfc

from ..config import config


def constant_cost_withGradients(x):
    """Default unit cost (GPyOpt core/task/cost.py constant_cost_withGradients)."""
    x = np.atleast_2d(x)
    return np.ones((x.shape[0], 1)), np.zeros_like(x)


def get_quantiles(acquisition_par, fmin, m, s):
    """(phi, Phi, u) — jnp twin of GPyOpt util/general.py:113."""
    s = jnp.maximum(s, config.std_floor)
    u = (fmin - m - acquisition_par) / s
    phi = jnp.exp(-0.5 * jnp.square(u)) / jnp.sqrt(2 * jnp.pi)
    Phi = 0.5 * erfc(-u / jnp.sqrt(2.0))
    return phi, Phi, u


def _pure_predict(gp, posterior, X):
    """(m, s) in GPyOpt convention: mean and STD, variance floored at 1e-10
    (gpmodel.py:102, :99)."""
    mu, v = gp.predict(X, posterior=posterior)
    v = jnp.clip(v, config.variance_floor, None)
    return mu, jnp.sqrt(v)


class AcquisitionBase:
    """Base acquisition (GPyOpt acquisitions/base.py:6)."""

    analytical_gradient_prediction = False

    def __init__(self, model, space, optimizer=None, cost_withGradients=None):
        self.model = model
        self.space = space
        self.optimizer = optimizer
        self.analytical_gradient_acq = (
            self.analytical_gradient_prediction
            and getattr(model, "analytical_gradient_prediction", False)
        )
        self.cost_withGradients = cost_withGradients or constant_cost_withGradients

    @property
    def has_cost(self):
        return self.cost_withGradients is not constant_cost_withGradients

    # ---------------------------------------------------------------- pure core
    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        """Raw acquisition values (n, 1), higher = better. jnp, jit/vmap-safe."""
        raise NotImplementedError

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        """Minimize-convention values (n,) — what the on-device optimizer minimizes.
        Matches GPyOpt acquisition_function sign, without indicator/cost (those are
        applied host-side at anchor selection / final check)."""
        return -self.pure_raw_acq(gp, posterior, fmin, state, X)[:, 0]

    @property
    def supports_device(self):
        """True when the surrogate exposes a pure jnp state (GP family); False for
        host-only surrogates like the random forest — those go through the host
        predict() path exactly like the reference (EI.py:32 calls model.predict)."""
        return hasattr(self.model, "device_state")

    def device_args(self):
        """(gp, posterior, fmin, state) for the pure core."""
        gp, post, fmin = self.model.device_state()
        return gp, post, fmin, None

    def host_raw_acq(self, m, s, fmin):
        """Raw acquisition from host (numpy) predictions — used for surrogates
        without a device state. Default: evaluate the pure formula on numpy-backed
        jnp arrays."""
        raise NotImplementedError

    # ---------------------------------------------------------------- host API
    def _compute_acq(self, x):
        x = np.atleast_2d(x)
        if not self.supports_device:
            m, s = self.model.predict(x)
            return np.asarray(self.host_raw_acq(jnp.asarray(m), jnp.asarray(s),
                                                self.model.get_fmin()))
        gp, post, fmin, state = self.device_args()
        return np.asarray(self.pure_raw_acq(gp, post, fmin, state, jnp.asarray(x, dtype=float)))

    def _compute_acq_withGradients(self, x):
        if not self.supports_device:
            # Host-only surrogate: chain rule through (m, s) -> acq, matching the
            # reference's analytic formulas (EI.py:42-51: dEI = phi ds - Phi dm,
            # etc. — here obtained by differentiating host_raw_acq directly).
            x = np.atleast_2d(x)
            m, s, dmdx, dsdx = self.model.predict_withGradients(x)
            fmin = self.model.get_fmin()
            mj, sj = jnp.asarray(m), jnp.asarray(s)
            f = np.asarray(self.host_raw_acq(mj, sj, fmin))
            dfdm, dfds = jax.grad(
                lambda mm, ss: jnp.sum(self.host_raw_acq(mm, ss, fmin)),
                argnums=(0, 1),
            )(mj, sj)
            df = np.asarray(dfdm) * np.asarray(dmdx) + np.asarray(dfds) * np.asarray(dsdx)
            return f, df
        gp, post, fmin, state = self.device_args()
        X = jnp.asarray(np.atleast_2d(x), dtype=float)

        def single(xrow):
            return self.pure_raw_acq(gp, post, fmin, state, xrow[None, :])[0, 0]

        f = jax.vmap(single)(X)[:, None]
        df = jax.vmap(jax.grad(single))(X)
        return np.asarray(f), np.asarray(df)

    def acquisition_function(self, x):
        """-(raw * indicator)/cost (base.py:33)."""
        f_acqu = self._compute_acq(x)
        cost_x, _ = self.cost_withGradients(x)
        return -(f_acqu * self.space.indicator_constraints(x)) / cost_x

    def acquisition_function_withGradients(self, x):
        """(base.py:42)."""
        f_acqu, df_acqu = self._compute_acq_withGradients(x)
        cost_x, cost_grad_x = self.cost_withGradients(x)
        f_acq_cost = f_acqu / cost_x
        df_acq_cost = (df_acqu * cost_x - f_acqu * cost_grad_x) / (cost_x**2)
        ind = self.space.indicator_constraints(x)
        return -f_acq_cost * ind, -df_acq_cost * ind

    def optimize(self, duplicate_manager=None):
        """(base.py:52) — delegates to the AcquisitionOptimizer."""
        if not self.supports_device:
            # host-only surrogate (e.g. RF): gradient-free host optimization
            return self.optimizer.optimize(
                f=self.acquisition_function, duplicate_manager=duplicate_manager,
            )
        if not self.analytical_gradient_acq:
            return self.optimizer.optimize(
                f=self.acquisition_function, duplicate_manager=duplicate_manager,
                acquisition=self,
            )
        return self.optimizer.optimize(
            f=self.acquisition_function,
            f_df=self.acquisition_function_withGradients,
            duplicate_manager=duplicate_manager,
            acquisition=self,
        )


class AcquisitionEI(AcquisitionBase):
    """Expected improvement (EI.py:7): EI = s (u Phi + phi), u=(fmin-m-xi)/s."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None, jitter=0.01):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        m, s = _pure_predict(gp, posterior, X)
        return self.host_raw_acq(m, s, fmin)

    def host_raw_acq(self, m, s, fmin):
        phi, Phi, u = get_quantiles(self.jitter, fmin, m, s)
        return s * (u * Phi + phi)


class AcquisitionMPI(AcquisitionBase):
    """Maximum probability of improvement (MPI.py:7): Phi(u)."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None, jitter=0.01):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        m, s = _pure_predict(gp, posterior, X)
        return self.host_raw_acq(m, s, fmin)

    def host_raw_acq(self, m, s, fmin):
        _, Phi, _ = get_quantiles(self.jitter, fmin, m, s)
        return Phi


class AcquisitionLCB(AcquisitionBase):
    """GP lower confidence bound (LCB.py:7): -m + w*s. Ignores cost (LCB.py:30)."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 exploration_weight=2):
        super().__init__(model, space, optimizer, None)
        self.exploration_weight = exploration_weight
        if cost_withGradients is not None:
            print("The set cost function is ignored! LCB acquisition does not make sense with cost.")

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        m, s = _pure_predict(gp, posterior, X)
        return self.host_raw_acq(m, s, fmin)

    def host_raw_acq(self, m, s, fmin):
        return -m + self.exploration_weight * s


def _norm_logcdf(z):
    return jax.scipy.stats.norm.logcdf(z)


class AcquisitionLP(AcquisitionBase):
    """Local-penalization wrapper for batch BO (LP.py:10, Gonzalez et al. 2016).

    Penalized acquisition in log space: -[ log g(raw) + sum_j logcdf((|x-x_j|-r_j)/s_j) ]
    with g = softplus for LCB-like (sign-indefinite) acquisitions, identity otherwise
    (LP.py:31-34, :70-92). Batch state (X_batch, r, s) is carried as arrays so the
    penalized core stays a pure jitted program.
    """

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer, acquisition, transform="none"):
        super().__init__(model, space, optimizer)
        self.acq = acquisition
        self.transform = transform.lower()
        # LCB is sign-indefinite, so LP must softplus it before the log
        # (LP.py:33-34 maps BOTH AcquisitionLCB and AcquisitionLCB_MCMC; the
        # MCMC variant lives in acquisitions_mcmc.py — name check avoids the
        # circular import)
        if (isinstance(acquisition, (AcquisitionLCB,))
                or acquisition.__class__.__name__ == "AcquisitionLCB_MCMC") \
                and self.transform == "none":
            self.transform = "softplus"
        self.X_batch = None
        self.r_x0 = None
        self.s_x0 = None

    def update_batches(self, X_batch, L, Min):
        """(LP.py:40) precompute hammer radii r=(m-Min)/L and widths s=std/L.

        DELIBERATE DEVIATION from LP.py:55-59: the reference takes
        np.sqrt(pred)/L where pred is already the predictive STD — i.e.
        sqrt(std)/L, dimensionally inconsistent with the Lipschitz argument
        (Gonzalez et al. 2016 define the hammer width as sigma/L). We use
        std/L, the formula the reference's own docstring describes."""
        self.X_batch = X_batch
        if X_batch is not None:
            m, s_pred = self.model.predict(np.atleast_2d(X_batch))
            if isinstance(m, list):
                # MCMC surrogates return per-sample lists (gpmodel.py:257-277);
                # hammer radii use the sample-averaged surface (the reference
                # crashes outright on LP + MCMC here — list minus float)
                m = np.mean(np.stack(m), axis=0)
                s_pred = np.mean(np.stack(s_pred), axis=0)
            v = np.maximum(np.square(s_pred), 1e-16)
            s = np.sqrt(v)
            self.r_x0 = ((m - Min) / L).flatten()
            self.s_x0 = (s / L).flatten()
        else:
            self.r_x0, self.s_x0 = None, None

    def device_args(self):
        # the wrapped acquisition's own device state (e.g. the stacked
        # hyperparameter samples of the *_MCMC variants) must ride along —
        # dropping it crashed LP over any stateful acquisition
        gp, post, fmin, inner_state = self.acq.device_args()
        if self.X_batch is None:
            batch = None
        else:
            batch = (
                jnp.asarray(self.X_batch, dtype=float),
                jnp.asarray(self.r_x0, dtype=float),
                jnp.asarray(self.s_x0, dtype=float),
            )
        return gp, post, fmin, (inner_state, batch)

    def _log_transformed(self, gp, posterior, fmin, inner_state, X):
        raw = self.acq.pure_raw_acq(gp, posterior, fmin, inner_state, X)[:, 0]
        if self.transform == "softplus":
            # log(softplus(raw)); above 40, softplus(x) ~= x (LP.py:79-81)
            return jnp.where(
                raw >= 40.0, jnp.log(jnp.maximum(raw, 1e-50)),
                jnp.log(jnp.log1p(jnp.exp(jnp.minimum(raw, 40.0)))),
            )
        return jnp.log(raw + 1e-50)

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        """Penalized, minimize-convention (LP.py:70-92 _penalized_acquisition)."""
        inner_state, batch = state if state is not None else (None, None)
        fval = -self._log_transformed(gp, posterior, fmin, inner_state, X)
        if batch is not None:
            X_batch, r, s = batch
            d = jnp.sqrt(
                jnp.maximum(
                    jnp.sum(jnp.square(X[:, None, :] - X_batch[None, :, :]), -1), 1e-32
                )
            )
            h = _norm_logcdf((d - r[None, :]) / s[None, :])
            fval = fval - jnp.sum(h, axis=-1)
        return fval

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        return -self.pure_neg_acq(gp, posterior, fmin, state, X)[:, None]

    # host API (GPyOpt LP returns the log-space penalized value directly)
    def acquisition_function(self, x):
        gp, post, fmin, state = self.device_args()
        return np.asarray(
            self.pure_neg_acq(gp, post, fmin, state, jnp.asarray(np.atleast_2d(x), dtype=float))
        )[:, None]

    def acquisition_function_withGradients(self, x):
        gp, post, fmin, state = self.device_args()
        X = jnp.asarray(np.atleast_2d(x), dtype=float)

        def single(xrow):
            return self.pure_neg_acq(gp, post, fmin, state, xrow[None, :])[0]

        f = np.asarray(jax.vmap(single)(X))[:, None]
        df = np.asarray(jax.vmap(jax.grad(single))(X))
        return f, df

    def optimize(self, duplicate_manager=None):
        return self.optimizer.optimize(
            f=self.acquisition_function,
            f_df=self.acquisition_function_withGradients,
            duplicate_manager=duplicate_manager,
            acquisition=self,
        )
