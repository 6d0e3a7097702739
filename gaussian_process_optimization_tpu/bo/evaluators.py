"""Batch evaluators (GPyOpt/GPyOpt/core/evaluators/: base.py:7 EvaluatorBase +
SamplingBasedBatchEvaluator:21, sequential.py:7, batch_random.py:9,
batch_local_penalization.py:9 (+ estimate_L:52), batch_thompson.py:10).

Notes: the Lipschitz estimate (max |grad mu| over 500 uniform samples + train X,
polished by L-BFGS) runs as one jitted vmapped program; the greedy LP loop stays a
host loop of device argmax calls (k is small and each step re-optimizes a penalized
acquisition — exactly the reference flow, batch_local_penalization.py:22-50).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lbfgs
from .anchor_points import (
    RandomAnchorPointsGenerator,
    ThompsonSamplingAnchorPointsGenerator,
)


class EvaluatorBase:
    """(base.py:7)"""

    def __init__(self, acquisition, batch_size, **kwargs):
        self.acquisition = acquisition
        self.batch_size = batch_size

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError


class Sequential(EvaluatorBase):
    """Single argmax (sequential.py:7)."""

    def __init__(self, acquisition, batch_size=1):
        super().__init__(acquisition, batch_size)

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        x, _ = self.acquisition.optimize(duplicate_manager=duplicate_manager)
        return x


class SamplingBasedBatchEvaluator(EvaluatorBase):
    """(base.py:21): anchor-based batch w/ dedupe loop compute_batch:46."""

    def __init__(self, acquisition, batch_size, **kwargs):
        super().__init__(acquisition, batch_size)
        self.space = acquisition.space
        self.num_anchor = 5 * batch_size

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        raise NotImplementedError

    def zip_and_tuple(self, x):
        return tuple(self.space.zip_inputs(np.atleast_2d(x)).flatten())

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        self.context_manager = context_manager
        if not duplicate_manager:
            return self.compute_batch_without_duplicate_logic(context_manager=context_manager)

        batch, already = [], duplicate_manager.unique_points.copy()
        anchor_points = self.get_anchor_points(duplicate_manager, context_manager)
        x0 = self.initialize_batch(duplicate_manager, context_manager)
        if x0 is not None and np.any(x0):
            batch.append(x0)
            already.add(self.zip_and_tuple(x0))
        for a in anchor_points:
            x = self.optimize_anchor_point(a, duplicate_manager, context_manager)
            zx = self.zip_and_tuple(x)
            if zx not in already:
                batch.append(x)
                already.add(zx)
            else:
                za = self.zip_and_tuple(a)
                if za not in already:
                    batch.append(a)
                    already.add(za)
            if len(batch) == self.batch_size:
                break
        if len(batch) < self.batch_size:
            print(
                f"Warning: the batch of requested size {self.batch_size} could not be "
                f"entirely filled in (only {len(batch)} points)"
            )
        return np.vstack([np.atleast_2d(b) for b in batch])


class RandomBatch(SamplingBasedBatchEvaluator):
    """First element by acquisition argmax, rest uniformly random (batch_random.py:9)."""

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        x, _ = self.acquisition.optimize(duplicate_manager=duplicate_manager)
        return x

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        gen = RandomAnchorPointsGenerator(self.space, "random")
        return gen.get(num_anchor=self.num_anchor, duplicate_manager=duplicate_manager,
                       unique=bool(duplicate_manager),
                       context_manager=self.acquisition.optimizer.context_manager)

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        return a

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        x = self.initialize_batch()
        anchors = self.get_anchor_points(context_manager=context_manager)
        return np.vstack((x, anchors[: (self.batch_size - 1), :]))


class ThompsonBatch(SamplingBasedBatchEvaluator):
    """Elements chosen by optimizing the acquisition from Thompson-sampled anchors
    (batch_thompson.py:10)."""

    def __init__(self, acquisition, batch_size):
        super().__init__(acquisition, batch_size)
        self.model = acquisition.model
        # per-acquisition jitted anchor solver (weak-keyed like
        # AcquisitionOptimizer._jit_cache): building the L-BFGS closure per
        # anchor baked the posterior arrays into the HLO as constants — a full
        # XLA recompile per anchor per suggest call
        import weakref

        self._jit_cache = weakref.WeakKeyDictionary()

    def _anchor_solver(self, acq):
        if acq not in self._jit_cache:
            from ..ops import lbfgs as lbfgs_mod

            maxiter = acq.optimizer.maxiter

            def solve(gp, post, fmin, state, a, lo, hi):
                res = lbfgs_mod.minimize(
                    lambda x: acq.pure_neg_acq(gp, post, fmin, state, x[None, :])[0],
                    a, lower=lo, upper=hi, maxiter=maxiter, carry_vjp=False,
                )
                return res.x

            self._jit_cache[acq] = jax.jit(solve)
        return self._jit_cache[acq]

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        return None

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        gen = ThompsonSamplingAnchorPointsGenerator(self.space, "random", model=self.model)
        return gen.get(num_anchor=self.num_anchor, duplicate_manager=duplicate_manager,
                       unique=bool(duplicate_manager), context_manager=context_manager)

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        """Local L-BFGS from THIS anchor, then round (batch_thompson.py:40-52)."""
        import jax.numpy as jnp

        acq = self.acquisition
        opt = acq.optimizer
        bounds = self.space.get_bounds()
        lo = np.asarray([b[0] for b in bounds], dtype=float)
        hi = np.asarray([b[1] for b in bounds], dtype=float)
        if context_manager is not None and context_manager.context_index:
            lo[context_manager.context_index] = np.asarray(context_manager.context_value)
            hi[context_manager.context_index] = np.asarray(context_manager.context_value)
        if getattr(acq, "supports_device", False):
            gp, post, fmin, state = acq.device_args()
            solve = self._anchor_solver(acq)
            x = np.asarray(solve(gp, post, fmin, state,
                                 jnp.asarray(a, dtype=float), jnp.asarray(lo),
                                 jnp.asarray(hi)))
        else:
            import scipy.optimize

            r = scipy.optimize.minimize(
                lambda x: float(np.asarray(acq.acquisition_function(np.atleast_2d(x))).flatten()[0]),
                a, method="L-BFGS-B", bounds=list(zip(lo, hi)),
                options={"maxiter": opt.maxiter},
            )
            x = r.x if np.isfinite(r.fun) else a
        return self.space.round_optimum(x)

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        anchors = self.get_anchor_points(context_manager=context_manager)
        return np.vstack([
            self.optimize_anchor_point(a, context_manager=context_manager)
            for a, _ in zip(anchors, range(self.batch_size))
        ])


def _neg_grad_norm(gp, post, x):
    """-|grad mu(x)| of the posterior-mean surface (the LP Lipschitz objective)."""
    def mean_at(xx):
        mu, _ = gp.predict(xx[None, :], posterior=post)
        return mu[0, 0]

    g = jax.grad(mean_at)(x)
    return -jnp.sqrt(jnp.sum(jnp.square(g)) + 1e-300)


@jax.jit
def _grad_norm_sweep(gp, post, samples):
    return jax.vmap(lambda x: _neg_grad_norm(gp, post, x))(samples)


@jax.jit
def _grad_norm_refine(gp, post, x0, lo, hi):
    res = lbfgs.minimize(lambda x: _neg_grad_norm(gp, post, x), x0,
                         lower=lo, upper=hi, maxiter=200, carry_vjp=False)
    return res.f


@jax.jit
def _point_inference(gp):
    # Non-fit factorization: always use the VERIFIED minimal-rung ladder, even
    # if the model carries jitter_greedy=True from its fitter (greedy is a fit
    # line-search policy only — mirrors bo_models.updateModel's posterior).
    from dataclasses import replace

    return replace(gp, jitter_greedy=False).inference(precompute_inverse=False)


def estimate_L(model, bounds, seed=0):
    """Lipschitz estimate: max |grad mu(x)| over 500 uniform samples + the training
    inputs, refined by L-BFGS; floor L=10 when < 1e-7
    (batch_local_penalization.py:52-76). One jitted vmapped program on device.

    The two device programs are MODULE-LEVEL jits taking (gp, post) as pytree
    ARGUMENTS: building them as per-call closures baked the posterior arrays into
    the HLO as constants, so every ask-tell iteration paid a full XLA recompile
    for programs whose shapes never changed."""
    gp = model.model
    post = getattr(model, "posterior", None)
    if post is None:
        # surrogates without a cached single posterior (GPModel_MCMC keeps a
        # stacked sample chain instead): factor the point-estimate model once —
        # the Lipschitz constant only needs the mean surface's scale
        post = _point_inference(gp)

    lo = np.asarray([b[0] for b in bounds], dtype=float)
    hi = np.asarray([b[1] for b in bounds], dtype=float)
    rng = np.random.default_rng(seed)
    samples = rng.uniform(lo, hi, size=(500, len(bounds)))
    X_train = np.asarray(gp.X)
    if gp.mask is not None:
        X_train = X_train[np.asarray(gp.mask) > 0]
    samples = np.vstack([samples, X_train])

    vals = _grad_norm_sweep(gp, post, jnp.asarray(samples))
    x0 = samples[int(np.argmin(np.asarray(vals)))]
    f_ref = _grad_norm_refine(gp, post, jnp.asarray(x0), jnp.asarray(lo),
                              jnp.asarray(hi))
    L = float(-f_ref)
    if L < 1e-7:
        L = 10.0  # to avoid problems in cases in which the model is flat
    return L


class LocalPenalization(EvaluatorBase):
    """Greedy LP batch construction (batch_local_penalization.py:9)."""

    def __init__(self, acquisition, batch_size):
        super().__init__(acquisition, batch_size)

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        from .acquisitions import AcquisitionLP

        assert isinstance(self.acquisition, AcquisitionLP)
        acq = self.acquisition
        acq.update_batches(None, None, None)

        X_batch, _ = acq.optimize(duplicate_manager=duplicate_manager)
        k = 1
        if self.batch_size > 1:
            L = estimate_L(acq.model, acq.space.get_bounds())
            Min = acq.model.Y_min()
        while k < self.batch_size:
            acq.update_batches(X_batch, L, Min)
            new_sample, _ = acq.optimize(duplicate_manager=duplicate_manager)
            X_batch = np.vstack((X_batch, new_sample))
            k += 1
        acq.update_batches(None, None, None)
        return X_batch
