"""MRD — Manifold Relevance Determination (GPy/GPy/models/mrd.py:1-354).

Multi-view Bayesian GPLVM: V observation matrices Y_v share ONE variational
latent q(X) = N(q_mu, diag(q_S)); each view has its own ARD RBF kernel,
inducing points and noise. The objective is

    sum_v collapsed_bound_v(q(X))  -  KL(q(X) || N(0, I))

(mrd.py log_likelihood: per-view SparseGP bounds over a shared X variational
posterior). Shared vs private latent dimensions emerge through the per-view ARD
inverse lengthscales — a dimension relevant to every view is shared; one with
weight in a single view is private (the 'relevance determination').

Structure: the per-view bounds are independent given q(X) — a Python loop
emitting V independent Lm/LB factorizations that XLA schedules concurrently;
gradients to all views' parameters and the shared q(X) come from one autodiff
pass (GPy hand-stitches per-view gradient arrays, mrd.py ~250 lines of plumbing).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..kernels.stationary import RBF
from ..utils.pytree import pytree_dataclass
from .gplvm import gaussian_kl, uncertain_input_bound


@pytree_dataclass
class MRD:
    kerns: tuple = ()  # one ARD RBF per view
    noise_vars: jnp.ndarray = None  # (V,)
    Zs: tuple = ()  # one (M, Q) inducing set per view
    q_mu: jnp.ndarray = None  # (N, Q) shared variational means
    q_S: jnp.ndarray = None  # (N, Q) shared variational variances
    Ys: tuple = ()  # V centered observation matrices

    @classmethod
    def create(cls, Ys, input_dim, num_inducing=10, noise_var=0.1, seed=0):
        """PCA-concat initialization of the shared latent (mrd.py _init_X 'PCA'
        on the stacked views)."""
        Ys = [np.asarray(Y, dtype=float) for Y in Ys]
        n = Ys[0].shape[0]
        assert all(Y.shape[0] == n for Y in Ys), "views must share N"
        Ycs = [Y - Y.mean(0) for Y in Ys]
        stacked = np.concatenate(Ycs, axis=1)
        _, _, Vt = np.linalg.svd(stacked, full_matrices=False)
        mu0 = stacked @ Vt[:input_dim].T
        mu0 /= mu0.std(0) + 1e-9
        rng = np.random.default_rng(seed)
        kerns, Zs = [], []
        for _ in Ys:
            kerns.append(RBF.create(input_dim, ARD=True))
            Zs.append(jnp.asarray(mu0[rng.permutation(n)[:num_inducing]].copy()))
        return cls(
            kerns=tuple(kerns),
            noise_vars=jnp.full((len(Ys),), float(noise_var)),
            Zs=tuple(Zs),
            q_mu=jnp.asarray(mu0),
            q_S=0.5 * jnp.ones((n, input_dim)),
            Ys=tuple(jnp.asarray(Y) for Y in Ycs),
        )

    def elbo(self):
        bound = 0.0
        for v, (k, Z, Y) in enumerate(zip(self.kerns, self.Zs, self.Ys)):
            bound = bound + uncertain_input_bound(
                k, Z, self.noise_vars[v], Y, self.q_mu, self.q_S
            )
        return bound - gaussian_kl(self.q_mu, self.q_S)

    def log_marginal_likelihood(self):
        return self.elbo()

    def relevance(self):
        """(V, Q) ARD relevance weights 1/lengthscale^2 per view — the MRD
        shared/private read-out (mrd.py plot_scales)."""
        w = [1.0 / jnp.square(k.lengthscale) for k in self.kerns]
        return jnp.stack(w)


def fit_mrd(model: MRD, maxiter=300):
    """L-BFGS over all view hyperparameters + shared q(X) (mrd.py uses the
    paramz optimizer over the linked hierarchy)."""
    from ..ops import lbfgs
    from ..utils.packing import Packer
    from ..utils.transforms import IDENTITY, POSITIVE
    from .fit import make_objective
    from .parameters import POSITIVE_NAMES, _leaf_names

    names = _leaf_names(model)
    transforms, fixed = [], []
    for nm in names:
        if nm in POSITIVE_NAMES or nm in ("q_S", "noise_vars"):
            transforms.append(POSITIVE)
        else:
            transforms.append(IDENTITY)
        fixed.append(nm == "Ys")
    packer = Packer(model, transforms=transforms, fixed=fixed)
    obj = make_objective(packer)
    u0 = packer.pack(model)
    res = lbfgs.minimize(lambda u: obj(u, model), u0, maxiter=maxiter)
    return packer.unpack(res.x, reference=model), res
