"""IBP latent force model (GPy models/ibp_lfm.py: VarDTC_minibatch_IBPLFM:19,
IBPPrior:418, IBPPosterior:378, IBPLFM:467).

A second-order latent force model (kernels/lfm.py EQ_ODE2) where each
output-force connection d->q is gated by a Bernoulli Z_{dq} with an Indian
Buffet Process (stick-breaking Beta) prior:

    pi_q ~ Beta(alpha/Q, 1),   Z_{dq} ~ Bernoulli(pi_q)

Variational posterior: q(Z_{dq}) = Bernoulli(gamma_{dq}) and
q(pi_q) = Beta(tau_{1q}, tau_{2q}). The collapsed sparse bound is the VarDTC
bound with SPIKE-AND-SLAB psi statistics (expectations of the LFM kernel under
q(Z), ibp_lfm.py:27-99 gatherPsiStat):

    psi0 = sum_nq gamma[d_n, q] kdiag_q(x_n)
    psi1 = Kfu * gamma[d_n, q_m]
    psi2 = sum_d Kfu_d^T Kfu_d  o  Zp2_d[q_m, q_m'],
           Zp2_d = gamma_d gamma_d^T - diag(gamma_d^2) + diag(gamma_d)

plus E_q[log p(Z, pi)] + H[q] (ibp_lfm.py:426-450 — the reference *adds* this
'KL_divergence', which is -KL(q||p); same here).

Accelerator-first: the reference's per-output python loop + minibatch/MPI machinery
become one-hot einsums inside a single jitted ELBO; all gradients (gamma, tau,
kernel, Z, noise) by autodiff, replacing update_gradients (ibp_lfm.py:290-377).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..kernels.lfm import EQ_ODE2
from ..ops import linalg
from ..utils.pytree import pytree_dataclass, static_field

LOG_2_PI = math.log(2 * math.pi)


def ibp_neg_kl(gamma, tau, alpha):
    """E_q[log p(Z, pi)] + H[q(Z)] + H[q(pi)] (ibp_lfm.py IBPPrior.KL_divergence
    :426-450 — despite the name it returns the SIGNED term added to the bound)."""
    from jax.scipy.special import digamma, gammaln

    D, Q = gamma.shape
    ad = alpha / Q
    t1, t2 = tau[0], tau[1]
    sum_eta = jnp.sum(gamma, axis=0)
    psitau1 = digamma(t1)
    psitau2 = digamma(t2)
    psitau = digamma(t1 + t2)
    # E[log p(z | pi)]
    part1 = jnp.sum(sum_eta * psitau1 + (D - sum_eta) * psitau2 - D * psitau)
    # E[log p(pi)]
    part1 = part1 + (ad - 1.0) * jnp.sum(psitau1 - psitau) + Q * jnp.log(ad)
    # H(z)
    g = jnp.clip(gamma, 1e-9, 1 - 1e-9)
    part2 = jnp.sum(-(1 - g) * jnp.log1p(-g) - g * jnp.log(g))
    # H(pi)
    part2 = part2 + jnp.sum(
        gammaln(t1) + gammaln(t2) - gammaln(t1 + t2)
        - (t1 - 1.0) * psitau1 - (t2 - 1.0) * psitau2
        + (t1 + t2 - 2.0) * psitau
    )
    return part1 + part2


@pytree_dataclass
class IBPLFM:
    """Indian Buffet Process LFM (ibp_lfm.py:467).

    X: (N, 2) stacked (time, output_index<D); Y: (N, 1).
    Z: (M, 2) inducing (time, force_index = D + q) — the reference permutes
    data rows for Z (ibp_lfm.py:494); here Z defaults to latin times x all
    forces, which is the same role with better coverage.
    gamma_logit: (D, Q) unconstrained; gamma = sigmoid.
    tau: (2, Q) positive Beta parameters of q(pi).
    """

    kern: EQ_ODE2 = None
    gamma_logit: jnp.ndarray = None
    tau: jnp.ndarray = None
    Z: jnp.ndarray = None
    likelihood_variance: jnp.ndarray = None
    X: jnp.ndarray = None
    Y: jnp.ndarray = None
    alpha: float = static_field(default=2.0)

    @classmethod
    def create(cls, X, Y, output_dim, rank, kernel=None, Gamma=None, tau=None,
               num_inducing=10, Z=None, noise_var=0.1, alpha=2.0, seed=0):
        import numpy as np

        rng = np.random.default_rng(seed)
        X = jnp.atleast_2d(jnp.asarray(X, dtype=float))
        Y = jnp.asarray(Y, dtype=float).reshape(X.shape[0], 1)
        if kernel is None:
            kernel = EQ_ODE2.create(output_dim=output_dim, rank=rank, seed=seed)
        if Gamma is None:
            g = np.clip(0.5 + 0.1 * rng.standard_normal((output_dim, rank)),
                        1e-6, 1 - 1e-6)  # ibp_lfm.py:487-491
        else:
            g = np.clip(np.asarray(Gamma, dtype=float), 1e-6, 1 - 1e-6)
        if tau is None:
            tau = np.ones((2, rank))
        if Z is None:
            t_lo, t_hi = float(X[:, 0].min()), float(X[:, 0].max())
            m_per = max(1, num_inducing // rank)
            times = np.linspace(t_lo, t_hi, m_per)
            Z = np.vstack([
                np.stack([times, np.full(m_per, float(output_dim + q))], 1)
                for q in range(rank)
            ])
        return cls(
            kern=kernel,
            gamma_logit=jnp.asarray(np.log(g) - np.log1p(-g)),
            tau=jnp.asarray(tau, dtype=float),
            Z=jnp.asarray(Z, dtype=float),
            likelihood_variance=jnp.asarray(noise_var, dtype=float).reshape(()),
            X=X, Y=Y, alpha=float(alpha),
        )

    @property
    def gamma(self):
        return jax.nn.sigmoid(self.gamma_logit)

    # ------------------------------------------------------------------ bound
    def _psi_stats(self):
        """Spike-and-slab psi statistics (gatherPsiStat, ibp_lfm.py:27-99),
        WITHOUT the beta scaling (applied in elbo)."""
        gamma = self.gamma
        D, Q = gamma.shape
        indX = jnp.rint(self.X[:, -1]).astype(int)            # (N,) output ids
        indZ = jnp.rint(self.Z[:, -1]).astype(int) - D        # (M,) force ids
        psi1_raw = self.kern.K(self.X, self.Z)                # (N, M), has W
        gX = gamma[indX]                                      # (N, Q)
        psi1 = psi1_raw * gX[:, indZ]                         # (N, M)
        kdq = self.kern.Kdiag_per_force(self.X)               # (N, Q)
        psi0 = jnp.sum(kdq * gX)
        # psi2 = sum_d (psi1_raw_d^T psi1_raw_d) o Zp2_d[indZ, indZ]
        onehot = jax.nn.one_hot(indX, D, dtype=psi1_raw.dtype)  # (N, D)
        B_d = jnp.einsum("nd,nm,nk->dmk", onehot, psi1_raw, psi1_raw)
        Zp2 = (gamma[:, :, None] * gamma[:, None, :]
               - jnp.eye(Q)[None] * jnp.square(gamma)[:, :, None]
               + jnp.eye(Q)[None] * gamma[:, :, None])        # (D, Q, Q)
        Zp2_m = Zp2[:, indZ][:, :, indZ]                      # (D, M, M)
        psi2 = jnp.sum(B_d * Zp2_m, axis=0)                   # (M, M)
        return psi0, psi1, psi2

    def data_bound(self):
        """The collapsed VarDTC bound with spike-and-slab psi stats
        (inference_likelihood, ibp_lfm.py:101-165), output_dim(Y) = 1."""
        beta = 1.0 / jnp.maximum(self.likelihood_variance, 1e-6)
        n = self.X.shape[0]
        m = self.Z.shape[0]
        psi0, psi1, psi2 = self._psi_stats()
        psi1Y = (self.Y.T @ psi1) * beta                      # (1, M)
        psi2 = psi2 * beta
        psi0 = psi0 * beta
        YRY = jnp.sum(jnp.square(self.Y)) * beta

        Kmm = self.kern.K(self.Z)
        Kmm = Kmm + 1e-6 * jnp.mean(jnp.diagonal(Kmm)) * jnp.eye(m, dtype=Kmm.dtype)
        Lm, _, _ = linalg.jitchol(Kmm)
        LmInvPsi2LmInvT = linalg.solve_lower(
            Lm, linalg.solve_lower(Lm, psi2).T)
        Lambda = jnp.eye(m, dtype=Kmm.dtype) + LmInvPsi2LmInvT
        LL, _, _ = linalg.jitchol(Lambda)
        logdet_L = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LL)))
        # b = psi1Y (Lm LL)^-T ;  bbt = |b|^2
        b = linalg.solve_lower(LL, linalg.solve_lower(Lm, psi1Y.T))
        bbt = jnp.sum(jnp.square(b))
        logL_R = -n * jnp.log(beta)
        logL = -0.5 * (n * LOG_2_PI + logL_R + psi0
                       - jnp.trace(LmInvPsi2LmInvT) + YRY - bbt) \
            - 0.5 * logdet_L
        return logL

    def elbo(self):
        return self.data_bound() + ibp_neg_kl(self.gamma, self.tau, self.alpha)

    def log_likelihood(self):  # reference Model API name
        return self.elbo()

    # ---------------------------------------------------------------- predict
    def predict(self, Xnew, include_likelihood=True):
        """Posterior mean/variance at stacked (time, output_index) test rows,
        from the optimal q(u) of the collapsed bound."""
        gamma = self.gamma
        D = gamma.shape[0]
        beta = 1.0 / jnp.maximum(self.likelihood_variance, 1e-6)
        m = self.Z.shape[0]
        indZ = jnp.rint(self.Z[:, -1]).astype(int) - D
        _, psi1, psi2 = self._psi_stats()
        Kmm = self.kern.K(self.Z)
        Kmm = Kmm + 1e-6 * jnp.mean(jnp.diagonal(Kmm)) * jnp.eye(m, dtype=Kmm.dtype)
        Lm, _, _ = linalg.jitchol(Kmm)
        LmInvPsi2LmInvT = linalg.solve_lower(Lm, linalg.solve_lower(Lm, psi2 * beta).T)
        Lambda = jnp.eye(m, dtype=Kmm.dtype) + LmInvPsi2LmInvT
        LL, _, _ = linalg.jitchol(Lambda)
        psi1Y = (self.Y.T @ psi1) * beta
        b = linalg.solve_lower(LL, linalg.solve_lower(Lm, psi1Y.T))  # (M, 1)

        Xnew = jnp.atleast_2d(jnp.asarray(Xnew, dtype=float))
        indXs = jnp.rint(Xnew[:, -1]).astype(int)
        Ks_raw = self.kern.K(Xnew, self.Z)
        Ks = Ks_raw * gamma[indXs][:, indZ]
        tmp = linalg.solve_lower(Lm, Ks.T)       # (M, N*)
        tmp2 = linalg.solve_lower(LL, tmp)
        mu = tmp2.T @ b                          # (N*, 1)
        kdiag = jnp.sum(self.kern.Kdiag_per_force(Xnew) * gamma[indXs], axis=1)
        var = kdiag - jnp.sum(jnp.square(tmp), 0) + jnp.sum(jnp.square(tmp2), 0)
        if include_likelihood:
            var = var + self.likelihood_variance
        return mu, jnp.clip(var, 1e-15, None)[:, None]

    # --------------------------------------------------------------- optimize
    def optimize(self, maxiter=200, learning_rate=0.02, fix_kernel=False):
        """Adam on the negative ELBO over (gamma, tau, kernel, Z times, noise)
        — autodiff replaces ibp_lfm.py update_gradients :290-377. Returns
        (fitted_model, elbo_trace)."""
        import optax

        from .parameters import make_packer

        fix = ("X", "Y") + (("W", "lengthscale", "C", "B") if fix_kernel else ())
        packer = make_packer(self, fix=fix)
        u0 = packer.pack(self)

        def neg_elbo(u):
            return -packer.unpack(u).elbo()

        opt = optax.adam(learning_rate)
        state = opt.init(u0)

        @jax.jit
        def step(u, state):
            val, g = jax.value_and_grad(neg_elbo)(u)
            updates, state = opt.update(g, state)
            return optax.apply_updates(u, updates), state, val

        u = u0
        trace = []
        for _ in range(maxiter):
            u, state, val = step(u, state)
            trace.append(float(val))
        return packer.unpack(u), [-v for v in trace]
