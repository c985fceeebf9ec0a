"""Batched gradient optimization: many independent starts in one jitted scan.

Batched device execution makes multi-start optimization nearly free: S
starting points share one compiled Adam update (the per-start state is just a
batch axis), so a 64-start mode search costs about the wall-clock of one start.
This backs :func:`~lightcurve_fitting_tpu.fitting.lightcurve_map` — instant
MAP point estimates with Laplace uncertainties, a capability the reference has
only for the blackbody SED (`scipy.optimize.curve_fit`, reference
bolometric.py:483-534) and not for light-curve models at all.
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["multistart_maximize", "laplace_covariance"]


def multistart_maximize(log_prob_fn, u0, n_iter=1000, learning_rate=0.05):
    """Maximize ``log_prob_fn(u[ndim]) -> float`` from every row of ``u0``
    at once (vmapped value-and-grad inside one ``lax.scan`` of Adam with
    cosine-decayed step size).

    Non-finite gradients are zeroed per start, so a start that wanders into a
    -inf plateau stalls without poisoning the batch.

    Returns ``(u_final, logp_final)`` with shapes ``(S, ndim)`` and ``(S,)``.
    """
    import optax

    u0 = jnp.atleast_2d(jnp.asarray(u0))
    schedule = optax.cosine_decay_schedule(learning_rate, n_iter, alpha=0.01)
    opt = optax.adam(schedule)
    value_and_grad = jax.vmap(jax.value_and_grad(lambda u: -log_prob_fn(u)))

    @jax.jit
    def run(u):
        def step(carry, _):
            u, state = carry
            _, g = value_and_grad(u)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            updates, state = opt.update(g, state, u)
            return (optax.apply_updates(u, updates), state), None

        (u, _), _ = jax.lax.scan(step, (u, opt.init(u)), None, length=n_iter)
        return u, jax.vmap(log_prob_fn)(u)

    return run(u0)


def laplace_covariance(log_prob_fn, x_map, free=None):
    """Covariance of the Laplace (quadratic) approximation at a mode:
    ``inv(-hessian(log_prob))``.

    ``free`` is a boolean mask of parameters to treat as varying; parameters
    outside it (e.g. pinned against a prior bound, where the x-space gradient
    need not vanish and the full-space quadratic model is wrong) get zero
    rows/columns — the free block is the curvature *conditional on* the
    pinned values.

    Returns ``(cov, ok)``; ``ok`` is False when the free-block negative
    Hessian is not positive definite (a ridge saddle from imperfect
    convergence) — eigenvalues are then clipped to keep the result usable as
    a draw covariance, so the diagonal is order-of-magnitude only."""
    ndim = len(np.asarray(x_map))
    if free is None:
        free = np.ones(ndim, bool)
    cov = np.zeros((ndim, ndim))
    if not free.any():
        return cov, False
    H = np.asarray(jax.hessian(log_prob_fn)(jnp.asarray(x_map)))
    A = -0.5 * (H + H.T)  # symmetrize: tiny AD asymmetry breaks cholesky
    A = A[np.ix_(free, free)]
    try:
        np.linalg.cholesky(A)
        cov[np.ix_(free, free)] = np.linalg.inv(A)
        return cov, True
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(A)
        w = np.maximum(w, 1e-12 * np.abs(w).max())
        cov[np.ix_(free, free)] = (V / w) @ V.T
        return cov, False
