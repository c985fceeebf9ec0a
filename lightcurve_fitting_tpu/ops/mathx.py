"""Small numerics helpers shared by the model kernels.

These encode the reference's NaN-avoidance semantics (``models.py:42-48``:
power() returns 0 for nonpositive base) in a form that is also gradient-safe
under JAX (double-where pattern), enabling future HMC/NUTS samplers the
reference cannot support.
"""

import jax.numpy as jnp

__all__ = ["power", "safe_reciprocal", "planck_denom_inv", "hot", "hot_phase"]


def hot(*xs):
    """Cast values into the configured hot-path compute dtype (no-op when
    ``core.config.compute_dtype`` is None). Used by model kernels right after
    the epoch subtraction ``t - t_exp``: absolute MJDs need float64, but the
    elapsed times and physical parameters are O(1)-O(100) and run at the
    float32 rate."""
    from ..core import config
    dt = config.get_compute_dtype()
    if dt is None:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(jnp.asarray(x).astype(dt) for x in xs)
    return out if len(out) > 1 else out[0]


def hot_phase(t, t_exp):
    """Elapsed time ``t - t_exp`` in the hot-path dtype WITHOUT materializing
    a float64 (walkers, points) array.

    Absolute MJDs (~5.7e4) need float64 for a subtraction whose result is
    resolved to ~1e-4 d — but the f64 outer difference writes a 78 MB
    intermediate at 131k walkers. Centering both operands on a
    per-dataset epoch ``t_ref = floor(min t)`` first makes them O(10), where
    float32's 6e-8 relative error is ~0.1 s absolute — two orders below the
    tightest posterior width seen (15 s on the flagship t_0) — so the wide
    array math runs entirely in f32. ``t`` is a trace-time constant in the
    fit drivers, so the centering itself folds away at compile time."""
    from ..core import config
    dt = config.get_compute_dtype()
    t = jnp.asarray(t, jnp.result_type(float))
    if dt is None:
        return t - t_exp
    finite = jnp.isfinite(t)
    t_ref = jnp.floor(jnp.min(jnp.where(finite, t, jnp.inf)))
    t_ref = jnp.where(jnp.isfinite(t_ref), t_ref, 0.0)  # degenerate all-nonfinite t
    return (t - t_ref).astype(dt) - (jnp.asarray(t_exp) - t_ref).astype(dt)


def power(base, exp):
    """``base ** exp`` that returns 0 where ``base <= 0`` (reference
    models.py:42-48) without NaN gradients."""
    positive = base > 0.0
    safe_base = jnp.where(positive, base, 1.0)
    return jnp.where(positive, safe_base ** exp, 0.0)


def safe_reciprocal(x):
    """1/x that returns 0 where ``x <= 0`` (matches reference
    ``power(x, -1.)`` semantics)."""
    positive = x > 0.0
    return jnp.where(positive, 1.0 / jnp.where(positive, x, 1.0), 0.0)


def planck_denom_inv(x):
    """``1 / (exp(x) - 1)`` with the reference's convention that x <= 0 maps
    to 0 (reference models.py:1128 composes exp with safe power; a nonpositive
    temperature yields x = 0 there and hence zero luminosity).

    Uses expm1 so that float32 stays accurate in the Rayleigh-Jeans limit and
    overflows gracefully to 0 (1/inf) in the Wien tail instead of producing NaN.
    """
    return safe_reciprocal(jnp.expm1(x))
