"""Device percentiles of float32 data without XLA sort.

``jnp.percentile`` lowers to a full XLA sort of every batch row. For the
fixed handful of quantiles the summary paths need (16/50/84), exact order
statistics can instead be found by **counting bisection** on the
order-isomorphic int32 view of the float32 data: 32 passes, each a fused
compare+reduce at memory bandwidth, all (batch, quantile) searches
advancing in parallel. Order statistics are bit-identical to a sort of the
same float32 data, and the linear interpolation is done in float64.

Which wins depends on the row length. On one NVIDIA H100 80GB HBM3
(power limit 700 W, JAX 0.9.0; ``tools/population_summary_ab.py``) at the
S=512 population summary shape (512 x 64000 x 4 float32 walker-state
chains, reduce axis 1): counting bisection 13.7 ms, ``jnp.percentile``
51.9 ms (median of 7), and the whole ``fit_population`` call 0.292 s
against 0.342 s (median of 8). At the batched-bolometric shape
(256 x 4 x 3200, reduce axis 2; random data, 400 W) the sort won, 0.52 ms
against 0.76 ms, so ``parallel.batched`` calls ``jnp.percentile``
directly.

IEEE-754 key map (total order, -0.0 < +0.0, NaNs above +inf):
``i = bitcast_int32(x); key = i < 0 ? ~i ^ INT32_MIN : i``.

The search is one jitted function, compiled once per (shape, q, axis).
Called un-jitted, its 32-pass loop was traced and compiled again on every
call: 0.41 s a call at the S=512 shape on the same card, which made the
whole fit slower than with the sort.

Used by ``parallel.population.fit_population(summaries=True)``. The
reference has no device analog (its summaries are numpy percentiles over host
chains, bolometric.py:786-798).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["percentile_f32"]

_I32_MIN = np.int32(-2147483648)


def _sortable_key(a32):
    """Order-isomorphic int32 view of a float32 array."""
    i = jax.lax.bitcast_convert_type(a32, jnp.int32)
    return jnp.where(i < 0, (~i) ^ _I32_MIN, i)


def _key_to_f32(k):
    back = jnp.where(k < 0, ~(k ^ _I32_MIN), k)
    return jax.lax.bitcast_convert_type(back, jnp.float32)


def percentile_f32(a, q, axis=-1):
    """Exact linear-interpolation percentiles along ``axis``.

    Float32 input runs the sort-free counting-bisection path; any other
    dtype falls back to ``jnp.percentile`` (float64 chains come from the
    CPU's absolute-float64 walker state, where the sort is the right
    tool).

    Matches ``jnp.percentile(a, q, axis)`` semantics for finite data:
    result shape ``(len(q),) + batch_shape``, linear interpolation between
    the bracketing order statistics (computed in float64 when x64 is
    enabled). NaN inputs are NOT propagated the numpy way (they sort above
    +inf instead) — callers guarantee finite chains. Sub-normal float32
    values (|x| < 1.18e-38) rank correctly but may flush to zero in the
    returned interpolation (XLA converts denormals-as-zero) — consistent
    with the package-wide float32 numeric contract, which already excludes
    magnitudes below ~1e-38 (see core.constants).
    """
    a = jnp.asarray(a)
    q = tuple(float(v) for v in np.atleast_1d(np.asarray(q, np.float64)))
    if a.dtype != jnp.float32:
        return jnp.percentile(a, jnp.asarray(q, a.dtype), axis=axis)
    return _bisect(a, q, axis % a.ndim)


def _bisect_impl(a, q, axis):
    """The counting bisection of :func:`percentile_f32`: float32 ``a``,
    ``q`` a tuple of percentiles, ``axis`` non-negative."""
    q_arr = np.asarray(q, np.float64)
    a = jnp.moveaxis(a, axis, -1)
    batch_shape = a.shape[:-1]
    N = a.shape[-1]
    Q = len(q_arr)
    out_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if N == 0:
        return jnp.full((Q,) + batch_shape, jnp.nan, out_dtype)

    key = _sortable_key(a).reshape((-1, N))                      # (B, N)
    B = key.shape[0]
    h = (N - 1) * q_arr / 100.0
    lo_rank = np.floor(h).astype(np.int64)
    hi_rank = np.ceil(h).astype(np.int64)
    frac = jnp.asarray(h - np.floor(h), out_dtype)               # (Q,)
    # 0-indexed target ranks, low then high bracket: (2Q,)
    ranks = jnp.asarray(np.concatenate([lo_rank, hi_rank]), jnp.int32)

    lo0 = jnp.full((B, 2 * Q), _I32_MIN, jnp.int32)
    hi0 = jnp.full((B, 2 * Q), np.int32(2147483647), jnp.int32)

    def body(_, carry):
        lo, hi = carry
        # overflow-free floor((lo + hi) / 2) in int32
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = jnp.sum((key[:, None, :] <= mid[:, :, None]),
                      axis=-1, dtype=jnp.int32)                  # (B, 2Q)
        # the rank-th order statistic is the smallest v with
        # count(key <= v) >= rank + 1
        take_hi = cnt >= ranks[None, :] + 1
        return (jnp.where(take_hi, lo, mid + 1),
                jnp.where(take_hi, mid, hi))

    lo, _ = jax.lax.fori_loop(0, 32, body, (lo0, hi0))
    vals = _key_to_f32(lo).astype(out_dtype)                     # (B, 2Q)
    v_lo, v_hi = vals[:, :Q], vals[:, Q:]
    out = v_lo + frac[None, :] * (v_hi - v_lo)                   # (B, Q)
    return jnp.moveaxis(out.reshape(batch_shape + (Q,)), -1, 0)


_bisect = functools.partial(jax.jit, static_argnums=(1, 2))(_bisect_impl)
