"""Blackbody spectra and synthetic photometry.

Device kernels (`planck_lnu`, `bandflux_pointwise`, `bandflux_outer`) are pure
jax functions over fixed-shape arrays — the band integral is a weighted
reduction against :class:`~lightcurve_fitting_tpu.ops.filterbank.FilterBank`
quadrature (one fused elementwise+contraction instead of the reference's Python
loop over filters, models.py:1161-1164).

Host wrappers (`planck_fast`, `planck`, `blackbody_to_filters`) reproduce the
reference API including its broadcasting conventions (models.py:1105-1200).
"""

import numpy as np

import jax
import jax.numpy as jnp

from ..core.constants import c1, c2
from ..ops.mathx import planck_denom_inv
from ..ops.filterbank import FilterBank, bank_for

__all__ = ["planck_fast", "planck", "blackbody_to_filters",
           "planck_lnu", "bandflux_pointwise", "bandflux_outer"]


# ----------------------------------------------------------------- device side

def planck_lnu(nu, T, R, cutoff_freq=np.inf):
    """Spectral luminosity L_nu (W/Hz) of a blackbody; elementwise broadcast.

    nu in THz, T in kK, R in 1000 Rsun. ``T <= 0`` yields 0 (reference
    models.py:1105-1128 semantics). Stable in float32 via expm1 and
    works deep into the Wien tail (overflow -> 1/inf -> 0, no NaN).
    """
    x = c1 * nu * jnp.where(T > 0.0, 1.0 / jnp.where(T > 0.0, T, 1.0), 0.0)
    cut = jnp.minimum(1.0, cutoff_freq / nu)
    return c2 * R ** 2 * nu ** 3 * cut * planck_denom_inv(x)


def bandflux_pointwise(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0):
    """Band-averaged L_nu per photometry point.

    Parameters
    ----------
    nodes_emit : (N, K) emitted-frame frequency nodes (THz) per point
    weights : (N, K) quadrature weights (observed-frame measure)
    T, R : (..., N) blackbody parameters per point (walker axes lead)
    k_ext : (N, K) optional F99 A/E(B-V) at the nodes
    ebv : traced scalar E(B-V)

    Returns (..., N) band-averaged L_nu in W/Hz.

    The (..., N, K) Planck cube — the hot path — runs in
    ``core.config.compute_dtype`` when set (float32 on accelerators, ~1e-7
    relative error); time/parameter arithmetic stays in ambient precision.
    """
    from ..core import config
    out_dtype = jnp.result_type(T)
    dt = config.get_compute_dtype()
    if dt is not None:
        nodes_emit = nodes_emit.astype(dt)
        weights = weights.astype(dt)
        T = T.astype(dt)
        R = R.astype(dt)
    lnu = planck_lnu(nodes_emit, T[..., None], R[..., None], cutoff_freq)
    if k_ext is not None:
        ebv = jnp.asarray(ebv)
        if dt is not None:
            k_ext = k_ext.astype(dt)
            ebv = ebv.astype(dt)
        if ebv.ndim:                       # per-point E(B-V): (..., N) -> (..., N, 1)
            ebv = ebv[..., None]
        lnu = lnu * jnp.exp(k_ext * ebv * (-0.4 * jnp.log(10.0)))
    return jnp.sum(weights * lnu, axis=-1).astype(out_dtype)


def bandflux_outer(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0):
    """Band-averaged L_nu for all B bands at all T/R values.

    nodes_emit, weights: (B, K); T, R: any shape S. Returns (B,) + S.
    """
    T = jnp.asarray(T)
    R = jnp.asarray(R)
    sh = T.shape
    lnu = planck_lnu(nodes_emit[:, None, :], T.reshape(1, -1, 1), R.reshape(1, -1, 1),
                     cutoff_freq)  # (B, prod(S), K)
    if k_ext is not None:
        lnu = lnu * jnp.exp(k_ext[:, None, :] * jnp.asarray(ebv).reshape(1, -1, 1)
                            * (-0.4 * jnp.log(10.0)))
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    out = jnp.einsum("bsk,bk->bs", lnu, weights, precision=jax.lax.Precision.HIGHEST)
    return out.reshape((nodes_emit.shape[0],) + sh)


# ------------------------------------------------------------------- host side

def planck_fast(nu, T, R, cutoff_freq=np.inf):
    """The reference's ``planck_fast`` (models.py:1105-1128): outer-product
    broadcasting of (T, R) against nu, squeezed. Host numpy in/out."""
    nu = np.asarray(nu, float)
    T = np.asarray(T, float)
    R = np.asarray(R, float)
    lnu = planck_lnu(nu.reshape((1,) * T.ndim + nu.shape),
                     T.reshape(T.shape + (1,) * nu.ndim),
                     R.reshape(R.shape + (1,) * nu.ndim),
                     cutoff_freq)
    return np.squeeze(np.asarray(lnu))


def planck(nu, T, R, dT=0.0, dR=0.0, cov=0.0):
    """Blackbody L_nu with linear uncertainty propagation (reference
    models.py:1168-1200)."""
    Lnu = planck_fast(nu, T, R)
    if not np.any(dT) and not np.any(dR) and not np.any(cov):
        return Lnu
    dlogLdT = c1 * nu * T ** -2 / (1 - np.exp(-c1 * nu / T))
    dlogLdR = 2.0 / R
    dLnu = Lnu * (dlogLdT ** 2 * dT ** 2 + dlogLdR ** 2 * dR ** 2
                  + 2.0 * dlogLdT * dlogLdR * cov) ** 0.5
    return Lnu, dLnu


def blackbody_to_filters(filters, T, R, z=0.0, cutoff_freq=np.inf, ebv=0.0, n_nodes=None):
    """Band-averaged blackbody L_nu through one or more filters (reference
    models.py:1131-1165): pointwise mode when ``len(T) == len(filters)`` and T
    is 1-D, outer mode otherwise."""
    T = np.asarray(T, float)
    R = np.asarray(R, float)
    if T.shape != R.shape:
        raise Exception("T & R must have the same shape")
    np.broadcast(T, ebv)  # raises if not broadcastable, as in the reference
    filters = np.atleast_1d(filters)
    bank = bank_for(tuple(filters), n_nodes)
    ebv_arr = np.broadcast_to(np.asarray(ebv, float), T.shape) if np.ndim(ebv) else ebv
    if T.ndim == 1 and len(T) == len(filters):  # pointwise
        ids = bank.band_ids(filters)
        nodes, weights, k_ext = bank.gather(ids, z=z, device=False)
        y = bandflux_pointwise(jnp.asarray(nodes), jnp.asarray(weights),
                               jnp.asarray(T), jnp.asarray(R), cutoff_freq,
                               jnp.asarray(k_ext), jnp.asarray(ebv))
    else:
        nodes = jnp.asarray(bank.emitted_nodes(z))
        weights = jnp.asarray(bank.weights)
        k_ext = jnp.asarray(bank.ext_curve(z))
        y = bandflux_outer(nodes, weights, jnp.asarray(T), jnp.asarray(R),
                           cutoff_freq, k_ext,
                           jnp.asarray(ebv_arr if np.ndim(ebv) else ebv))
    return np.asarray(y)
