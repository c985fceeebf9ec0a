"""Precomputed band-luminosity tables: the speed-of-light path for blackbody
synthetic photometry.

For a blackbody, the band-averaged spectral luminosity factorizes exactly:

    <L_nu>_b(T, R) = R^2 * g_b(T),   g_b(T) = sum_k W[b,k] c2 nu_k^3 / expm1(c1 nu_k / T)

so the K-node quadrature only ever needs to be evaluated on a 1-D temperature
grid — once, at fit setup, in float64 on the host, using the *exact* native-grid
weights. On device, each (walker, point) evaluation is then a short Clenshaw
recurrence on static per-point coefficients plus one exp — elementwise work,
no gathers (a piecewise-cubic table needs per-element dynamic gathers; that
variant was implemented on an earlier accelerator target, found slower, and
removed — docs/design.md "Pallas decision"; it is untested on a GPU).

Static per fit: redshift and cutoff frequency are baked into the table.
Extinction is NOT: the table carries no E(B-V) input, so any model with
extinction in-graph — fixed or sampled (ShockCooling3) — must keep the full
quadrature path (``use_band_table = False``); a fixed E(B-V) could in
principle be folded into the quadrature weights before table construction,
but no current model needs it.
"""

import numpy as np
import jax.numpy as jnp

from ..core.constants import c1, c2
from ..core import config

__all__ = ["ChebyshevBandTable", "chebyshev_bandflux"]


class ChebyshevBandTable:
    """ln g_b(ln T) as one Chebyshev series per band, each over its own
    temperature range.

    The fit domain is where the band actually has signal: per band, the low
    edge ``T_lo_b`` is placed (by bisection on the exact quadrature) where the
    flux has fallen ``suppression`` e-folds below its value at ``T_max`` —
    blue optical bands get ~0.9 kK, JWST MIRI ~0.02 kK. That keeps the
    polynomial's dynamic range uniform across bands, so narrow bands reach
    |Delta ln g| < 1e-5 by degree 24 and even the broadband pseudobolometric
    filters by 32 (the former global [0.05, 500] kK domain needed degree 64
    for 7e-6). The degree is chosen *per table*: each band's fit is verified
    against the exact quadrature on a dense grid and the degree raised until
    the error is below ``tol``, then all bands pad to the maximum — the
    Clenshaw recurrence, which dominates the likelihood at large walker
    counts, runs at the smallest degree the requested bands actually need
    (deg 40 for the flagship set whose broadband pseudobolometric filter is
    the stiffest, deg 24 for griz-type sets: 40-60% of the old flops).

    Out-of-range temperatures clamp to the domain edge: below ``T_lo_b`` the
    returned flux is e^-46 of the hot-end value (indistinguishable from the
    true sub-range value at data scale), above ``T_max`` the Wien-end series
    value saturates — both match the reference's power() semantics of
    "unphysical proposals produce negligible/finite flux, never NaN".

    The per-point s-map is affine, ``s = a_n * ln T - b_n``, so per-band
    ranges cost one extra fused multiply-add per element over a global range.
    """

    DEGREES = (24, 32, 40, 48)

    def __init__(self, bank, z=0.0, cutoff_freq=np.inf, tol=1e-5, T_max=500.0,
                 suppression=46.0):
        self.bank = bank
        self.z = z
        self.cutoff_freq = cutoff_freq
        self.tol = float(tol)
        self.T_max = float(T_max)
        nodes = bank.emitted_nodes(z)
        weights = bank.weights
        factor = np.minimum(1.0, cutoff_freq / nodes)
        B = len(bank)

        def ln_g(T, b):
            """Exact quadrature ln g for ONE band at a vector of temperatures
            (sliced to the band so table setup stays O(B), not O(B^2) — setup
            cost recurs per distinct redshift in population fits)."""
            T = np.atleast_1d(np.asarray(T, float))
            nu, w, fac = nodes[b], weights[b], factor[b]
            with np.errstate(over="ignore"):
                x = c1 * nu / T[:, None]
                denom = np.expm1(x)
                integrand = np.where(denom > 0,
                                     c2 * nu ** 3 * fac
                                     / np.where(denom > 0, denom, 1.0), 0.0)
            return np.log(np.maximum(integrand @ w, 1e-300))

        # per-band low edge: ln g(T_lo) = ln g(T_max) - suppression, bisected
        # on the (monotone) Wien decline in log T
        T_lo = np.empty(B)
        for b in range(B):
            ln_hot = ln_g(self.T_max, b)[0]
            lo, hi = 1e-3, self.T_max
            for _ in range(50):
                mid = np.sqrt(lo * hi)
                if ln_g(mid, b)[0] < ln_hot - suppression:
                    lo = mid
                else:
                    hi = mid
            T_lo[b] = hi
        self.T_lo = T_lo

        log_lo = np.log(T_lo)
        log_hi = np.log(self.T_max)
        cheb = np.polynomial.chebyshev
        per_band = []
        self.fit_err = np.empty(B)
        n_fit = max(4 * self.DEGREES[-1], 512)
        for b in range(B):
            sg = np.linspace(-1.0, 1.0, 2001)           # dense verification grid
            y_true = ln_g(np.exp(log_lo[b] + (sg + 1) / 2 * (log_hi - log_lo[b])), b)
            # ONE quadrature evaluation of ln g on the fit nodes serves every
            # degree attempt (the escalation 24->...->48 re-fits, it does not
            # need to re-integrate; n_fit is degree-independent below 128)
            u = (log_lo[b] + log_hi) / 2 \
                + (log_hi - log_lo[b]) / 2 * np.cos(np.pi * np.arange(n_fit + 1) / n_fit)
            s = 2 * (u - log_lo[b]) / (log_hi - log_lo[b]) - 1
            y_fit = ln_g(np.exp(u), b)
            for deg in self.DEGREES:
                c = cheb.chebfit(s, y_fit, deg)
                err = np.max(np.abs(cheb.chebval(sg, c) - y_true))
                if err < self.tol or deg == self.DEGREES[-1]:
                    break
            per_band.append(c)
            self.fit_err[b] = err
        self.deg = max(len(c) - 1 for c in per_band)
        coef = np.zeros((B, self.deg + 1))
        for b, c in enumerate(per_band):
            coef[b, :len(c)] = c                        # pad to the table max
        self._coef = coef
        # affine s-map constants: s = s_a[b] * ln T - s_b[b]
        self._s_a = 2.0 / (log_hi - log_lo)
        self._s_b = self._s_a * log_lo + 1.0

    def gather(self, band_ids, device=True):
        """Per-point constants for :func:`chebyshev_bandflux`: coefficient
        rows (N, deg+1) and the affine s-map pair (N,), (N,) — a static
        gather at setup."""
        ids = np.asarray(band_ids)
        out = (self._coef[ids], self._s_a[ids], self._s_b[ids])
        return tuple(jnp.asarray(a) for a in out) if device else out

    def eval_points(self, gathered, T, R):
        """Band-averaged L_nu per point: ``gathered`` from :meth:`gather`,
        T/R shaped (..., N)."""
        coef_pt, s_a, s_b = gathered
        return chebyshev_bandflux(coef_pt, T, R, s_a, s_b)


def chebyshev_bandflux(coef_pt, T, R, s_a, s_b):
    """R^2 * exp(Chebyshev(ln T)) with Clenshaw recurrence; no dynamic gathers.

    coef_pt: (N, D+1) per-point Chebyshev coefficients of ln g_b.
    s_a, s_b: (N,) per-point affine map s = s_a ln T - s_b onto [-1, 1].
    T, R: (..., N). T <= 0 -> 0 (reference power() semantics); T outside the
    fitted range clamps (edges are ~e-46 of the in-band flux / the Wien-end
    series value).
    """
    out_dtype = jnp.result_type(T)
    dt = config.get_compute_dtype()
    if dt is not None:
        # all Clenshaw quantities are O(1)-O(1e2): float32-safe
        coef_pt = coef_pt.astype(dt)
        T = T.astype(dt)
        R = R.astype(dt)
        s_a = s_a.astype(dt)
        s_b = s_b.astype(dt)
    pos = T > 0.0
    logT = jnp.log(jnp.where(pos, T, 1.0))
    s = jnp.clip(logT * s_a - s_b, -1.0, 1.0)
    two_s = 2.0 * s
    D = coef_pt.shape[-1] - 1
    b1 = jnp.zeros_like(s)
    b2 = jnp.zeros_like(s)
    for k in range(D, 0, -1):
        b1, b2 = two_s * b1 - b2 + coef_pt[..., :, k], b1
    ln_g = s * b1 - b2 + coef_pt[..., :, 0]
    return jnp.where(pos, R * R * jnp.exp(ln_g), 0.0).astype(out_dtype)
