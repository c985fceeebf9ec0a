"""Device-side filter bank: fixed-length band quadrature for synthetic photometry.

The reference integrates every band on its native transmission grid inside a
Python loop over filters (filters.py:288-310, models.py:1161-1164) — ragged,
object-based, and host-bound. Here we instead resample every band's
normalized transmission onto K uniform frequency nodes at bank-construction
time, so the band average of any spectrum becomes a fixed-shape weighted
reduction:

    <L_nu>_b = sum_k W[b, k] * L_nu(nu[b, k])      with  sum_k W[b, k] ~= 1

Batched over walkers/epochs/times this is a single fused elementwise+reduction
(or a matrix product when the spectrum factorizes), with no ragged shapes and no
recompilation across bands.
"""

import numpy as np
import jax.numpy as jnp

from ..core.constants import C_AA_THZ
from .extinction import f99_curve

__all__ = ["FilterBank", "bank_for", "band_table_for"]


def _trapezoid_dx(x):
    """Composite-trapezoid weights for nodes ``x``: integral f dx ~= sum(w*f)."""
    dx = np.empty_like(x)
    dx[1:-1] = 0.5 * (x[2:] - x[:-2])
    dx[0] = 0.5 * (x[1] - x[0])
    dx[-1] = 0.5 * (x[-1] - x[-2])
    return dx


class FilterBank:
    """Packs a list of :class:`~lightcurve_fitting_tpu.filters.Filter` objects
    into dense quadrature arrays.

    Attributes
    ----------
    filters : tuple of Filter
    nodes : (B, K) observed-frame frequency nodes in THz, ascending
        (padded bands repeat their last node)
    weights : (B, K) quadrature weights of the normalized per-frequency
        transmission; ``weights.sum(1) == 1`` up to quadrature error
        (exactly, in native mode); padding entries have zero weight

    Modes
    -----
    ``n_nodes=None`` (default): each band keeps its *native* grid, padded with
    zero-weight nodes to the bank-wide maximum K — the band integral then
    reproduces the reference's native-grid trapezoid bit-for-bit.
    ``n_nodes=int``: every band is resampled to that many uniform frequency
    nodes — smaller/faster, with O(1e-3) relative quadrature differences.
    """

    def __init__(self, filters, n_nodes=None, dtype=np.float64):
        filters = tuple(filters)
        for f in filters:
            if f.trans is None:
                raise ValueError(f"filter {f.name} has no transmission curve; "
                                 "it cannot be used for synthetic photometry")
        self.filters = filters
        self._index = {f: i for i, f in enumerate(filters)}

        per_band = []
        for f in filters:
            trans = f.trans
            wl = np.asarray(trans["wl"], float)        # nm, ascending
            T = np.asarray(trans["T"], float)
            freq = C_AA_THZ / 10.0 / wl                # THz, descending
            # normalized per-frequency transmission, positive orientation
            T_per_freq = T / freq
            norm = -np.trapezoid(T_per_freq, freq)     # freq descending -> flip sign
            fgrid = freq[::-1].copy()
            tgrid = (T_per_freq / norm)[::-1].copy()
            if n_nodes is None:
                nu, tq = fgrid, tgrid
                w = tq * _trapezoid_dx(nu)
            else:
                nu = np.linspace(fgrid[0], fgrid[-1], int(n_nodes))
                tq = np.interp(nu, fgrid, tgrid)
                dnu = nu[1] - nu[0]
                w = tq * dnu
                w[0] *= 0.5
                w[-1] *= 0.5
            per_band.append((nu, w))

        K = max(len(nu) for nu, _ in per_band)
        self.n_nodes = K
        B = len(filters)
        nodes = np.empty((B, K))
        weights = np.zeros((B, K))
        for b, (nu, w) in enumerate(per_band):
            nodes[b, :len(nu)] = nu
            nodes[b, len(nu):] = nu[-1]  # harmless padding (zero weight)
            weights[b, :len(w)] = w
        self.nodes = nodes.astype(dtype)
        self.weights = weights.astype(dtype)

    def __len__(self):
        return len(self.filters)

    def index(self, filt):
        return self._index[filt]

    def band_ids(self, filter_column):
        """Map an array of Filter objects to integer band ids."""
        return np.array([self._index[f] for f in filter_column], np.int32)

    def emitted_nodes(self, z=0.0):
        """Frequency nodes in the emitting frame: nu_obs * (1+z)."""
        return self.nodes * (1.0 + z)

    def ext_curve(self, z=0.0, rv=3.1):
        """F99 A(lambda)/E(B-V) evaluated at the emitted-frame nodes, (B, K).

        Static per fit (z and R_V are never traced), so the only in-graph
        extinction work is ``exp(-0.921 * ebv * k)`` with traced ``ebv``.
        Cached per (z, rv): this is host work repeated across quad preps."""
        key = (z, rv)
        if not hasattr(self, "_ext_cache"):
            self._ext_cache = {}
        if key not in self._ext_cache:
            nu_emit = self.emitted_nodes(z)
            self._ext_cache[key] = f99_curve(C_AA_THZ / nu_emit.ravel(), rv).reshape(nu_emit.shape)
        return self._ext_cache[key]

    def gather(self, band_ids, z=0.0, rv=3.1, device=True):
        """Per-point quadrature arrays for a photometry table.

        Returns (nodes_emit[N, K], weights[N, K], k_ext[N, K]) gathered by
        ``band_ids``; jnp arrays if ``device`` (static constants under jit).
        """
        band_ids = np.asarray(band_ids)
        nodes_emit = self.emitted_nodes(z)[band_ids]
        weights = self.weights[band_ids]
        k_ext = self.ext_curve(z, rv)[band_ids]
        if device:
            return jnp.asarray(nodes_emit), jnp.asarray(weights), jnp.asarray(k_ext)
        return nodes_emit, weights, k_ext


# ----------------------------------------------------------- process-wide cache
# Banks and Chebyshev band tables are pure functions of
# (filters, n_nodes[, z, cutoff_freq]) and are expensive to build relative to
# the device compute they feed (a population fit rebuilding identical
# quadrature per transient spent far longer packing than computing). ONE
# process-wide cache serves every consumer — Model.bank_for/table_for,
# blackbody_to_filters, and the per-epoch SED posteriors in bolometric.py —
# so the same filter set never builds its quadrature or table twice.
_SHARED_CACHE = {}


def bank_for(filters, n_nodes=None):
    """Cached :class:`FilterBank` for a filter tuple (order-sensitive)."""
    key = (tuple(filters), n_nodes)
    if key not in _SHARED_CACHE:
        _SHARED_CACHE[key] = FilterBank(list(key[0]), n_nodes=n_nodes)
    return _SHARED_CACHE[key]


def band_table_for(bank, z=0.0, cutoff_freq=np.inf):
    """Cached Chebyshev band table for ``bank`` at (z, cutoff_freq)."""
    from .bandtable import ChebyshevBandTable
    key = ("table", tuple(bank.filters), bank.n_nodes, float(z), float(cutoff_freq))
    if key not in _SHARED_CACHE:
        _SHARED_CACHE[key] = ChebyshevBandTable(bank, z=z, cutoff_freq=cutoff_freq)
    return _SHARED_CACHE[key]
