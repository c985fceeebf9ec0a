"""Model base class: metadata, host evaluation API (reference-compatible
broadcasting), and the device-side pure-function contract used by the sampler.

Design (SURVEY.md §7): every concrete model implements one pure jax function,

    _eval_points(self, t, quad, *params) -> y (N,)

with *scalar* parameters, per-point times ``t`` (N,), and a ``quad`` pytree of
static per-point quadrature arrays built by :meth:`prepare_quad`. Batching over
walkers / posterior draws / epochs is ``jax.vmap`` around that single function —
the replacement for the reference's numpy outer-product broadcasting
(models.py:260,403,589,752) — and sharding wraps the vmap (see
``lightcurve_fitting_tpu.parallel``).
"""

import numpy as np
import jax
import jax.numpy as jnp


from ..ops.filterbank import FilterBank
from ..utils import units as u

__all__ = ["Model", "format_unit", "intrinsic_scatter_units"]


def intrinsic_scatter_units(dy, sigma_type, mask=None, xp=jnp, dt=None):
    """Units of the intrinsic-scatter parameter sigma (reference
    models.py:116-129): the per-point uncertainties for ``'relative'``, their
    median — over real (unmasked) points only — for ``'absolute'``.

    ONE definition shared by every likelihood kernel (single-LC, batched
    bolometric, population, population GOF) AND the SBC generative model:
    simulation-based calibration is only valid if the generator and the
    likelihood use the exact same convention. ``xp`` selects numpy (host) or
    jax.numpy (traced); ``dt`` optionally casts to the hot-path dtype."""
    if sigma_type == "relative":
        units = dy
    elif sigma_type == "absolute":
        units = (xp.median(dy) if mask is None
                 else xp.nanmedian(xp.where(mask, dy, xp.nan)))
    else:
        raise Exception('sigma_type must either be "relative" or "absolute"')
    return units if dt is None else units.astype(dt)


def format_unit(unit):
    """LaTeX-format a unit or an order-of-magnitude quantity
    (reference models.py:15-39)."""
    if isinstance(unit, u.Quantity):
        value = np.log10(unit.value)
        unit = unit.unit
        if value % 1.0:
            unit_str = "$10^{{{value:.1f}}}$ {unit:latex_inline}"
        else:
            unit_str = "$10^{{{value:.0f}}}$ {unit:latex_inline}"
    else:
        value = None
        unit_str = "{unit:latex_inline}"
    return unit_str.format(value=value, unit=unit)


class Model:
    """An analytical light-curve model (reference models.py:51-136)."""

    input_names = []
    units = []
    output_quantity = "lum"
    n_nodes = None  # FilterBank mode: None = exact native quadrature
    use_band_table = True
    """Blackbody band integrals via precomputed ln g_b(ln T) tables
    (ops/bandtable.py): ~50x fewer flops per likelihood with <1e-8 relative
    error. Set False on models whose band integral cannot factorize (sampled
    E(B-V)) or to force the full quadrature."""
    cutoff_freq = np.inf

    @property
    def nparams(self):
        return len(self.input_names)

    @property
    def axis_labels(self):
        return ["${}$ ({})".format(var, format_unit(unit))
                if unit is not u.dimensionless_unscaled else "${}$".format(var)
                for var, unit in zip(self.input_names, self.units)]

    def __init__(self, lc=None, redshift=0.0):
        if redshift:
            self.z = redshift
        elif lc is not None and "redshift" in lc.meta:
            self.z = lc.meta["redshift"]
        else:
            self.z = 0.0

    def _ctor_kwargs(self):
        """Subclass constructor options beyond (lc, redshift) that select
        the physics (e.g. ShockCooling's n/RW): subclasses record them in
        ``self._init_options`` so :meth:`clone_for` cannot silently drop
        them."""
        return dict(getattr(self, "_init_options", {}))

    def clone_for(self, lc):
        """A new instance of this model class bound to ``lc``, carrying the
        full physics configuration — including z = 0 (which the constructor
        treats as "unset" and would otherwise replace with
        ``lc.meta['redshift']``). Used by the SBC harness
        (``parallel/sbc.py``) to give every simulated light curve its own
        instance of the template model."""
        clone = type(self)(lc, redshift=self.z, **self._ctor_kwargs())
        clone.z = self.z
        return clone

    def __repr__(self):
        return f"<{self.__class__.__name__}: z={self.z:.3f}>"

    def __call__(self, *args, **kwargs):
        return self.evaluate(*args, **kwargs)

    # ------------------------------------------------------------ device side
    # banks/tables are pure functions of (filters, n_nodes[, z, cutoff]) and
    # are shared process-wide via ops.filterbank's cache: population fits
    # create one model per transient, and rebuilding identical quadrature per
    # instance dominated host time
    def bank_for(self, filters):
        from ..ops.filterbank import bank_for
        return bank_for(filters, n_nodes=self.n_nodes)

    def prepare_quad(self, filters, bank=None):
        """Build the static per-point quadrature pytree for an array of Filter
        objects (one entry per photometry point). Subclasses may extend.

        Entries are host numpy arrays: closed over by jitted functions they
        embed as compile-time constants (one transfer at compile), and packers
        stack them host-side rather than paying one device_put per item."""
        bank = bank or self.bank_for(sorted(set(filters)))
        ids = bank.band_ids(filters)
        if self.use_band_table:
            # Table path: ``_bandflux`` evaluates the Clenshaw recurrence and
            # never reads the raw quadrature, so nodes/weights/k_ext would be
            # dead weight — at population scale they dominated the payload
            # (3 x (n, 89) f64 per transient = 163 MB at S=512).
            quad = {"band_ids": ids}
            quad["bb_coeffs"], quad["bb_s_a"], quad["bb_s_b"] = \
                self.table_for(bank).gather(ids, device=False)
            return quad
        nodes, weights, k_ext = bank.gather(ids, z=self.z, device=False)
        return {"nodes": nodes, "weights": weights, "k_ext": k_ext,
                "band_ids": ids}

    def table_for(self, bank):
        from ..ops.filterbank import band_table_for
        return band_table_for(bank, z=self.z, cutoff_freq=self.cutoff_freq)

    prepare_quad_host = prepare_quad

    def _bandflux(self, quad, T, R):
        """Band-averaged blackbody L_nu per point: gather-free Chebyshev fast
        path when available, exact quadrature otherwise."""
        if "bb_coeffs" in quad:
            from ..ops.bandtable import chebyshev_bandflux
            return chebyshev_bandflux(quad["bb_coeffs"], T, R,
                                      quad["bb_s_a"], quad["bb_s_b"])
        from .blackbody import bandflux_pointwise
        return bandflux_pointwise(quad["nodes"], quad["weights"], T, R,
                                  cutoff_freq=self.cutoff_freq)

    def _eval_points(self, t, quad, *params):
        raise NotImplementedError

    # -------------------------------------------------------------- host side
    def evaluate(self, t_in, f, *params):
        """Reference-compatible evaluation: per-point when ``len(f) == len(t)``
        and parameters are scalars; otherwise an outer product over filters,
        times, and (optionally) parameter vectors, shaped (B, N[, W]) like the
        reference's broadcasting (fitting.py:350-352 relies on this)."""
        t_arr = np.atleast_1d(np.asarray(t_in, float))
        f_arr = np.atleast_1d(f)
        params = [np.asarray(p, float) for p in params]
        vector = any(p.ndim > 0 for p in params)

        if not vector and f_arr.shape == t_arr.shape and f_arr.ndim == 1 \
                and len(f_arr) == len(t_arr) and self._is_pointwise(t_arr, f_arr):
            quad = self.prepare_quad(f_arr)
            y = self._eval_points(jnp.asarray(t_arr), quad, *[jnp.asarray(p) for p in params])
            out = np.asarray(y)
            return out if np.ndim(t_in) else float(out[0])

        # outer mode: tile the time grid over bands
        B, N = len(f_arr), len(t_arr)
        f_tiled = np.repeat(f_arr, N)
        t_tiled = np.tile(t_arr, B)
        quad = self.prepare_quad(f_tiled)
        t_dev = jnp.asarray(t_tiled)
        if vector:
            W = max(p.shape[0] for p in params if p.ndim > 0)
            pcols = [jnp.asarray(np.broadcast_to(p, (W,))) for p in params]
            y = jax.vmap(lambda *pw: self._eval_points(t_dev, quad, *pw))(*pcols)  # (W, B*N)
            y = np.asarray(y).reshape(W, B, N).transpose(1, 2, 0)  # (B, N, W)
        else:
            y = np.asarray(self._eval_points(t_dev, quad, *[jnp.asarray(p) for p in params]))
            y = y.reshape(B, N)
        return np.squeeze(y) if np.ndim(t_in) == 0 else y

    def _is_pointwise(self, t_arr, f_arr):
        """Heuristic matching the reference's pointwise-vs-outer dispatch
        (models.py:1161): same length and scalar params means pointwise."""
        return True

    # -------------------------------------------------------------- likelihood
    def log_likelihood(self, lc, p, use_sigma=False, sigma_type="relative"):
        """Host-side log-likelihood, identical formula to reference
        models.py:93-136 (Gaussian with optional intrinsic-scatter parameter).

        1-D ``p`` returns a float; extra trailing dimensions of ``p`` return
        an array of that shape (one likelihood per parameter set, vmapped in
        one device call — the behavior the reference *documents*; its numpy
        implementation pools the sum over all sets instead)."""
        f = np.asarray(lc["filter"])
        t = np.asarray(lc["MJD"], float)
        y = np.asarray(lc[self.output_quantity], float)
        dy = np.asarray(lc["d" + self.output_quantity], float)
        ll_fn = self.make_log_likelihood_arrays(t, f, y, dy, use_sigma, sigma_type)
        p = np.asarray(p, float)
        if p.ndim == 1:
            return float(ll_fn(jnp.asarray(p)))
        flat = p.reshape(p.shape[0], -1).T                    # (W, nparams)
        vals = jax.vmap(ll_fn)(jnp.asarray(flat))
        return np.asarray(vals).reshape(p.shape[1:])

    def _normalized_data(self, y, dy, sigma_type="relative"):
        """O(1) data normalization shared by the likelihood and the
        goodness-of-fit diagnostic: the hot path may run in float32
        (core.config), so raw flux units (~1e-30 W/m^2/Hz) or
        luminosities (~1e13 W/Hz) must not appear squared or logged.

        Returns host-numpy ``(yscale, y/yscale, dy/yscale, sigma_units)``
        where ``sigma_units`` is the per-point (or scalar, for
        sigma_type='absolute') unit of the intrinsic-scatter parameter
        (reference models.py:116-129)."""
        y = np.asarray(y, float)
        dy = np.asarray(dy, float)
        yscale = float(np.median(np.abs(y[y != 0]))) if np.any(y != 0) else 1.0
        sigma_units = intrinsic_scatter_units(dy / yscale, sigma_type, xp=np)
        return yscale, y / yscale, dy / yscale, sigma_units

    def make_log_likelihood_arrays(self, t, f, y, dy, use_sigma=False, sigma_type="relative"):
        """Build a pure jax ``fn(p_vector) -> scalar`` log-likelihood over the
        given photometry arrays. This is the function the sampler vmaps over
        walkers (the reference evaluates it serially 2e5 times, fitting.py:133)."""
        # the log-likelihood changes by the constant -N log(yscale) under the
        # data normalization, which is added back
        y = np.asarray(y, float)
        dy = np.asarray(dy, float)
        yscale, y_n, dy_n, sigma_units_np = self._normalized_data(y, dy, sigma_type)
        offset = -len(y) * np.log(yscale)
        inv_yscale = 1.0 / yscale

        from ..core import config
        dt = config.get_compute_dtype()

        sigma_units = jnp.asarray(sigma_units_np, dtype=dt)

        quad = self.prepare_quad(f)
        t_dev = jnp.asarray(np.asarray(t, float))
        # residual arithmetic runs in the hot-path dtype: everything is O(1)
        # after the yscale normalization, and f32 residual noise (~1e-7) is far
        # below MC noise in the acceptance ratio
        y_dev = jnp.asarray(y_n, dtype=dt)
        inv_dy = jnp.asarray(1.0 / dy_n, dtype=dt)
        dy_dev = jnp.asarray(dy_n, dtype=dt)
        # the Gaussian normalization term is a constant when sigma is fixed:
        # hoist it to the host (float64, exact)
        log_norm_const = float(-0.5 * np.sum(np.log(2 * np.pi * dy_n ** 2)) + offset)

        def ll(p):
            n_model = p.shape[0] - (1 if use_sigma else 0)  # static under jit
            y_fit = self._eval_points(t_dev, quad, *[p[i] for i in range(n_model)])
            y_fit = y_fit.astype(y_dev.dtype) * y_dev.dtype.type(inv_yscale)
            if use_sigma:
                sig = p[-1].astype(y_dev.dtype)
                sigma2 = dy_dev ** 2.0 + (sig * sigma_units) ** 2.0
                return (-0.5 * jnp.sum(jnp.log(2 * jnp.pi * sigma2)
                                       + (y_dev - y_fit) ** 2.0 / sigma2) + offset)
            r = (y_dev - y_fit) * inv_dy
            return -0.5 * jnp.sum(r * r) + log_norm_const

        return ll

    def make_log_likelihood(self, lc, use_sigma=False, sigma_type="relative"):
        f = np.asarray(lc["filter"])
        t = np.asarray(lc["MJD"], float)
        y = np.asarray(lc[self.output_quantity], float)
        dy = np.asarray(lc["d" + self.output_quantity], float)
        return self.make_log_likelihood_arrays(t, f, y, dy, use_sigma, sigma_type)
