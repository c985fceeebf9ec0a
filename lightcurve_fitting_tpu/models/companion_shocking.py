"""Companion-shocking models: Kasen (2010) shock + SiFTO SN Ia template
(Conley et al. 2008), as combined by Hosseinzadeh et al. (2017).
Reference: models.py:660-1045.

Accelerator design: the per-filter SiFTO cubic splines (reference models.py:717 uses
scipy CubicSpline) are precomputed host-side at model construction into
piecewise-polynomial coefficient arrays; device evaluation is a per-point
coefficient gather + polynomial (no Python loop over filters), with the
per-band special cases (DLT40/unfiltered -> r template, U/i time shifts and
scale factors, reference models.py:701-717,786-827,913-916) baked into static
per-point masks.
"""

import os

import numpy as np
import jax.numpy as jnp

from ..ops.interpolate import notaknot_cubic_coeffs
from ..ops.mathx import power, hot, hot_phase
from ..utils import units as u
from ..utils.table import Table
from .base import Model

from ..filters import filtdict

__all__ = ["BaseCompanionShocking", "CompanionShocking", "CompanionShocking2",
           "CompanionShocking3", "sifto", "M_chandra"]

_SIFTO_FILE = os.path.join(os.path.dirname(__file__), "..", "data", "sifto.npz")
sifto_filename = _SIFTO_FILE  # reference models.py:660 exposes this name


def _load_sifto():
    data = np.load(_SIFTO_FILE, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    tab = Table([data["table"][:, i] for i in range(len(names))], names=names)
    return tab[3:]  # the first three points are ~0 (reference models.py:661)


sifto = _load_sifto()
M_chandra = u.def_unit("M_chandra", 1.4 * u.Quantity(1.0, u.Msun), format={"latex": "M_\\mathrm{Ch}"})


def _ppoly_batched(knots, c_pt, xq):
    """Evaluate per-point piecewise cubics: knots (S,), c_pt (N, 4, S-1),
    xq (N,). NaN outside the domain (scipy extrapolate=False)."""
    knots = jnp.asarray(knots)  # quads carry numpy; traced indices need jnp
    c_pt = jnp.asarray(c_pt)
    idx = jnp.clip(jnp.searchsorted(knots, xq, side="right") - 1, 0, knots.shape[0] - 2)
    t = xq - knots[idx]
    n_idx = jnp.arange(c_pt.shape[0])
    c0 = c_pt[n_idx, 0, idx]
    c1 = c_pt[n_idx, 1, idx]
    c2 = c_pt[n_idx, 2, idx]
    c3 = c_pt[n_idx, 3, idx]
    val = ((c0 * t + c1) * t + c2) * t + c3
    outside = (xq < knots[0]) | (xq > knots[-1])
    return jnp.where(outside, jnp.nan, val)


class BaseCompanionShocking(Model):
    """Kasen (2010) shock + scaled/stretched SiFTO template (reference
    models.py:665-845)."""

    def __init__(self, lc, redshift=0.0, kappa=1.0):
        super().__init__(lc, redshift=redshift)
        self._init_options = {"kappa": kappa}
        #: opacity in units of the electron-scattering 0.34 cm^2/g, threaded
        #: through the device Kasen component (the reference only accepts
        #: kappa per evaluate() call, models.py:731-784)
        self.kappa = float(kappa)
        if "lum" not in lc.colnames:
            if "absmag" not in lc.colnames:
                lc.calcAbsMag()
            lc.calcLum()

        self.sifto = {}          # Filter -> host spline-eval callable
        self._sifto_coeffs = {}  # Filter -> (4, S-1) scaled ppoly coefficients
        self._epochs = np.asarray(sifto["Epoch"], float)
        for filt in set(lc["filter"]):
            # unfiltered data are scaled like DLT40 (r template); see
            # reference models.py:701-714
            if filt.name == "unfilt." and filtdict["DLT40"] in lc["filter"]:
                sifto_filt = "r"
                scale_filt = "DLT40"
            elif filt.name == "DLT40":
                sifto_filt = "r"
                scale_filt = filt
            elif filt.char in sifto.colnames:
                sifto_filt = filt.char
                scale_filt = filt
            else:
                raise Exception("No SiFTO template for filter " + filt.name)
            lc_filt = lc.where(filter=scale_filt)
            template = np.asarray(sifto[sifto_filt], float)
            # mask-respecting max (reference models.py:706): np.asarray would
            # expose fill values under masked rows (e.g. nondetections)
            lum_max = np.ma.max(np.ma.MaskedArray(lc_filt["lum"]).astype(float))
            scaled = template * float(lum_max) / np.max(template)
            coeffs = notaknot_cubic_coeffs(self._epochs, scaled)
            self._sifto_coeffs[filt] = coeffs
            self.sifto[filt] = _HostSpline(self._epochs, coeffs)

    def __repr__(self):
        return f"<{self.__class__.__name__}: z={self.z:.3f}>"

    # ------------------------------------------------------------ components
    @staticmethod
    def temperature_radius(t_in, t_exp, a13, Mc_v9_7, kappa=1.0):
        """Kasen 2010 shock temperature/radius power laws (reference
        models.py:726-755)."""
        t = jnp.reshape(jnp.asarray(t_in, float), (-1, 1)) - t_exp
        T_kasen = jnp.squeeze(25.0 * power(a13 ** 36.0 * Mc_v9_7 * kappa ** -35.0
                                           * power(t, -74.0), 1.0 / 144.0))  # kK
        R_kasen = jnp.squeeze(2.7 * power(kappa * Mc_v9_7 * t ** 7.0, 1.0 / 9.0))  # kiloRsun
        return T_kasen, R_kasen

    @staticmethod
    def _tr_points(t, t_exp, a13, Mc_v9_7, kappa=1.0):
        tt = hot_phase(t, t_exp)
        tt, a13, Mc_v9_7, kappa = hot(tt, a13, Mc_v9_7, kappa)
        T_kasen = 25.0 * power(a13 ** 36.0 * Mc_v9_7 * kappa ** -35.0 * power(tt, -74.0),
                               1.0 / 144.0)
        R_kasen = 2.7 * power(kappa * Mc_v9_7 * tt ** 7.0, 1.0 / 9.0)
        return T_kasen, R_kasen

    def companion_shocking(self, t_in, f, t_exp, a13, Mc_v9_7, kappa=None):
        """Shock component only, host API (reference models.py:757-784).
        ``kappa`` defaults to the constructor-bound opacity so component
        curves match a kappa-bound fit."""
        from .blackbody import blackbody_to_filters
        if kappa is None:
            kappa = getattr(self, "kappa", 1.0)
        T_kasen, R_kasen = self.temperature_radius(np.asarray(t_in, float), t_exp, a13, Mc_v9_7, kappa)
        return blackbody_to_filters(f, np.asarray(T_kasen), np.asarray(R_kasen), self.z)

    def stretched_sifto(self, t_in, f, t_peak, stretch, dtU=None, dti=None):
        """SiFTO template, offset and stretched; U/i may get extra time shifts.
        Host API with the reference's three broadcasting modes
        (models.py:786-827); extrapolation is zero."""
        from ..ops.interpolate import ppoly_eval_np
        dt_peak = {}
        if dtU is not None:
            dt_peak[filtdict["U"]] = dtU
        if dti is not None:
            dt_peak[filtdict["i"]] = dti
        t_wrt_peak = np.squeeze(np.reshape(np.asarray(t_in, float), (-1, 1)) - t_peak)
        f = np.atleast_1d(f)

        def ev(filt, arg):
            return ppoly_eval_np(self._epochs, self._sifto_coeffs[filt], arg, extrapolate="nan")

        if t_wrt_peak.ndim <= 1 and t_wrt_peak.shape == (len(f),):
            # pointwise (per reference mode 1: vector stretch broadcasts each
            # point's epoch over the stretch draws, returning (N, W))
            Lnu_sifto = np.array([ev(filt, (t - dt_peak.get(filt, 0.0)) / stretch)
                                  for t, filt in zip(np.atleast_1d(t_wrt_peak), f)])
        elif t_wrt_peak.ndim <= 1:
            Lnu_sifto = np.array([ev(filt, (t_wrt_peak - dt_peak.get(filt, 0.0)) / stretch)
                                  for filt in f])
        else:
            stretch = np.asarray(stretch, float)
            Lnu_sifto = np.array([
                np.transpose([ev(filt, (t - dt) / s) for t, dt, s in
                              zip(t_wrt_peak.T, np.broadcast_to(
                                  dt_peak.get(filt, np.zeros_like(stretch)), stretch.shape),
                                  stretch)])
                for filt in f])
        Lnu_sifto = np.asarray(Lnu_sifto, float)
        Lnu_sifto[np.isnan(Lnu_sifto)] = 0.0
        return Lnu_sifto

    # --------------------------------------------------------- device pieces
    def prepare_quad(self, filters, bank=None):
        quad = super().prepare_quad(filters, bank)
        coeffs = np.stack([self._sifto_coeffs[f] for f in filters])  # (N, 4, S-1)
        quad["sifto_c"] = coeffs
        quad["sifto_knots"] = self._epochs
        chars = np.array([f.char for f in filters])
        quad["is_U"] = chars == "U"
        quad["is_i"] = chars == "i"
        quad["is_r"] = chars == "r"
        return quad

    def _sifto_points(self, t, quad, t_peak, stretch, dtU=None, dti=None):
        ph = hot_phase(t, t_peak)   # f32-centered template phase on device
        dt = jnp.zeros_like(ph)
        if dtU is not None:
            dt = jnp.where(quad["is_U"], jnp.asarray(dtU).astype(ph.dtype), dt)
        if dti is not None:
            dt = jnp.where(quad["is_i"], jnp.asarray(dti).astype(ph.dtype), dt)
        arg = (ph - dt) / jnp.asarray(stretch).astype(ph.dtype)
        val = _ppoly_batched(quad["sifto_knots"], quad["sifto_c"], arg)
        return jnp.nan_to_num(val, nan=0.0)

    def _kasen_points(self, t, quad, t_exp, a13, Mc_v9_7, kappa=None):
        if kappa is None:
            kappa = self.kappa
        T_kasen, R_kasen = self._tr_points(t, t_exp, a13, Mc_v9_7, kappa)
        return self._bandflux(quad, T_kasen, R_kasen)

    # ----------------------------------------------------------- validity
    @staticmethod
    def t_min(p):
        return p[3] + p[4] * float(np.min(np.asarray(sifto["Epoch"])))

    @staticmethod
    def t_max(p):
        return p[3] + p[4] * float(np.max(np.asarray(sifto["Epoch"])))


class _HostSpline:
    """Host-side callable mirroring scipy CubicSpline(extrapolate=False)."""

    def __init__(self, knots, coeffs):
        self._knots = knots
        self._coeffs = coeffs

    def __call__(self, x):
        from ..ops.interpolate import ppoly_eval_np
        return ppoly_eval_np(self._knots, self._coeffs, np.asarray(x, float), extrapolate="nan")


class CompanionShocking(BaseCompanionShocking):
    """Kasen + SiFTO with scale factors on the r and i SiFTO components and on
    the U shock component (reference models.py:848-918)."""

    input_names = ["t_0", "a", "M v^7", "t_\\mathrm{max}", "s", "r_r", "r_i", "r_U"]
    units = [u.d, 10.0 ** 13.0 * u.cm, M_chandra * (1e9 * u.cm / u.s) ** 7, u.d,
             u.dimensionless_unscaled, u.dimensionless_unscaled,
             u.dimensionless_unscaled, u.dimensionless_unscaled]

    def evaluate(self, t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                 rr=1.0, ri=1.0, rU=1.0, kappa=None):
        # kappa rides the device Kasen component as an ordinary traced
        # parameter (reference models.py:876-918 signature; no host fallback)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                                rr, ri, rU, kappa)

    def _eval_points(self, t, quad, t_exp, a13, Mc_v9_7, t_peak, stretch,
                     rr=1.0, ri=1.0, rU=1.0, kappa=None):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, Mc_v9_7, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch)
        kasen_fac = jnp.where(quad["is_U"], rU, 1.0)
        sifto_fac = jnp.where(quad["is_r"], rr, jnp.where(quad["is_i"], ri, 1.0))
        return Lnu_kasen * kasen_fac + Lnu_sifto * sifto_fac


class CompanionShocking2(BaseCompanionShocking):
    """Kasen + SiFTO with U/i time offsets (reference models.py:921-980)."""

    input_names = ["t_0", "a", "M v^7", "t_\\mathrm{max}", "s", "\\Delta t_U", "\\Delta t_i"]
    units = [u.d, 10.0 ** 13.0 * u.cm, M_chandra * (1e9 * u.cm / u.s) ** 7, u.d,
             u.dimensionless_unscaled, u.d, u.d]

    def evaluate(self, t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                 dtU=0.0, dti=0.0, kappa=None):
        # kappa rides the device path (reference models.py:957-980 signature)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                                dtU, dti, kappa)

    def _eval_points(self, t, quad, t_exp, a13, Mc_v9_7, t_peak, stretch,
                     dtU=0.0, dti=0.0, kappa=None):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, Mc_v9_7, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch, dtU, dti)
        return Lnu_kasen + Lnu_sifto


class CompanionShocking3(BaseCompanionShocking):
    """Kasen + SiFTO with U/i time offsets and the Brown et al. (2012) viewing-
    angle factor (reference models.py:983-1045)."""

    input_names = ["t_0", "a", "\\theta", "t_\\mathrm{max}", "s", "\\Delta t_U", "\\Delta t_i"]
    units = [u.d, 10.0 ** 13.0 * u.cm, u.deg, u.d, u.dimensionless_unscaled, u.d, u.d]

    def evaluate(self, t_in, f, t_exp, a13, theta, t_peak, stretch,
                 dtU=0.0, dti=0.0, kappa=None):
        # kappa rides the device path (reference models.py:1022-1045 signature)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, theta, t_peak, stretch,
                                dtU, dti, kappa)

    def _eval_points(self, t, quad, t_exp, a13, theta, t_peak, stretch,
                     dtU=0.0, dti=0.0, kappa=None):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, 1.0, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch, dtU, dti)
        theta_rad = jnp.deg2rad(theta)
        fractional_flux = ((0.5 * jnp.cos(theta_rad) + 0.5)
                           * (0.14 * theta_rad ** 2.0 - 0.4 * theta_rad + 1.0))
        return Lnu_kasen * fractional_flux + Lnu_sifto
