"""Bolometric light curves from per-epoch blackbody SED fits.

API-parity module for the reference ``lightcurve_fitting/bolometric.py``:
``calculate_bolometric`` (bolometric.py:648-832) with its three estimators —
bounded least squares (:483), per-epoch blackbody MCMC (:87), and direct SED
integration (:537) — plus epoch grouping (:383), colors (:560), and the result
plots (:290, :608).

Accelerator design: the per-epoch MCMC log-posterior is a pure jax function over
FilterBank quadrature; each epoch's chain is one jitted scan (compile cache
keyed by the epoch's band multiset), and an optional fully-batched path fits
all epochs at once with vmap + padding masks (see ``parallel.batched``).
KDE prior chaining for single-filter epochs (reference :753-759) is preserved
as a sequential pass by construction. Unlike the reference, single-filter
epochs do not crash the least-squares stage: our KDE prior keeps its bounds
attributes.
"""

import functools
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
from scipy.optimize import curve_fit, OptimizeWarning

from .filters import filtdict, extinction_law
from .models import planck_fast, UniformPrior, LogUniformPrior, GaussianPrior, KDEPrior
from .models.base import intrinsic_scatter_units
from .models.blackbody import planck_lnu
from .lightcurve import LC
from .parallel.sampler import EnsembleSampler
from .ops.filterbank import FilterBank, bank_for, band_table_for
from .utils.table import vstack
from .utils import units as u
from .core.constants import sigma_sb

__all__ = ["calculate_bolometric", "spectrum_mcmc", "spectrum_corner", "plot_chain",
           "blackbody_lstsq", "integrate_sed", "pseudo", "stefan_boltzmann",
           "group_by_epoch", "median_and_unc", "calc_colors",
           "plot_bolometric_results", "plot_color_curves"]

_STYLE = os.path.join(os.path.dirname(__file__), "serif.mplstyle")


@functools.cache
def _pyplot():
    """pyplot with the package's plot style applied. Imported on the first
    plot, so a fit that draws nothing never imports matplotlib."""
    import matplotlib.pyplot as plt
    plt.style.use(_STYLE)
    return plt

DEPRECATED_BOLOMETRIC_COLNAMES = [  # (old, new)
    ("L_opt", "L"),
    ("lum", "L_bol"),
    ("dlum", "dL_bol"),
    ("dtemp0", "dtemp_mcmc0"),
    ("dtemp1", "dtemp_mcmc1"),
    ("dradius0", "dradius_mcmc0"),
    ("dradius1", "dradius_mcmc1"),
]


def pseudo(temp, radius, z, filter0=filtdict["I"], filter1=filtdict["U"], cutoff_freq=np.inf):
    """Pseudobolometric luminosity: blackbody integrated between two filters on
    a 1-THz grid (reference bolometric.py:32-59). Default U to I."""
    freq0 = filter0.freq_eff.value - filter0.dfreq.value / 2.0
    freq1 = filter1.freq_eff.value + filter1.dfreq.value / 2.0
    x_optical = np.arange(freq0, freq1)
    y_optical = planck_fast(x_optical * (1.0 + z), temp, radius, cutoff_freq)
    L_opt = np.trapezoid(y_optical) * 1e12  # dx = 1 THz
    return L_opt


def plot_chain(chain, labels=None):
    """Chain-history plots (reference bolometric.py:62-84)."""
    plt = _pyplot()
    ndim = chain.shape[-1]
    fig, ax = plt.subplots(ndim, figsize=(6.0, 2.0 * ndim), squeeze=False)
    ax = ax.ravel()
    for i in range(ndim):
        ax[i].plot(chain[:, :, i].T, "k", alpha=0.2)
        if labels:
            ax[i].set_ylabel(labels[i])
    return fig


def _make_sed_log_posterior(spectrum, epoch1, priors, z, ebv, spectrum_kwargs,
                            use_sigma, sigma_type):
    """Pure jax log-posterior for an SED fit. ``spectrum(nu, *params)`` is
    evaluated at the FilterBank's emitted-frame nodes; for the default
    ``planck_fast`` the jax kernel is substituted directly."""
    y_np = np.asarray(epoch1["lum"], float)
    dy_np = np.asarray(epoch1["dlum"], float)
    # O(1) data scale for float32-range safety (see models/base.py)
    yscale = float(np.median(np.abs(y_np[y_np != 0]))) if np.any(y_np != 0) else 1.0
    offset = -len(y_np) * np.log(yscale)
    inv_yscale = 1.0 / yscale
    y = jnp.asarray(y_np / yscale)
    dy = jnp.asarray(dy_np / yscale)
    filters = list(epoch1["filter"])
    bank = bank_for(sorted(set(filters)))
    ids = bank.band_ids(filters)
    nodes, weights, k_ext = bank.gather(ids, z=z)
    ext = jnp.asarray(extinction_law(np.asarray(bank.emitted_nodes(z)[ids]).ravel(), ebv)
                      .reshape(nodes.shape)) if np.any(ebv) else None

    table = None
    if spectrum is planck_fast and not np.any(ebv):
        # blackbody: band integral factorizes -> per-band Chebyshev of ln g(ln T)
        table = band_table_for(bank, z=z,
                               cutoff_freq=spectrum_kwargs.get("cutoff_freq", np.inf))
        table_gathered = table.gather(ids)

    if spectrum is planck_fast:
        def spec_fn(nu, *p):
            return planck_lnu(nu, p[0], p[1], **spectrum_kwargs)
    else:
        def spec_fn(nu, *p):
            return spectrum(nu, *[pp[..., None] for pp in p], **spectrum_kwargs)

    sigma_units = intrinsic_scatter_units(dy, sigma_type)

    def log_posterior(p):
        log_prior = 0.0
        for i, prior in enumerate(priors):
            log_prior = log_prior + prior(p[i])
        n_model = p.shape[0] - (1 if use_sigma else 0)
        if table is not None:
            y_fit = table.eval_points(table_gathered,
                                      jnp.broadcast_to(p[0], y.shape),
                                      jnp.broadcast_to(p[1], y.shape)) * inv_yscale
        else:
            lnu = spec_fn(nodes, *[p[i] for i in range(n_model)])
            if ext is not None:
                lnu = lnu * ext
            y_fit = jnp.sum(weights * lnu, axis=-1) * inv_yscale
        if use_sigma:
            sigma2 = dy ** 2.0 + (p[-1] * sigma_units) ** 2.0
        else:
            sigma2 = dy ** 2.0
        ll = -0.5 * jnp.sum(jnp.log(2 * jnp.pi * sigma2)
                            + (y - y_fit) ** 2.0 / sigma2) + offset
        ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
        return jnp.where(jnp.isfinite(log_prior), log_prior + ll, -jnp.inf)

    return log_posterior


def spectrum_mcmc(spectrum, epoch1, priors, starting_guesses, z=0.0, ebv=0.0,
                  spectrum_kwargs=None, show=False, outpath=".", nwalkers=10,
                  burnin_steps=200, steps=100, save_chains=False, use_sigma=False,
                  sigma_type="relative", labels=None, freq_min=100.0, freq_max=1000.0,
                  seed=None, make_corner=True):
    """Fit an SED function to one epoch of photometry with ensemble MCMC
    (reference bolometric.py:87-190)."""
    mjdavg = float(np.median(np.asarray(epoch1["MJD"], float)))
    if spectrum_kwargs is None:
        spectrum_kwargs = {}
    # drop non-finite kwargs that are jit-safe defaults
    sk = {k: v for k, v in spectrum_kwargs.items() if not (k == "cutoff_freq" and np.isinf(v))}

    ndim = len(priors)
    if nwalkers % 2:
        nwalkers += 1
        starting_guesses = np.vstack([starting_guesses, starting_guesses[-1:]])
    try:
        log_posterior = _make_sed_log_posterior(spectrum, epoch1, priors, z, ebv, sk,
                                                use_sigma, sigma_type)
        # verify the spectrum function traces (arbitrary Python callables may
        # not): eval_shape forces abstract tracing through the vmapped path
        jax.eval_shape(jax.vmap(log_posterior),
                       jnp.zeros((2, ndim), dtype=jnp.asarray(0.0).dtype))
        sampler = EnsembleSampler(nwalkers, ndim, log_posterior, seed=seed)
    except Exception as exc:
        # Any failure to build/trace the device path drops to the slow host
        # sampler — arbitrary Python spectrum callables can raise anything at
        # trace time (numba TypingErrors, their own ValueErrors), not just
        # jax tracer errors. The built-in planck_fast is exempt from the
        # fallback: its device path is expected to trace, so a failure there
        # is a framework bug that must surface, not degrade to ~19 evals/s.
        if spectrum is planck_fast:
            raise
        # Unlike the round-1 blanket except this is LOUD:
        # a visible warning names the exception so genuine jax-path bugs are
        # seen, not silently absorbed into a 19-evals/s run.
        warnings.warn(
            f"device SED path unavailable for spectrum function "
            f"{getattr(spectrum, '__name__', spectrum)!r} "
            f"({type(exc).__name__}: {exc}); falling back to the host sampler "
            f"(reference-parity path, orders of magnitude slower)")
        # host fallback: numpy stretch move over Filter.synthesize, exactly the
        # reference's generic path (bolometric.py:154-164)
        from .parallel.host_sampler import HostEnsembleSampler
        filters = list(epoch1["filter"])
        y_np = np.asarray(epoch1["lum"], float)
        dy_np = np.asarray(epoch1["dlum"], float)
        sigma_units = intrinsic_scatter_units(dy_np, sigma_type, xp=np)

        def log_posterior_host(p):
            log_prior = 0.0
            for prior, p_i in zip(priors, p):
                log_prior += float(prior(p_i))
            if np.isinf(log_prior):
                return log_prior
            y_fit = np.array([f.synthesize(spectrum, *p[: -1 if use_sigma else None],
                                           z=z, ebv=ebv, **sk) for f in filters])
            sigma = np.sqrt(dy_np ** 2 + (p[-1] * sigma_units) ** 2) if use_sigma else dy_np
            ll = -0.5 * np.sum(np.log(2 * np.pi * sigma ** 2) + ((y_np - y_fit) / sigma) ** 2)
            return log_prior + ll

        sampler = HostEnsembleSampler(nwalkers, ndim, log_posterior_host, seed=seed)
    pos, _, _ = sampler.run_mcmc(starting_guesses, burnin_steps, skip_initial_state_check=True)

    if show:
        plot_chain(sampler.chain, labels)
    sampler.reset()
    sampler.run_mcmc(pos, steps, skip_initial_state_check=True)
    if show:
        plot_chain(sampler.chain, labels)

    os.makedirs(outpath, exist_ok=True)
    if save_chains:
        chain_filename = os.path.join(outpath, f"{mjdavg:.3f}.npy")
        np.save(chain_filename, sampler.flatchain)

    if make_corner:
        f4 = spectrum_corner(spectrum, epoch1, sampler.flatchain, z, ebv, spectrum_kwargs,
                             use_sigma, labels, freq_min=freq_min, freq_max=freq_max,
                             save_plot_as=os.path.join(outpath, f"{mjdavg:.3f}.pdf"))
        if show:
            _pyplot().show()
        else:
            _pyplot().close(f4)

    return sampler


def _style_sed_axes(ax, yscale):
    """Frequency on top, luminosity on the right — the inset sits in the
    corner plot's upper-right triangle, so labels face outward."""
    ax.xaxis.tick_top()
    ax.set_xlabel("Frequency (THz)")
    ax.xaxis.set_label_position("top")
    ax.yaxis.tick_right()
    ax.set_ylabel(f"Luminosity $L_\\nu$ (10$^{{{np.log10(yscale):.0f}}}$ W Hz$^{{-1}}$)")
    ax.yaxis.set_label_position("right")


def _blank_axes(ax):
    plt = _pyplot()
    ax.set_frame_on(False)
    ax.xaxis.set_major_locator(plt.NullLocator())
    ax.yaxis.set_major_locator(plt.NullLocator())
    ax.set_xlabel("")
    ax.set_ylabel("")


def _sed_inset_axes(fig, ndim, yscale):
    """Allocate the SED inset inside a corner figure: the top-right pair-plot
    cell alone for 1-D posteriors, else a rectangle spanning from mid-grid to
    the top-right corner (its footprint computed from the existing cells)."""
    plt = _pyplot()
    grid = np.reshape(fig.get_axes(), (ndim, ndim))
    anchor = grid[0, -1]
    anchor.set_frame_on(True)
    anchor.xaxis.set_major_locator(plt.AutoLocator())
    anchor.yaxis.set_major_locator(plt.AutoLocator())
    _style_sed_axes(anchor, yscale)
    fig.tight_layout(h_pad=0.05, w_pad=0.05)
    if ndim == 1:
        return anchor

    to_figure = fig.transFigure.inverted()
    inner = grid[ndim // 2 - 1, (ndim + 1) // 2].bbox.transformed(to_figure)
    outer = anchor.bbox.transformed(to_figure)
    ax = fig.add_axes([inner.xmin, inner.ymin,
                       outer.xmax - inner.xmin, outer.ymax - inner.ymin])
    _style_sed_axes(ax, yscale)
    _blank_axes(anchor)
    return ax


def spectrum_corner(spectrum, epoch1, sampler_flatchain, z=0.0, ebv=0.0,
                    spectrum_kwargs=None, use_sigma=False, labels=None, freq_min=100.0,
                    freq_max=1000.0, save_plot_as=""):
    """Corner plot with an SED inset showing the observed points and 100
    posterior-draw spectra (behavioral spec: reference bolometric.py:193-287)."""
    from .utils.corner import corner as _corner

    _pyplot()
    ndim = sampler_flatchain.shape[-1]
    fig = _corner(sampler_flatchain, labels=labels)

    draws = sampler_flatchain[np.random.choice(sampler_flatchain.shape[0], 100)].T
    params = draws[:-1] if use_sigma else draws
    filters = list(epoch1["filter"])
    observed = np.arange(min(freq_min, max(filters).freq_eff.value),
                         max(freq_max, min(filters).freq_eff.value))
    emitted = observed * (1.0 + z)
    yfit = spectrum(emitted, *params, **(spectrum_kwargs or {})) \
        * extinction_law(emitted, ebv)
    yscale = 10.0 ** np.floor(np.log10(yfit.max()))

    ax = _sed_inset_axes(fig, ndim, yscale)
    for row in epoch1:
        ax.errorbar(row["freq"], row["lum"] / yscale, row["dlum"] / yscale, marker="o",
                    **row["filter"].plotstyle)
    ax.plot(observed, yfit.T / yscale, color="k", alpha=0.05)

    if save_plot_as:
        fig.savefig(save_plot_as)
        print("saving figure as " + save_plot_as)
    return fig


def _snap_to_grid(mjd, res):
    """Round times onto a ``res``-day grid whose phase is chosen so the
    typical observation lands mid-cell (keeps nightly cadences together even
    when nights straddle integer MJDs)."""
    scaled = np.asarray(mjd, float) / res
    typical_frac = np.median(scaled - np.trunc(scaled))
    return np.round(scaled - typical_frac + np.round(typical_frac)) * res


def group_by_epoch(lc, res=1.0, also_group_by=()):
    """Split photometry into single-SED epochs at resolution ``res`` days,
    ordered by median MJD; rows with a manual 'epoch' value keep it
    (behavioral spec: reference bolometric.py:383-416)."""
    epochs = lc.get("epoch").astype(float)
    missing = np.ma.getmaskarray(epochs)
    if missing.any():
        epochs[missing] = _snap_to_grid(np.asarray(lc["MJD"], float)[missing], res)
    lc["epoch"] = np.ma.filled(epochs)
    for col in also_group_by:
        if np.ma.is_masked(lc[col]):
            lc[col] = lc[col].filled()
    grouped = lc.group_by(["epoch", *also_group_by])
    order = np.argsort([np.median(np.asarray(g["MJD"], float)) for g in grouped.groups])
    return [grouped.groups[i] for i in order]


def stefan_boltzmann(temp, radius, dtemp=None, drad=None, covTR=None):
    """L = 4 pi R^2 sigma T^4 (W; T in kK, R in 1000 Rsun), optionally with
    first-order error propagation through dL/dR = 2L/R and dL/dT = 4L/T
    (behavioral spec: reference bolometric.py:422-453)."""
    temp = np.asarray(temp)
    radius = np.asarray(radius)
    lum = 4.0 * np.pi * sigma_sb * radius ** 2 * temp ** 4
    if dtemp is None or drad is None or covTR is None:
        return lum
    dl_dr = 2.0 * lum / radius
    dl_dt = 4.0 * lum / temp
    var = dl_dr ** 2 * drad ** 2 + dl_dt ** 2 * dtemp ** 2 + 2.0 * dl_dr * dl_dt * covTR
    return lum, np.sqrt(var)


def median_and_unc(x, perc_contained=68.0):
    """Median and the half-widths of the equal-tailed ``perc_contained``%
    interval (behavioral spec: reference bolometric.py:456-480)."""
    tail = (100.0 - perc_contained) / 2.0
    lo, med, hi = np.percentile(np.asarray(x, float), [tail, 50.0, 100.0 - tail], axis=0)
    return med, med - lo, hi - med


def blackbody_lstsq(epoch1, z, p0=None, T_range=(1.0, 100.0), R_range=(0.01, 1000.0),
                    cutoff_freq=np.inf):
    """chi^2 blackbody fit of one epoch via bounded least squares (reference
    bolometric.py:483-534)."""
    if p0 is None:
        p0 = [10.0, 10.0]

    def planck_cutoff(nu, T, R):
        return planck_fast(nu, T, R, cutoff_freq)

    lo = [T_range[0] if np.isfinite(T_range[0]) else 0.0,
          R_range[0] if np.isfinite(R_range[0]) else 0.0]
    hi = [T_range[1] if np.isfinite(T_range[1]) else np.inf,
          R_range[1] if np.isfinite(R_range[1]) else np.inf]
    with warnings.catch_warnings():
        if len(epoch1) <= 2:
            warnings.simplefilter("ignore", OptimizeWarning)
        p0, cov = curve_fit(planck_cutoff, np.asarray(epoch1["freq"], float) * (1.0 + z),
                            np.asarray(epoch1["lum"], float), p0=p0, bounds=(lo, hi))
    temp, radius = p0
    dtemp, drad = np.sqrt(np.diag(cov))
    lum, dlum = stefan_boltzmann(temp, radius, dtemp, drad, cov[0, 1])
    L_opt = pseudo(temp, radius, z, cutoff_freq=cutoff_freq)
    return temp, radius, dtemp, drad, lum, dlum, L_opt


def integrate_sed(epoch1):
    """Trapezoidal integral of the observed SED, zero-padded by one effective
    bandwidth at each end (reference bolometric.py:537-557). Returns watts."""
    epoch1.sort("freq")
    freq = np.asarray(epoch1["freq"], float)
    dfreq = np.asarray(epoch1["dfreq"], float)
    lum = np.asarray(epoch1["lum"], float)
    freqs = np.concatenate([[freq[0] - dfreq[0]], freq, [freq[-1] + dfreq[-1]]])
    lums = np.concatenate([[0.0], lum, [0.0]])
    return np.trapezoid(lums, freqs) * 1e12  # W/Hz * THz -> W


def _one_color(epoch1, color):
    """(value, uncertainty, lolim, uplim) for one color string like 'B-V'.
    Missing bands give a fully-masked entry; two nondetections give an
    unconstrained color; one nondetection becomes a one-sided limit."""
    blue, red = (filtdict[name] for name in color.split("-"))
    available = list(epoch1["filter"])
    if blue not in available or red not in available:
        return np.nan, np.nan, True, True
    rows = {f: epoch1.where(filter=f)[["absmag", "dmag", "nondet"]][0]
            for f in (blue, red)}
    (m_b, dm_b, lim_b), (m_r, dm_r, lim_r) = rows[blue], rows[red]
    value = np.nan if (lim_b and lim_r) else m_b - m_r
    return value, np.hypot(dm_b, dm_r), bool(lim_b), bool(lim_r)


def calc_colors(epoch1, colors):
    """Colors from one epoch's SED, with nondetection limit flags
    (behavioral spec: reference bolometric.py:560-605)."""
    results = [_one_color(epoch1, color) for color in colors]
    if not results:
        return [], [], [], []
    mags, dmags, lolims, uplims = (list(col) for col in zip(*results))
    return mags, dmags, lolims, uplims


def plot_color_curves(t, colors=None, fmt="o", limit_length=0.1, xcol="MJD"):
    """Color curves from the ``calculate_bolometric`` output table (reference
    bolometric.py:608-645)."""
    if colors is None:
        colors = []
        for col in t.colnames:
            # require the paired d(...) column: plain luminosity columns like 'L'
            # would otherwise match the 'L' filter (latent bug in the reference)
            if (col.split("-")[0] in filtdict and f"d({col})" in t.colnames
                    and not (t.has_masked_values and np.asarray(t.mask[col]).all())):
                colors.append(col)
    plt = _pyplot()
    fig = plt.figure()
    for c in colors:
        dcolor_colname = f"d({c})"
        if t.has_masked_values and np.asarray(t.mask[dcolor_colname]).any():
            dcolor = np.ma.filled(np.ma.MaskedArray(t[dcolor_colname]), limit_length)
        else:
            dcolor = np.asarray(t[dcolor_colname])
        plt.errorbar(np.asarray(t[xcol]), np.ma.filled(np.ma.MaskedArray(t[c]), np.nan),
                     dcolor, (np.asarray(t[f"d{xcol}0"]), np.asarray(t[f"d{xcol}1"])),
                     fmt=fmt, lolims=np.asarray(t[f"lolims({c})"], bool),
                     uplims=np.asarray(t[f"uplims({c})"], bool), label=f"${c}$")
    plt.xlabel(xcol)
    plt.ylabel("Color (mag)")
    plt.legend()
    return fig


def plot_bolometric_results(t0, save_plot_as=None, xcol=None, log=False):
    """3-panel L/R/T plot of the bolometric results using synthetic
    method-label 'filters' (reference bolometric.py:290-380)."""
    if xcol is None:
        xcol = "phase" if "redshift" in t0.meta else "MJD"
    elif xcol == "phase" and "redshift" not in t0.meta:
        raise ValueError("must set t0.meta['redshift'] and t0.meta['refmjd'] to calculate the phase")

    for old, new in DEPRECATED_BOLOMETRIC_COLNAMES:
        if new not in t0.colnames:
            t0.rename_column(old, new)
            warnings.warn(f"Updating deprecated column name from {old} to {new}")

    plt = _pyplot()
    fig, axarr = plt.subplots(3, figsize=(6, 12), sharex=True)

    datasets = [
        ("", "pseudobolometric, curve_fit"),
        ("_mcmc", "pseudobolometric, MCMC"),
        ("_int", "pseudobolometric, integration"),
        ("_bol", "bolometric, curve_fit"),
        ("_bol_mcmc", "bolometric, MCMC"),
    ]

    subtabs = []
    for suffix, label in datasets:
        lc = LC(t0[["MJD", "source"]] if "source" in t0.colnames else t0[["MJD"]])
        lc["filter"] = filtdict[label]
        for base_ycol in ["L", "radius", "temp"]:
            ycol = base_ycol + suffix
            if ycol in t0.colnames:
                lc[base_ycol] = t0[ycol]
            dycol = f"d{ycol}"
            dycol0 = f"d{ycol}0"
            dycol1 = f"d{ycol}1"
            if dycol0 in t0.colnames and dycol1 in t0.colnames:
                lc[f"d{base_ycol}"] = np.column_stack([np.ma.filled(np.ma.MaskedArray(t0[dycol0]), np.nan),
                                                       np.ma.filled(np.ma.MaskedArray(t0[dycol1]), np.nan)])
            elif dycol in t0.colnames:
                lc[f"d{base_ycol}"] = np.column_stack([np.ma.filled(np.ma.MaskedArray(t0[dycol]), np.nan)] * 2)
        subtabs.append(lc)
    t = vstack(subtabs)
    t = LC(t)
    if xcol == "phase":
        t.meta = dict(t0.meta)
        t.calcPhase()
    else:
        log = False

    plt.sca(axarr[0])
    t.plot(xcol=xcol, ycol="L", loc_filt="lower right", mjd_axis=False)
    axarr[0].set_xlabel("")
    axarr[0].set_yscale("log")
    axarr[0].set_ylabel("Luminosity (W)")

    plt.sca(axarr[1])
    t.plot(xcol=xcol, ycol="radius", loc_mark="lower right", mjd_axis=False)
    axarr[1].set_xlabel("")
    axarr[1].set_ylabel("Radius ($1000 R_\\odot$)")

    plt.sca(axarr[2])
    t.plot(xcol=xcol, ycol="temp", mjd_axis=False)
    axarr[2].set_ylabel("Temperature (kK)")
    if log:
        axarr[2].set_xscale("log")
        axarr[2].xaxis.set_major_formatter(plt.FormatStrFormatter("%g"))

    fig.tight_layout()
    if save_plot_as is not None:
        fig.savefig(save_plot_as)
    return fig


class _FlatchainSampler:
    """Minimal sampler shim so batched results feed the same downstream code
    (KDE prior chaining, chain saving) as the sequential path."""

    def __init__(self, flatchain):
        self.flatchain = flatchain


# result-table schema (names and dtypes follow the reference's documented
# output, bolometric.py:712-726); per-color and source columns are appended
_SED_FIT_COLUMNS = (
    ("MJD", float), ("dMJD0", float), ("dMJD1", float),
    ("temp", float), ("radius", float), ("dtemp", float), ("dradius", float),
    ("L_bol", float), ("dL_bol", float), ("L", float),
    ("temp_mcmc", float), ("radius_mcmc", float),
    ("dtemp_mcmc0", float), ("dtemp_mcmc1", float),
    ("dradius_mcmc0", float), ("dradius_mcmc1", float),
    ("L_bol_mcmc", float), ("dL_bol_mcmc0", float), ("dL_bol_mcmc1", float),
    ("L_mcmc", float), ("dL_mcmc0", float), ("dL_mcmc1", float),
    ("L_int", float), ("npoints", int),
)

_LSTSQ_FIELDS = ("temp", "radius", "dtemp", "dradius", "L_bol", "dL_bol", "L")
_MCMC_FIELDS = ("temp_mcmc", "radius_mcmc", "dtemp_mcmc0", "dtemp_mcmc1",
                "dradius_mcmc0", "dradius_mcmc1", "L_bol_mcmc", "dL_bol_mcmc0",
                "dL_bol_mcmc1", "L_mcmc", "dL_mcmc0", "dL_mcmc1")


def _result_table(colors, with_source):
    names = [name for name, _ in _SED_FIT_COLUMNS]
    dtypes = [dt for _, dt in _SED_FIT_COLUMNS]
    for template, dt in ((("{}"), float), (("d({})"), float),
                         (("lolims({})"), bool), (("uplims({})"), bool)):
        names += [template.format(c) for c in colors]
        dtypes += [dt] * len(colors)
    names.append("filts")
    dtypes.append("S6")
    if with_source:
        names.append("source")
        dtypes.append(object)
    return LC(names=names, dtype=dtypes, masked=True)


def _missing(value):
    """Mask rule for one result cell: numpy-masked values, NaN floats, and
    empty strings are masked; booleans never are."""
    if np.ma.is_masked(value):
        # a masked scalar would otherwise fall through every test below as
        # "present" and expose its fill value in the output table
        return True
    if isinstance(value, (bool, np.bool_, int, np.integer)):
        return False
    if isinstance(value, (str, bytes)):
        return not value
    try:
        return bool(np.isnan(value))
    except TypeError:
        return not bool(value)


def _append_record(t0, record):
    values = [record[name] for name in t0.colnames]
    t0.add_row(values, mask=[_missing(v) for v in values])


def _lstsq_record(epoch1, z, p0, priors, cutoff_freq):
    """Bounded least-squares stage; optimization failure degrades to masked
    cells, not a crash (reference bolometric.py:767-771)."""
    T_range = (priors[0].p_min, priors[0].p_max)
    R_range = (priors[1].p_min, priors[1].p_max)
    try:
        fitted = blackbody_lstsq(epoch1, z, p0, T_range, R_range, cutoff_freq)
        return dict(zip(_LSTSQ_FIELDS, fitted)), np.array(fitted[:2])
    except RuntimeError:
        return {field: np.nan for field in _LSTSQ_FIELDS}, p0


def _mcmc_record(flatchain, z, cutoff_freq):
    """Posterior summaries of the MCMC stage: T/R medians with asymmetric
    errors, plus Stefan-Boltzmann and pseudobolometric luminosity sample
    distributions (reference bolometric.py:786-798)."""
    bol_samples = stefan_boltzmann(flatchain[:, 0], flatchain[:, 1])
    opt_samples = pseudo(flatchain[:, 0], flatchain[:, 1], z, cutoff_freq=cutoff_freq)
    (T, R), (dT0, dR0), (dT1, dR1) = median_and_unc(flatchain[:, :2])
    L_bol, dL_bol0, dL_bol1 = median_and_unc(bol_samples)
    L_opt, dL_opt0, dL_opt1 = median_and_unc(opt_samples)
    return {"temp_mcmc": T, "radius_mcmc": R,
            "dtemp_mcmc0": dT0, "dtemp_mcmc1": dT1,
            "dradius_mcmc0": dR0, "dradius_mcmc1": dR1,
            "L_bol_mcmc": L_bol, "dL_bol_mcmc0": dL_bol0, "dL_bol_mcmc1": dL_bol1,
            "L_mcmc": L_opt, "dL_mcmc0": dL_opt0, "dL_mcmc1": dL_opt1}


def _pseudo_grid(filter0=filtdict["I"], filter1=filtdict["U"]):
    """The observed-frame 1-THz integration grid ``pseudo`` uses (reference
    bolometric.py:32-59) — shared with the on-device batched summaries so
    both paths integrate the same frequencies."""
    freq0 = filter0.freq_eff.value - filter0.dfreq.value / 2.0
    freq1 = filter1.freq_eff.value + filter1.dfreq.value / 2.0
    return np.arange(freq0, freq1)


def _summary_record(summ_row):
    """The ``_mcmc_record`` fields from one epoch's on-device summary row
    (``batched_blackbody_mcmc(summaries=...)``): rows (T, R, R^2T^4,
    pseudo/1e12), columns (16th, 50th, 84th percentile). The unit constants
    are applied here, host-side, where real float64 range is available;
    percentiles commute with the positive scaling."""
    (T_lo, T, T_hi), (R_lo, R, R_hi), u, s = summ_row
    L_bol = 4.0 * np.pi * sigma_sb * np.asarray(u)
    L_opt = 1e12 * np.asarray(s)
    return {"temp_mcmc": T, "radius_mcmc": R,
            "dtemp_mcmc0": T - T_lo, "dtemp_mcmc1": T_hi - T,
            "dradius_mcmc0": R - R_lo, "dradius_mcmc1": R_hi - R,
            "L_bol_mcmc": L_bol[1], "dL_bol_mcmc0": L_bol[1] - L_bol[0],
            "dL_bol_mcmc1": L_bol[2] - L_bol[1],
            "L_mcmc": L_opt[1], "dL_mcmc0": L_opt[1] - L_opt[0],
            "dL_mcmc1": L_opt[2] - L_opt[1]}


def _color_record(epoch1, colors):
    mags, dmags, lolims, uplims = calc_colors(epoch1, colors)
    record = {}
    for c, mag, dmag, lo, up in zip(colors, mags, dmags, lolims, uplims):
        record[c] = mag
        record[f"d({c})"] = dmag
        record[f"lolims({c})"] = lo
        record[f"uplims({c})"] = up
    return record


def _prepare_epoch_seds(lc, res, also_group_by):
    """Per epoch: flux -> single bin -> mags -> luminosities, plus effective
    frequencies (reference bolometric.py:736-740)."""
    groups = []
    for epoch1 in group_by_epoch(lc, res, also_group_by):
        epoch1.calcFlux()
        epoch1 = epoch1.bin(delta=np.inf)
        epoch1.calcMag()
        epoch1.calcAbsMag()
        epoch1.calcLum()
        epoch1["freq"] = np.array([f.freq_eff.value for f in epoch1["filter"]])
        epoch1["dfreq"] = np.array([f.dfreq.value for f in epoch1["filter"]])
        epoch1["freq"].unit = u.THz
        epoch1["lum"].unit = u.W / u.Hz
        epoch1["dlum"].unit = u.W / u.Hz
        groups.append(epoch1)
    return groups


def calculate_bolometric(lc, z=0.0, outpath=".", res=1.0, nwalkers=10, burnin_steps=200,
                         steps=100, priors=None, save_table_as=None, min_nfilt=3,
                         cutoff_freq=np.inf, show=False, colors=None, do_mcmc=True,
                         save_chains=False, use_sigma=False, sigma_type="relative",
                         also_group_by=(), seed=None, save_corners=True,
                         batch_mode=False, mesh=None, state_dtype="auto"):
    """Full bolometric light curve from broadband photometry (behavioral
    spec: reference bolometric.py:648-832). Adds ``seed`` for
    reproducibility, ``save_corners`` to skip per-epoch corner PDFs, and
    ``batch_mode`` to run every multi-filter epoch's MCMC concurrently in one
    jitted vmap on device (identical statistics; starting guesses centered on
    the default p0 rather than the previous epoch's curve_fit solution).
    With ``mesh`` (a ``jax.sharding.Mesh`` with an ``"epochs"`` axis, e.g.
    ``walker_mesh(8, axis_name="epochs")``), batch mode shards the epoch axis
    across the mesh — each chip fits its own epochs, no collectives.
    ``mesh=None`` (the default) auto-shards over all visible devices when
    more than one is present, like ``lightcurve_mcmc(shard=None)``;
    ``mesh=False`` forces single-device. ``state_dtype`` sets batch mode's
    walker-state dtype (``batched_blackbody_mcmc``: ``"auto"`` is float32 on
    accelerators, float64 on the CPU).
    Single-filter epochs always run sequentially so the KDE temperature-prior
    chaining (reference :753-759) is preserved."""
    if z:
        warnings.warn('The z keyword is deprecated. Include the redshift in `lc.meta["redshift"]` instead.')
    z = lc.meta.get("redshift", z)

    colors = list(colors) if colors is not None else []
    use_src = "source" in lc.colnames
    t0 = _result_table(colors, use_src)

    if priors is None:
        priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
        if use_sigma:
            priors.append(GaussianPrior(0.0, 10.0))
    else:
        # copy: KDE chaining rebinds priors[0] below, which must not leak into
        # a caller-owned list reused across calls (the reference mutates the
        # caller's list too, but its chaining path crashes before a second
        # call could observe it — here it works, so the copy matters)
        priors = list(priors)

    sampler = None
    finite = np.isfinite(np.ma.filled(np.ma.MaskedArray(lc["dmag"]).astype(float), np.nan))
    lc = lc[finite & np.ma.filled(np.ma.MaskedArray(lc["dmag"]) > 0.0, False)]
    rng = np.random.default_rng(seed)

    groups = _prepare_epoch_seds(lc, res, also_group_by)

    # batch mode: fit all multi-filter epochs concurrently in one device call
    batched_chains = {}
    batched_summaries = {}
    if batch_mode and do_mcmc:
        from .parallel.batched import pack_epochs, batched_blackbody_mcmc
        if mesh is None and jax.device_count() > 1:
            from .parallel.mesh import walker_mesh
            mesh = walker_mesh(jax.device_count(), axis_name="epochs")
        elif mesh is False:
            mesh = None
        # KDE chaining (min_nfilt <= 1): a single-filter epoch replaces the
        # temperature prior for EVERY later epoch (reference
        # bolometric.py:753-759), so multi-filter epochs after the first
        # single-filter one must fit sequentially with the mutated prior —
        # pre-batching them with the original priors diverged from the
        # sequential statistics. Only epochs before that point batch.
        chain_cut = len(groups)
        if min_nfilt <= 1:
            for i, ep in enumerate(groups):
                if len(set(ep.where(nondet=False)["filter"])) == 1:
                    chain_cut = i
                    break
        eligible = []
        for i, ep in enumerate(groups[:chain_cut]):
            nfilt_i = len(set(ep.where(nondet=False)["filter"]))
            if nfilt_i >= min_nfilt and nfilt_i > 1:
                eligible.append(i)
        if eligible:
            from .parallel.batched import batched_map_centers
            all_filts = sorted({f for i in eligible for f in groups[i]["filter"]})
            bank = bank_for(all_filts)
            packed = pack_epochs([groups[i] for i in eligible], bank, z)
            ndim = len(priors)
            # center each epoch's walkers on its MAP, all epochs in one
            # compiled multi-start Adam scan (round 2 ran a serial scipy
            # curve_fit per epoch here; the sequential path gets centering
            # for free via p0 chaining). Non-converged epochs fall back to
            # the default p0, the curve_fit-RuntimeError degrade semantics.
            centers = batched_map_centers(packed, priors, cutoff_freq,
                                          use_sigma, sigma_type,
                                          seed=seed if seed is not None else 0,
                                          mesh=mesh)
            # the stretch move needs an even walker count; pad like the
            # sequential path does inside spectrum_mcmc (bolometric.py:158)
            nw_batch = nwalkers + (nwalkers % 2)
            guesses = rng.normal(size=(len(eligible), nw_batch, ndim)) + centers[:, None, :]
            guesses[guesses <= 0.0] = 1.0
            # posterior summaries are computed on device; the full chains only
            # reach the host when something downstream actually needs them
            # (per-epoch saves, corner PDFs, or KDE chaining into
            # single-filter epochs)
            need_chains = bool(save_chains or save_corners or min_nfilt < 2)
            flat, _acc, summ = batched_blackbody_mcmc(
                packed, priors, guesses, nw_batch, burnin_steps, steps,
                cutoff_freq, use_sigma, sigma_type,
                seed=seed if seed is not None else 0, mesh=mesh,
                state_dtype=state_dtype,
                summaries={"z": z, "pseudo_nu": _pseudo_grid()},
                return_chains=need_chains)
            batched_summaries = {i: summ[j] for j, i in enumerate(eligible)}
            if flat is not None:
                batched_chains = {i: flat[j] for j, i in enumerate(eligible)}

    for i_epoch, epoch1 in enumerate(groups):
        detected = set(epoch1.where(nondet=False)["filter"])
        nfilt = len(detected)
        if nfilt < min_nfilt:
            continue

        if nfilt > 1:
            p0 = np.array([10.0, 10.0])
        elif sampler is not None:
            # single-filter epoch: previous posterior's temperature becomes
            # the prior (KDE chaining, reference bolometric.py:753-759)
            priors[0] = KDEPrior(sampler.flatchain[:, 0])
            # (T, R) columns only: with use_sigma the flatchain carries the
            # intrinsic-scatter column, which the 2-parameter lstsq stage and
            # the (nwalkers, 2) guess recentering below must not see
            p0 = np.median(sampler.flatchain[:, :2], axis=0)
        else:
            continue

        mjdavg, dmjd0, dmjd1 = median_and_unc(np.asarray(epoch1["MJD"], float), 100.0)
        record = {"MJD": mjdavg, "dMJD0": dmjd0, "dMJD1": dmjd1, "npoints": nfilt,
                  "filts": "".join([f.char for f in sorted(detected)])}
        if use_src:
            record["source"] = epoch1["source"][0]

        # stage 1: bounded least squares (also recenters the MCMC guesses)
        lstsq, p0 = _lstsq_record(epoch1, z, p0, priors, cutoff_freq)
        record.update(lstsq)

        starting_guesses = rng.normal(size=(nwalkers, 2)) + p0
        starting_guesses[starting_guesses <= 0.0] = 1.0
        labels = ["T (kK)", "R (1000 R$_\\odot$)"]
        if use_sigma:
            starting_guesses = np.append(starting_guesses,
                                         np.abs(rng.normal(size=(nwalkers, 1))), axis=1)
            labels.append("$\\sigma$")

        # stage 2: MCMC posterior (batched chain if precomputed above)
        try:
            if not do_mcmc:
                raise ValueError("do_mcmc=False")
            spectrum_kwargs = {"cutoff_freq": cutoff_freq}
            if i_epoch in batched_summaries:
                record.update(_summary_record(batched_summaries[i_epoch]))
                if i_epoch in batched_chains:
                    sampler = _FlatchainSampler(batched_chains[i_epoch])
                    os.makedirs(outpath, exist_ok=True)
                    if save_chains:
                        np.save(os.path.join(outpath, f"{mjdavg:.3f}.npy"), sampler.flatchain)
                    if save_corners:
                        f4 = spectrum_corner(planck_fast, epoch1, sampler.flatchain, z,
                                             spectrum_kwargs=spectrum_kwargs,
                                             use_sigma=use_sigma, labels=labels,
                                             save_plot_as=os.path.join(outpath, f"{mjdavg:.3f}.pdf"))
                        _pyplot().close(f4)
            else:
                # derive a per-epoch seed (fold_in-style): every epoch's
                # sampler gets an independent, reproducible stream instead of
                # the same one replayed
                seed_i = (None if seed is None else
                          int(np.random.SeedSequence((seed, i_epoch))
                              .generate_state(1)[0] & 0x7FFFFFFF))
                sampler = spectrum_mcmc(planck_fast, epoch1, priors, starting_guesses, z=z,
                                        spectrum_kwargs=spectrum_kwargs, outpath=outpath,
                                        nwalkers=nwalkers, burnin_steps=burnin_steps,
                                        steps=steps, show=show, save_chains=save_chains,
                                        use_sigma=use_sigma, sigma_type=sigma_type,
                                        labels=labels, seed=seed_i, make_corner=save_corners)
                record.update(_mcmc_record(sampler.flatchain, z, cutoff_freq))
        except ValueError as e:
            print(e)
            record.update({field: np.nan for field in _MCMC_FIELDS})

        # stage 3: direct SED integration + colors
        record["L_int"] = integrate_sed(epoch1)
        record.update(_color_record(epoch1, colors))
        _append_record(t0, record)

    # keep deprecated column names for now (reference bolometric.py:824-827)
    for old, new in DEPRECATED_BOLOMETRIC_COLNAMES:
        t0[old] = t0[new]
    warnings.warn("Some column names in the output table have changed (see documentation). "
                  "Please update your code!")

    if save_table_as is not None and t0:
        t0.write(save_table_as, format="ascii.fixed_width_two_line", overwrite=True)

    return t0
