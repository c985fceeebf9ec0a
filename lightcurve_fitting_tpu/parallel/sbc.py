"""Simulation-based calibration of the inference stack (Talts et al. 2018).

Beyond-reference validation harness (the reference offers no way to test
whether its sampler + likelihood + priors are jointly correct; its test
suite spot-checks point values): draw parameters from the prior, simulate
photometry from the model with the *same* Gaussian noise the likelihood
assumes, fit every simulated dataset, and rank each true parameter among
thinned posterior draws. If the whole pipeline is calibrated, every rank
is uniform on {0..L} — any bias, over/under-dispersion, or sampler bug
shows up as a non-uniform rank histogram (Talts et al. 2018, fig. 1).

Batched by construction: the n_sims fits run as ONE
:func:`parallel.population.fit_population` device call (shared compiled
kernel, transients sharded over the mesh), so hundreds of synthetic fits
cost seconds — SBC as a routine check rather than a cluster job.
"""

import numpy as np

from ..models.base import intrinsic_scatter_units

__all__ = ["simulation_based_calibration", "rank_statistic", "plot_sbc"]


def rank_statistic(flatchains, truths, n_ranks=127, seed=0):
    """Ranks of each truth among ``n_ranks`` thinned posterior draws.

    flatchains: (S, M, D) posterior samples; truths: (S, D). Thinning takes
    a random length-``n_ranks`` subset per simulation (Talts+18 prescribe
    approximately independent draws; a seeded choice over the mixed-walker
    flatchain is the standard practical reduction). Returns integer ranks
    (S, D) in [0, n_ranks].
    """
    flatchains = np.asarray(flatchains)
    truths = np.asarray(truths, float)
    S, M, D = flatchains.shape
    n_ranks = int(n_ranks)
    if n_ranks > M:
        # a silent cap would desynchronize the ranks' support from the
        # n_ranks the caller then hands to uniformity_pvalues, leaving the
        # top histogram bins structurally empty (reported as NON-UNIFORM)
        raise ValueError(f"n_ranks = {n_ranks} exceeds the {M} posterior "
                         f"draws per simulation; pass n_ranks <= {M}")
    rng = np.random.default_rng(seed)
    ranks = np.empty((S, D), dtype=int)
    for s in range(S):
        idx = rng.choice(M, size=n_ranks, replace=False)
        ranks[s] = np.sum(flatchains[s, idx] < truths[s][None, :], axis=0)
    return ranks


def _auto_bins(n_sims, n_bins=None):
    """Default bin count: the largest power of two <= 16 with an expected
    count >= 5 per bin (chi-square validity)."""
    if n_bins is not None:
        return int(n_bins)
    n_bins = 16
    while n_bins > 2 and n_sims / n_bins < 5:
        n_bins //= 2
    return n_bins


def uniformity_pvalues(ranks, n_ranks, n_bins=None):
    """Per-parameter chi-square uniformity p-value of the rank histogram.

    ``n_bins`` defaults to :func:`_auto_bins`. (n_ranks + 1) must be
    divisible by n_bins for equal bin widths, which holds for the default
    n_ranks = 2^k - 1.
    """
    from scipy.stats import chisquare

    ranks = np.asarray(ranks)
    S, D = ranks.shape
    n_bins = _auto_bins(S, n_bins)
    if (n_ranks + 1) % n_bins:
        raise ValueError(f"n_ranks+1 = {n_ranks + 1} must be divisible by "
                         f"n_bins = {n_bins}")
    width = (n_ranks + 1) // n_bins
    pvals = np.empty(D)
    for d in range(D):
        counts = np.bincount(ranks[:, d] // width, minlength=n_bins)
        pvals[d] = chisquare(counts).pvalue
    return pvals


def simulation_based_calibration(model, priors, times, filters, p_lo=None,
                                 p_up=None, frac_err=0.05, err_floor_frac=0.1,
                                 n_sims=128, n_ranks=127, n_bins=None,
                                 nwalkers=64, nsteps=500, nsteps_burnin=500,
                                 use_sigma=False, sigma_type="relative",
                                 init="map", seed=0, mesh=None, quiet=False,
                                 **pop_kwargs):
    """Run the full SBC loop for one model + prior choice.

    ``model``: a template instance (carries redshift/cutoff); each
    simulation gets its own instance of the same class. ``times``: 1-D
    epoch grid; ``filters``: band names/Filter objects observed at every
    epoch. Every simulated point gets Gaussian noise with
    ``dy = frac_err * (|y_true| + err_floor_frac * median(|y_true|))`` —
    the floor keeps pre-explosion epochs (zero flux) at finite error, and
    the *fit* uses exactly these dy, so the generative model and the
    likelihood agree (the SBC prerequisite). With ``use_sigma=True`` the
    LAST prior is the intrinsic-scatter parameter: its draw inflates the
    simulation noise to sqrt(dy^2 + (sigma * units)^2) with exactly the
    likelihood's variance model (reference models.py:116-129), and the fit
    samples it alongside the physics parameters.

    ``p_lo``/``p_up`` bound the walker initialization (default: the prior
    bounds via the same rule as the HMC warm start). The fits run as one
    :func:`fit_population` call — pass ``mesh=`` to shard simulations over
    devices, ``init="map"`` (default) to MAP-seed each ensemble. The fits
    use an RNG stream derived from (but independent of) the truth/noise
    stream, so walker initialization cannot correlate with the truths.

    Returns a dict with ``ranks`` (n_sims, ndim), ``truths``, ``p_values``
    (per-parameter chi-square uniformity), ``n_ranks``, ``acceptance``.
    Interpretation: calibrated inference gives uniform ranks (all p well
    above your alpha); a left/right-skewed histogram flags parameter bias,
    a U/n-shape flags under/over-dispersed posteriors (Talts+18 fig. 3).
    Unconverged chains also fail uniformity — SBC validates the pipeline
    *as configured*, so give the fits enough steps.
    """
    from ..lightcurve import LC
    from ..filters import filtdict
    from ..fitting import _hmc_init_window
    from .population import fit_population

    ndim = len(priors)
    n_model = ndim - (1 if use_sigma else 0)
    for k in ("summaries", "return_chains"):
        if k in pop_kwargs:
            # the rank statistic needs the full per-simulation chains; the
            # percentile-summaries fast path cannot feed it
            raise TypeError(f"simulation_based_calibration does not support "
                            f"fit_population's {k!r} option (SBC ranks "
                            "require the full chains)")
    # fail BEFORE the expensive fits: the rank count the chain can support
    # must bin evenly for the chi-square (see uniformity_pvalues)
    n_ranks_eff = min(int(n_ranks), nsteps * nwalkers)
    n_bins_eff = _auto_bins(n_sims, n_bins)
    if (n_ranks_eff + 1) % n_bins_eff:
        raise ValueError(
            f"the chain supports n_ranks = {n_ranks_eff} "
            f"(min(n_ranks, nsteps*nwalkers)), and n_ranks+1 = "
            f"{n_ranks_eff + 1} is not divisible by n_bins = {n_bins_eff}; "
            "pick n_ranks = 2^k - 1 <= nsteps*nwalkers or pass a matching "
            "n_bins")

    f_objs = [f if hasattr(f, "freq_eff") else filtdict[f] for f in filters]
    times = np.asarray(times, float)
    t_full = np.repeat(times, len(f_objs))
    f_full = np.array(f_objs * len(times))

    rng = np.random.default_rng(seed)
    truths = np.column_stack([pri.sample(rng, n_sims) for pri in priors])

    lcs, models = [], []
    for s in range(n_sims):
        y_true = np.asarray(model.evaluate(t_full, f_full,
                                           *truths[s, :n_model]))
        floor = err_floor_frac * np.median(np.abs(y_true)[y_true != 0]) \
            if np.any(y_true != 0) else err_floor_frac
        dy = frac_err * (np.abs(y_true) + floor)
        scale = dy
        if use_sigma:
            # the generative convention MUST match the likelihood's — one
            # shared definition (models.base.intrinsic_scatter_units)
            sigma_units = intrinsic_scatter_units(dy, sigma_type, xp=np)
            scale = np.sqrt(dy ** 2 + (truths[s, -1] * sigma_units) ** 2)
        y = y_true + rng.normal(scale=scale)
        lc = LC([t_full, f_full, y, dy],
                names=["MJD", "filter", model.output_quantity,
                       "d" + model.output_quantity])
        lcs.append(lc)
        # clone_for carries subclass physics options (ShockCooling n/RW)
        models.append(model.clone_for(lc))

    if p_lo is None or p_up is None:
        lo, up = _hmc_init_window(priors, None, None, ndim)
        p_lo = lo if p_lo is None else np.asarray(p_lo, float)
        p_up = up if p_up is None else np.asarray(p_up, float)

    # independent streams for the fits and the rank thinning (derived from
    # the same master seed, so the whole procedure stays reproducible)
    fit_seed = int(rng.integers(2 ** 31 - 1))
    rank_seed = int(rng.integers(2 ** 31 - 1))
    flat, acc = fit_population(models, lcs, priors, p_lo=p_lo, p_up=p_up,
                               nwalkers=nwalkers, nsteps=nsteps,
                               nsteps_burnin=nsteps_burnin, seed=fit_seed,
                               use_sigma=use_sigma, sigma_type=sigma_type,
                               init=init, mesh=mesh, **pop_kwargs)

    ranks = rank_statistic(flat, truths, n_ranks=n_ranks_eff, seed=rank_seed)
    pvals = uniformity_pvalues(ranks, n_ranks_eff, n_bins=n_bins_eff)
    out = {"ranks": ranks, "truths": truths, "p_values": pvals,
           "n_ranks": n_ranks_eff, "acceptance": acc}
    if not quiet:
        worst = float(pvals.min())
        verdict = ("consistent with calibrated inference" if worst > 0.01
                   else "NON-UNIFORM ranks — biased or unconverged inference")
        pv = ", ".join(f"{p:.3f}" for p in pvals)
        print(f"SBC over {n_sims} prior-predictive fits: rank-uniformity "
              f"p-values [{pv}] — {verdict}")
    return out


def plot_sbc(result, model=None, n_bins=None, save_plot_as=""):
    """Rank histograms per parameter with the 99% uniform band
    (Talts+18 fig. 2 style). Bins proportionally (``rank * n_bins //
    (L + 1)``) so any (n_ranks, n_bins) combination renders — bin widths
    can differ by one rank value, which matters for the chi-square test
    (:func:`uniformity_pvalues` stays strict) but not for a plot."""
    import matplotlib.pyplot as plt
    from scipy.stats import binom

    ranks = np.asarray(result["ranks"])
    S, D = ranks.shape
    L = result["n_ranks"]
    n_bins = _auto_bins(S, n_bins)
    labels = (list(model.axis_labels) if model is not None
              else [f"param {d}" for d in range(D)])
    if len(labels) < D:
        # a use_sigma run ranks the intrinsic-scatter parameter too
        labels += [r"$\sigma$"] + [f"param {d}" for d in range(len(labels) + 1, D)]
    fig, axes = plt.subplots(1, D, figsize=(3 * D, 2.8), squeeze=False)
    lo, hi = binom.ppf([0.005, 0.995], S, 1.0 / n_bins)
    for d, ax in enumerate(axes[0]):
        counts = np.bincount(ranks[:, d] * n_bins // (L + 1),
                             minlength=n_bins)
        ax.bar(np.arange(n_bins), counts, width=0.92, color="#4878cf")
        ax.axhspan(lo, hi, color="0.85", zorder=0)
        ax.axhline(S / n_bins, color="0.4", lw=1, ls="--")
        ax.set_xlabel(labels[d])
        ax.set_yticks([])
    fig.tight_layout()
    if save_plot_as:
        fig.savefig(save_plot_as)
        print("saving figure as " + save_plot_as)
    return fig
