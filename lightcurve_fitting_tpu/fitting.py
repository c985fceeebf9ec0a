"""Model-fit drivers and posterior visualization.

Covers the behavior of the reference ``lightcurve_fitting/fitting.py``:
``lightcurve_mcmc`` (fitting.py:16-168), ``lightcurve_corner`` (:171-277),
``lightcurve_model_plot`` (:280-429), and ``format_credible_interval``
(:432-494) — plus capabilities the reference does not have: automatic
multi-chip walker sharding, one-call gradient-based NUTS/HMC
(``lightcurve_hmc``), instant MAP + Laplace fits (``lightcurve_map``),
stepping-stone evidence (``lightcurve_evidence``), and parallel tempering
(``lightcurve_ptmcmc``).

Accelerator design: the log-posterior is a pure jax function (priors + model
likelihood over static photometry arrays); the emcee loop becomes a single
jit-compiled ``lax.scan`` of the stretch move with all walkers batched by
``vmap`` (see ``parallel/sampler.py``) where the reference performs 2e5
serial Python posterior calls.
Sampler selection is automatic: multiple visible devices shard the walker
axis over the mesh (``parallel/mesh.py``); small ensembles can batch R
independent replicas into one vmapped scan to amortize the per-dispatch
floor.
"""

import os
import re
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from .models import UniformPrior, GaussianPrior, CompanionShocking, BaseCompanionShocking
from .lightcurve import filter_legend, flux2mag
from .filters import filtdict
from .parallel.sampler import EnsembleSampler
from .parallel.evidence import _LRUCache
from .utils import units as u
from .utils.corner import corner as _corner

__all__ = ["lightcurve_mcmc", "lightcurve_hmc", "lightcurve_map",
           "lightcurve_evidence", "lightcurve_ptmcmc", "compare_models",
           "goodness_of_fit", "lightcurve_corner", "lightcurve_model_plot",
           "format_credible_interval", "make_log_posterior"]

PRIOR_WARNING = "The p_max/p_min keywords are deprecated. Use the priors keyword instead."
MODEL_KWARGS_WARNING = "The model_kwargs keyword is deprecated. These are now included in the model intialization."

_STYLE = os.path.join(os.path.dirname(__file__), "serif.mplstyle")

# goodness_of_fit compiled kernels, keyed on model/data/variance semantics
# (the population/ladder pattern); LRU-bounded like the ladder cache
_GOF_CACHE = _LRUCache(16)  # shared by the chi2 and pointwise-ll kernels


def make_log_posterior(model, lc, priors, use_sigma=False, sigma_type="relative"):
    """Build the pure jax log-posterior ``fn(p[ndim]) -> float``: sum of prior
    log-densities (-inf outside bounds) plus the Gaussian log-likelihood
    (reference fitting.py:121-128, without the Python early-exit — models are
    NaN-safe so the likelihood is always evaluated in-graph)."""
    ll = model.make_log_likelihood(lc, use_sigma=use_sigma, sigma_type=sigma_type)

    def log_posterior(p):
        log_prior = 0.0
        for i, prior in enumerate(priors):
            log_prior = log_prior + prior(p[i])
        ll_val = ll(p)
        ll_val = jnp.where(jnp.isfinite(ll_val), ll_val, -jnp.inf)
        return jnp.where(jnp.isfinite(log_prior), log_prior + ll_val, -jnp.inf)

    return log_posterior


# --------------------------------------------------------------------------
# fit setup helpers shared by the MCMC and HMC drivers
# --------------------------------------------------------------------------

def _derive_fit_columns(lc, model):
    """Materialize the column the model is fit against, from magnitudes when
    present (reference fitting.py:68-72); synthetic tables that already carry
    the quantity are used as-is."""
    needs_rebuild = "mag" in lc.colnames or model.output_quantity not in lc.colnames
    if not needs_rebuild:
        return
    if model.output_quantity == "flux":
        lc.calcFlux()
    elif model.output_quantity == "lum":
        lc.calcAbsMag()
        lc.calcLum()


def _ensure_sigma_param(model, use_sigma):
    """Append the intrinsic-scatter parameter to the model's metadata once
    (reference fitting.py:74-76)."""
    if use_sigma and model.input_names[-1] != "\\sigma":
        model.input_names = model.input_names + ["\\sigma"]
        model.units = model.units + [u.dimensionless_unscaled]


def _deprecated_bound(arg, ndim, default):
    """Validate one of the deprecated p_min/p_max keywords; warn when used
    (reference fitting.py:80-96)."""
    if arg is None:
        return np.tile(default, ndim)
    if len(arg) != ndim:
        raise Exception(PRIOR_WARNING)
    warnings.warn(PRIOR_WARNING)
    return np.array(arg, float)


def _init_window(p_lo, p_up, p_min, ndim):
    """The uniform-random initialization box for walker starting positions."""
    if p_lo is None:
        p_lo = p_min
    elif len(p_lo) == ndim:
        p_lo = np.array(p_lo, float)
    else:
        raise Exception("p_lo must have length {:d}".format(ndim))
    if len(p_up) == ndim:
        p_up = np.array(p_up, float)
    else:
        raise Exception("p_up must have length {:d}".format(ndim))
    return p_lo, p_up


def _check_window_inside_priors(model, priors, p_lo, p_up):
    """Starting guesses outside the prior support would initialize walkers at
    -inf (reference fitting.py:115-119)."""
    for param, prior, lo, up in zip(model.input_names, priors, p_lo, p_up):
        support_lo = getattr(prior, "p_min", -np.inf)
        support_up = getattr(prior, "p_max", np.inf)
        if lo < support_lo:
            raise Exception(f"starting guess for {param} (p_lo = {lo}) is outside prior "
                            f"(p_min = {support_lo})")
        if up > support_up:
            raise Exception(f"starting guess for {param} (p_up = {up}) is outside prior "
                            f"(p_max = {support_up})")


def _state_rescaling(state_dtype, p_lo, p_up):
    """Resolve the walker-state dtype + affine rescaling for this run.

    ``state_dtype="auto"``: on accelerators the walker state runs in float32
    over the rescaled space ``q = (p - mid) / halfwidth`` of the init window
    (O(1) values make f32 safe; the stretch move is affine-equivariant so
    statistics are identical). On CPU (where f64 is native speed) the
    state stays absolute float64. Pass ``np.float32``/``np.float64`` to
    force either mode.
    """
    if state_dtype == "auto":
        use_f32 = jax.default_backend() != "cpu"
    else:
        use_f32 = np.dtype(state_dtype) == np.float32
    if not use_f32:
        return {}
    offset = (np.asarray(p_lo, float) + np.asarray(p_up, float)) / 2.0
    scale = (np.asarray(p_up, float) - np.asarray(p_lo, float)) / 2.0
    scale = np.maximum(scale, 1e-12 * np.maximum(1.0, np.abs(offset)))
    # inflate the scale a hair so the window edges map strictly INSIDE
    # |q| < 1: otherwise a draw within half an f32 ulp of the window edge
    # (common when p_lo/p_up equal the prior support) rounds to exactly the
    # bound, the open-interval prior returns -inf, and the initial-state
    # check aborts the run probabilistically at large walker counts
    scale = scale * (1.0 + 1e-6)
    import jax.numpy as jnp
    return {"dtype": jnp.float32, "param_offset": offset, "param_scale": scale}


def _select_sampler(log_posterior, nwalkers, ndim, seed, replicas=1, mesh=None,
                    shard=None, store_dtype=None, state_kw=None):
    """Choose the sampler implementation for this run.

    * ``shard=None`` (auto): shard the walker axis over the device mesh when
      more than one device is visible and the half-ensemble divides evenly;
      otherwise run single-device.
    * ``replicas > 1``: batch that many independent ensembles in one vmapped
      scan (single-device; amortizes the per-dispatch floor at small walker
      counts).
    """
    state_kw = state_kw or {}
    if replicas > 1:
        if shard or mesh is not None:
            raise ValueError("replicas > 1 and walker sharding are mutually exclusive")
        return EnsembleSampler(nwalkers, ndim, log_posterior, seed=seed,
                               replicas=replicas, store_dtype=store_dtype,
                               **state_kw)

    n_dev = mesh.devices.size if mesh is not None else jax.device_count()
    divisible = (nwalkers // 2) % n_dev == 0
    # explicit requests (shard=True or a user-supplied mesh) always shard —
    # or fail loudly; auto mode shards only when it can and it helps
    explicit = shard is True or (shard is None and mesh is not None)
    if shard is not False and (explicit or (n_dev > 1 and divisible)):
        from .parallel.mesh import ShardedEnsembleSampler, walker_mesh
        if not divisible:
            raise ValueError(f"nwalkers/2 = {nwalkers // 2} must divide evenly over "
                             f"{n_dev} devices for sharding; pass shard=False or "
                             "adjust nwalkers")
        # honor the user mesh's own axis name (a reused epoch/transient mesh
        # would otherwise hit KeyError('walkers') inside the sharded step)
        return ShardedEnsembleSampler(nwalkers, ndim, log_posterior,
                                      mesh=mesh or walker_mesh(), seed=seed,
                                      axis_name=(mesh.axis_names[0] if mesh is not None
                                                 else "walkers"),
                                      store_dtype=store_dtype, **state_kw)
    return EnsembleSampler(nwalkers, ndim, log_posterior, seed=seed,
                           store_dtype=store_dtype, **state_kw)


def _plot_chain_histories(ax_column, sampler, model, title):
    """One column of per-parameter chain-history traces (reference
    fitting.py:135-166)."""
    for i, ax in enumerate(ax_column):
        ax.plot(sampler.chain[:, :, i].T, "k", alpha=0.2)
        ax.set_ylabel(model.axis_labels[i])
    ax_column[0].set_title(title)
    ax_column[-1].set_xlabel("Step Number")


def _report_convergence(sampler, model, nsamples):
    """Post-run convergence summary: mean acceptance and per-parameter
    integrated autocorrelation time / effective sample size. The reference
    computes neither (SURVEY.md §5); R-hat is deliberately not quoted for
    coupled ensemble walkers (see parallel/diagnostics.py)."""
    accept = float(np.mean(sampler.acceptance_fraction))
    lines = [f"mean acceptance fraction: {accept:.3f}"]
    try:
        tau = sampler.get_autocorr_time()
        for name, t in zip(model.input_names, tau):
            ess = nsamples / max(t, 1.0)
            lines.append(f"  {name}: tau = {t:.1f} steps, ESS ~ {ess:.0f}")
    except Exception as exc:  # diagnostics must never kill a finished fit
        lines.append(f"  (autocorrelation estimate unavailable: {exc})")
    print("\n".join(lines))


def lightcurve_mcmc(lc, model, priors=None, p_min=None, p_max=None, p_lo=None, p_up=None,
                    nwalkers=100, nsteps=1000, nsteps_burnin=1000, model_kwargs=None,
                    show=False, save_plot_as="", save_sampler_as="", use_sigma=False,
                    sigma_type="relative", seed=None, replicas=1, mesh=None, shard=None,
                    store_dtype=None, init="window", quiet=False,
                    checkpoint_every=None, checkpoint_file=None, resume_from=None,
                    state_dtype="auto"):
    """Fit an analytical model to observed photometry with ensemble MCMC.

    Same signature and behavior as the reference (fitting.py:16-168) plus:

    * ``seed`` for reproducible chains;
    * ``shard``/``mesh`` — walker sharding over the device mesh. Default
      (``shard=None``) auto-enables when >1 device is visible and nwalkers/2
      divides the mesh; the public entry point is the product surface, so a
      multi-device user gets every device without building a sampler by hand;
    * ``replicas`` — run R independent ensembles of ``nwalkers`` in one
      vmapped scan (pooled in ``flatchain``); recovers large-batch
      throughput at reference-default walker counts;
    * ``init`` — ``"window"`` (reference behavior: uniform in [p_lo, p_up])
      or ``"map"``: seed walkers from the Laplace approximation at the MAP
      (:func:`lightcurve_map`). On thin-ridge posteriors wide-start
      ensembles spend thousands of steps contracting (VALIDATION.md);
      MAP-seeded walkers start inside the typical set, so a short burn-in
      suffices. Parameters pinned at a prior bound are jittered just inside
      the support (a zero-spread dimension would freeze the stretch move);
    * ``quiet=False`` prints acceptance + autocorrelation/ESS after the
      production run;
    * ``checkpoint_every=N`` with ``checkpoint_file=path.npz`` saves the full
      sampler state (walker positions, RNG counter, chain history, phase)
      every N steps; ``resume_from=path.npz`` restores it and continues.
      Per-step RNG keys are folded from the global step index, so a killed
      run resumed from its checkpoint reproduces the uninterrupted chain
      EXACTLY (requires the same seed/nwalkers/nsteps_burnin). Each save
      rewrites the accumulated chain history (atomically), so checkpoint I/O
      grows with run length — for very long large-ensemble runs pick a
      ``checkpoint_every`` that keeps nsteps/checkpoint_every modest;
    * ``state_dtype`` — ``"auto"`` (default) runs float32 walker state over
      the affine-rescaled init window on accelerators (identical
      statistics: the stretch move is
      affine-equivariant and the likelihood still receives float64
      parameters); CPU keeps absolute float64. Force with
      ``np.float32``/``np.float64``.

    Returns an :class:`~lightcurve_fitting_tpu.parallel.sampler.EnsembleSampler`
    exposing the emcee attributes the reference workflow uses (``flatchain``,
    ``chain``).
    """
    if model_kwargs is not None:
        raise Exception(MODEL_KWARGS_WARNING)

    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams

    p_min = _deprecated_bound(p_min, ndim, -np.inf)
    p_max = _deprecated_bound(p_max, ndim, np.inf)
    p_lo, p_up = _init_window(p_lo, p_up, p_min, ndim)

    if priors is None:
        priors = [UniformPrior(lo, hi) for lo, hi in zip(p_min, p_max)]
    elif len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    _check_window_inside_priors(model, priors, p_lo, p_up)

    log_posterior = make_log_posterior(model, lc, priors, use_sigma, sigma_type)
    sampler = _select_sampler(log_posterior, nwalkers, ndim, seed, replicas=replicas,
                              mesh=mesh, shard=shard, store_dtype=store_dtype,
                              state_kw=_state_rescaling(state_dtype, p_lo, p_up))

    if checkpoint_every is not None and not checkpoint_file:
        raise ValueError("checkpoint_every requires checkpoint_file")

    if resume_from is not None:
        meta = sampler.load_checkpoint(resume_from)
        phase = str(meta.get("phase", "production"))
        phase_done = int(meta.get("steps_done", 0))
        if "nsteps_burnin" in meta and int(meta["nsteps_burnin"]) != nsteps_burnin:
            raise ValueError(f"checkpoint nsteps_burnin {int(meta['nsteps_burnin'])} "
                             f"!= {nsteps_burnin}: resume with the original value")
        starting_guesses = None
    else:
        phase, phase_done = "burnin", 0
        rng = np.random.RandomState(seed) if seed is not None else np.random
        if init == "map":
            starting_guesses = _laplace_starting_guesses(
                lc, model, priors, p_lo, p_up, sampler.total_walkers,
                use_sigma, sigma_type, seed, quiet, rng)
        elif init == "window":
            starting_guesses = rng.rand(sampler.total_walkers, ndim) * (p_up - p_lo) + p_lo
        else:
            raise ValueError('init must be "window" or "map"')

    def _advance(phase_name, total, done, initial, desc, skip_check=False):
        """Run one phase in checkpoint_every-sized segments, saving state
        after each (the chain is segmentation-invariant: per-step keys fold
        the global step index)."""
        while done < total:
            seg = total - done if checkpoint_every is None \
                else min(checkpoint_every, total - done)
            sampler.run_mcmc(initial, seg, progress=not quiet,
                             progress_kwargs={"desc": desc},
                             skip_initial_state_check=skip_check)
            initial = None
            done += seg
            if checkpoint_file:
                sampler.save_checkpoint(checkpoint_file, extra={
                    "phase": phase_name, "steps_done": done,
                    "nsteps_burnin": nsteps_burnin, "nsteps": nsteps})

    fig = None
    if show or save_plot_as:
        import matplotlib.pyplot as plt
    if phase == "burnin":
        _advance("burnin", nsteps_burnin, phase_done, starting_guesses, " Burn-in")
        if show or save_plot_as:
            fig, ax = plt.subplots(ndim, 2, figsize=(12.0, 2.0 * ndim), squeeze=False)
            _plot_chain_histories(ax[:, 0], sampler, model, "During Burn In")
        sampler.reset()
        if checkpoint_file:
            # mark the phase boundary so a kill between burn-in and production
            # resumes into production, not a repeated burn-in
            sampler.save_checkpoint(checkpoint_file, extra={
                "phase": "production", "steps_done": 0,
                "nsteps_burnin": nsteps_burnin, "nsteps": nsteps})
        # nsteps_burnin=0 skips the burn-in loop entirely, so the starting
        # guesses were never delivered to the sampler — seed production with
        # them directly (and keep the initial-state check, since these are
        # raw guesses, not an already-validated walker state)
        prod_initial = starting_guesses if nsteps_burnin <= 0 else None
        _advance("production", nsteps, 0, prod_initial, "Sampling",
                 skip_check=prod_initial is None)
    else:
        if (show or save_plot_as) and not quiet:
            print("resuming mid-production: burn-in chain history is not in the "
                  "checkpoint, plotting the production chains only")
        _advance("production", nsteps, phase_done, None, "Sampling", skip_check=True)
        if show or save_plot_as:
            fig, ax = plt.subplots(ndim, 2, figsize=(12.0, 2.0 * ndim), squeeze=False)
    # flatchain is a property that re-materializes the absolute-space f64
    # chain on every access — take it at most once for the save + diagnostics
    flat = sampler.flatchain if (save_sampler_as or not quiet) else None
    if save_sampler_as:
        np.save(save_sampler_as, flat)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        _report_convergence(sampler, model, flat.shape[0])
        try:
            goodness_of_fit(lc, model, flat,
                            use_sigma=use_sigma, sigma_type=sigma_type)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")

    if fig is not None:
        _plot_chain_histories(ax[:, 1], sampler, model, "After Burn In")
        for axis in ax[:, 1]:
            axis.yaxis.set_label_position("right")
            axis.yaxis.tick_right()
        fig.tight_layout()
        if save_plot_as:
            print("saving chain plot as " + save_plot_as)
            fig.savefig(save_plot_as)
        if show:
            plt.show()

    return sampler


# --------------------------------------------------------------------------
# gradient-based HMC driver (no reference counterpart: numpy models are not
# differentiable; this framework's kernels are NaN-free under jax.grad)
# --------------------------------------------------------------------------

def _hmc_init_window(priors, p_lo, p_up, ndim):
    """Initialization box for the warm-start ensemble: explicit p_lo/p_up when
    given (each side independently — a lone p_up caps the prior-derived
    window instead of being dropped), else prior bounds, else mean +/- 2
    stddev for Gaussian priors."""
    if p_lo is not None and p_up is not None:
        return np.array(p_lo, float), np.array(p_up, float)
    explicit_lo = None if p_lo is None else np.array(p_lo, float)
    explicit_up = None if p_up is None else np.array(p_up, float)
    lo = np.empty(ndim)
    up = np.empty(ndim)
    for i, prior in enumerate(priors):
        bound_lo = getattr(prior, "p_min", -np.inf)
        bound_up = getattr(prior, "p_max", np.inf)
        if isinstance(prior, GaussianPrior):
            bound_lo = max(bound_lo, prior.mean - 2.0 * prior.stddev)
            bound_up = min(bound_up, prior.mean + 2.0 * prior.stddev)
        if explicit_lo is not None:
            bound_lo = explicit_lo[i]
        if explicit_up is not None:
            bound_up = explicit_up[i]
        if not (np.isfinite(bound_lo) and np.isfinite(bound_up)):
            raise ValueError(f"prior {i} has unbounded support; pass p_lo/p_up "
                             "to initialize the HMC warm start")
        lo[i], up[i] = bound_lo, bound_up
    return lo, up


class _HMCFitResult:
    """HMC chains mapped back to the model's parameter space, exposing the
    sampler surface the rest of the workflow expects (``flatchain``,
    ``chain``, ``acceptance_fraction``)."""

    def __init__(self, hmc, x_chain):
        self.sampler = hmc              # the raw whitened-space HMCSampler
        self._chain = x_chain           # (nsteps, nchains, ndim), x-space
        self.step_size = hmc.step_size
        self.acceptance_fraction = hmc.acceptance_fraction

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self._chain.shape[-1])


def lightcurve_hmc(lc, model, priors, p_lo=None, p_up=None, nchains=16, nsamples=1000,
                   n_warmup=800, sampler="nuts", max_depth=9, n_leapfrog=32,
                   use_sigma=False, sigma_type="relative", seed=None,
                   warmup_walkers=64, warmup_steps=300,
                   save_sampler_as="", quiet=False, mesh=None,
                   checkpoint_every=None, checkpoint_file=None, resume_from=None):
    """One-call gradient-based fit of a light-curve model (NUTS by default).

    The flagship beyond-reference capability as a product API, shaped like
    :func:`lightcurve_mcmc` (reference fitting.py:16-168): takes an LC +
    model + priors, handles the sigma parameter, returns a result with
    ``flatchain``/``chain``/``acceptance_fraction`` in parameter space.

    Geometry is handled automatically (the manual ``init_scales`` tuning the
    raw samplers need):

    1. a short stretch-move ensemble run locates the typical set;
    2. box prior bounds are removed by a Stan-style sigmoid/exp bijection
       (:class:`~.parallel.hmc.BoundsTransform`, with log-Jacobian) so
       posterior mass piled against a bound no longer collapses the adapted
       step size;
    3. the warm samples' full covariance whitens the unbounded space
       (:class:`~.parallel.hmc.WhitenedPosterior`), aligning the unit mass
       with ridge-shaped degeneracies;
    4. ``sampler="nuts"`` (default) runs the no-U-turn sampler in whitened
       space — dynamic trajectories handle the residual nonlinear ridge
       (R-hat ~ 1.02 on the flagship posterior, VALIDATION.md);
       ``sampler="hmc"`` uses fixed ``n_leapfrog`` trajectories instead.
    5. Chains are mapped back through both bijections.

    ``mesh``: a 1-D :class:`jax.sharding.Mesh` shards the NUTS/HMC chain
    axis *and* the warm-start ensemble's walker axis across its devices —
    the full gradient stack scales over a device mesh like the stretch-move drivers
    (``nchains`` and ``warmup_walkers/2`` must divide the mesh size; the
    warm-up walker count is rounded up automatically).

    ``checkpoint_every=N`` with ``checkpoint_file``: once adaptation is done,
    production runs in N-sample segments, each saving the full sampler state
    plus the whitening transform; ``resume_from`` restores it and continues
    — the resumed chain is bit-identical to the uninterrupted one (index-
    folded per-step keys). The warm start + warmup are atomic: a kill before
    the first checkpoint restarts from scratch.
    """
    from .parallel.hmc import HMCSampler, BoundsTransform, WhitenedPosterior
    from .parallel.nuts import NUTSSampler

    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams
    if len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    if sampler not in ("nuts", "hmc"):
        raise ValueError('sampler must be "nuts" or "hmc"')

    log_posterior = make_log_posterior(model, lc, priors, use_sigma, sigma_type)
    bounds = BoundsTransform([getattr(p, "p_min", -np.inf) for p in priors],
                             [getattr(p, "p_max", np.inf) for p in priors])
    if checkpoint_every is not None and not checkpoint_file:
        raise ValueError("checkpoint_every requires checkpoint_file")

    def make_engine(white):
        def log_posterior_w(w):
            uvec = white.to_u(w)
            return log_posterior(bounds.to_bounded(uvec)) + bounds.log_jacobian(uvec)

        if sampler == "nuts":
            return NUTSSampler(nchains, ndim, log_posterior_w, max_depth=max_depth,
                               seed=seed, mesh=mesh)
        return HMCSampler(nchains, ndim, log_posterior_w, n_leapfrog=n_leapfrog,
                          seed=seed, mesh=mesh)

    if resume_from is not None:
        # the whitening map must be bit-identical to the original run's; it
        # rides in the checkpoint so the warm phase is skipped entirely
        ck = np.load(resume_from)
        if str(ck["extra_sampler"][()]) != sampler:
            raise ValueError(f"checkpoint was a {ck['extra_sampler'][()]} run, "
                             f"not {sampler}")
        white = WhitenedPosterior.from_moments(ck["extra_white_mean"],
                                               ck["extra_white_L"])
        engine = make_engine(white)
        engine.load_checkpoint(resume_from)
        done = engine._nsteps
        pos = engine._last_pos
    else:
        lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)

        # ensemble warm start: typical-set location + covariance + seeds
        rng = np.random.RandomState(seed) if seed is not None else np.random
        if mesh is None:
            warm = EnsembleSampler(warmup_walkers, ndim, log_posterior, seed=seed)
        else:
            from .parallel.mesh import ShardedEnsembleSampler
            n_dev = int(mesh.devices.size)
            if nchains % n_dev:
                raise ValueError(f"nchains={nchains} must be divisible by the mesh "
                                 f"size {n_dev}")
            if (warmup_walkers // 2) % n_dev:
                warmup_walkers = 2 * n_dev * (warmup_walkers // (2 * n_dev) + 1)
            warm = ShardedEnsembleSampler(warmup_walkers, ndim, log_posterior,
                                          mesh=mesh, axis_name=mesh.axis_names[0],
                                          seed=seed)
        guesses = rng.rand(warmup_walkers, ndim) * (up - lo) + lo
        warm.run_mcmc(guesses, warmup_steps, progress=not quiet,
                      progress_kwargs={"desc": " HMC warm start"})
        warm_flat = warm.get_chain(flat=True, discard=warmup_steps // 2)
        warm_logp = warm.get_log_prob(flat=True, discard=warmup_steps // 2)

        warm_u = bounds.to_unbounded(warm_flat)
        white = WhitenedPosterior(warm_u)

        # seed chains from the warm draws already inside the typical set: short
        # warm runs still carry low-probability stragglers from the contraction
        # transient, and a chain seeded on one wastes its whole warmup escaping
        good = np.flatnonzero(warm_logp >= np.median(warm_logp))
        seeds = good[rng.choice(good.size, nchains, replace=good.size < nchains)]
        engine = make_engine(white)
        done = 0
        pos = white.to_w(warm_u[seeds])

    while done < nsamples:
        seg = nsamples - done if checkpoint_every is None \
            else min(checkpoint_every, nsamples - done)
        pos = engine.run_mcmc(pos, seg, n_warmup=n_warmup if done == 0 else 0)
        done += seg
        if checkpoint_file:
            engine.save_checkpoint(checkpoint_file, extra={
                "sampler": sampler, "nsamples": nsamples,
                "white_mean": white.mean, "white_L": white.L})

    u_chain = white.u_from_w_chain(engine._chain)
    x_chain = np.asarray(bounds.to_bounded(jnp.asarray(u_chain)))
    result = _HMCFitResult(engine, x_chain)

    if save_sampler_as:
        np.save(save_sampler_as, result.flatchain)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        from .parallel.diagnostics import rank_normalized_split_rhat
        extra = ""
        if sampler == "nuts":
            extra = (f", mean tree depth {engine.mean_tree_depth:.1f}, "
                     f"divergence rate {engine.divergence_rate:.3f}")
        print(f"{sampler.upper()}: step size {engine.step_size:.3g}, mean acceptance "
              f"{float(engine.acceptance_fraction.mean()):.3f}{extra}")
        rhat = rank_normalized_split_rhat(x_chain)
        for name, r in zip(model.input_names, np.atleast_1d(rhat)):
            print(f"  {name}: rank-normalized R-hat = {r:.3f}  (independent chains)")
        try:
            goodness_of_fit(lc, model, result.flatchain,
                            use_sigma=use_sigma, sigma_type=sigma_type)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


def _laplace_starting_guesses(lc, model, priors, p_lo, p_up, n_walkers,
                              use_sigma, sigma_type, seed, quiet, rng):
    """Walker starting positions drawn from the Laplace approximation at the
    MAP (``init="map"``). Draws outside the prior support, and parameters
    pinned at a bound (zero Laplace variance), are jittered uniformly into a
    thin band just inside the bound so every dimension keeps nonzero spread."""
    result = lightcurve_map(lc, model, priors, p_lo=p_lo, p_up=p_up,
                            use_sigma=use_sigma, sigma_type=sigma_type,
                            seed=seed, nsamples=n_walkers, quiet=quiet)
    draws = result.flatchain[:n_walkers].copy()
    lo_s = np.array([getattr(p, "p_min", -np.inf) for p in priors])
    up_s = np.array([getattr(p, "p_max", np.inf) for p in priors])
    width = np.where(np.isfinite(up_s - lo_s), up_s - lo_s,
                     np.maximum(np.abs(result.parameters), 1.0))
    band = 1e-3 * width
    jitter = rng.rand(*draws.shape)
    # pinned columns carry zero Laplace variance: spread them through the
    # thin band just inside their bound (which bound: the one the MAP sits on)
    pin_up = result.at_bound & (up_s - result.parameters < result.parameters - lo_s)
    low_viol = (draws <= lo_s) | (result.at_bound & ~pin_up)
    up_viol = (draws >= up_s) | pin_up
    draws = np.where(low_viol, lo_s + band * jitter, draws)
    draws = np.where(up_viol, up_s - band * jitter, draws)
    return draws


class _MAPFitResult:
    """MAP point estimate plus its Laplace approximation, exposing the same
    ``flatchain`` surface as the samplers so corner/model plots work directly.

    Attributes: ``parameters`` (ndim,), ``log_posterior`` (float at the mode),
    ``covariance`` (ndim, ndim), ``stderr`` (ndim,), ``at_bound`` (bool mask:
    parameter pinned against a prior bound — its stderr is 0 and the
    curvature of the others is conditional on the pinned value),
    ``covariance_ok`` (False when the free-parameter curvature is not
    positive definite; the diagonal is then order-of-magnitude only), and
    ``flatchain``: Gaussian draws from the Laplace approximation, pinned
    parameters held at the bound (a boundary mode is really half-Gaussian —
    use MCMC/HMC for honest tails there)."""

    def __init__(self, parameters, log_posterior, covariance, covariance_ok,
                 at_bound, nsamples, seed):
        self.parameters = parameters
        self.log_posterior = log_posterior
        self.covariance = covariance
        self.covariance_ok = covariance_ok
        self.at_bound = at_bound
        self.stderr = np.sqrt(np.maximum(np.diag(covariance), 0.0))
        rng = np.random.default_rng(seed)
        self.flatchain = rng.multivariate_normal(parameters, covariance,
                                                 size=nsamples,
                                                 method="eigh")


def lightcurve_map(lc, model, priors, p_lo=None, p_up=None, n_starts=64,
                   n_iter=1000, learning_rate=0.05, use_sigma=False,
                   sigma_type="relative", seed=None, nsamples=1000, quiet=False):
    """One-call maximum-a-posteriori fit with Laplace uncertainties.

    The instant-answer counterpart to :func:`lightcurve_mcmc`: a multi-start
    Adam ascent of the log-posterior (all ``n_starts`` starting points share
    one jitted scan — see ``parallel/optimize.py``), with prior box bounds
    enforced by the same sigmoid/exp bijection the HMC driver uses, and the
    posterior curvature at the mode inverted into a covariance. Runs in well
    under a second where a full MCMC fit takes minutes; the reference has no
    optimizer path for light-curve models at all (its only least-squares fit
    is the per-epoch blackbody, reference bolometric.py:483-534).

    The MAP is taken in the model's own parameter space (no bijection
    Jacobian in the objective — the transform only keeps iterates inside the
    prior box).

    Returns a :class:`_MAPFitResult`; ``result.flatchain`` (Laplace draws)
    feeds :func:`lightcurve_corner` unchanged.
    """
    from .parallel.hmc import BoundsTransform
    from .parallel.optimize import multistart_maximize, laplace_covariance

    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams
    if len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))

    log_posterior = make_log_posterior(model, lc, priors, use_sigma, sigma_type)
    lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)
    bounds = BoundsTransform([getattr(p, "p_min", -np.inf) for p in priors],
                             [getattr(p, "p_max", np.inf) for p in priors])

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(lo, up, size=(n_starts, ndim))
    u0 = bounds.to_unbounded(x0)
    u_fin, logp_fin = multistart_maximize(
        lambda uvec: log_posterior(bounds.to_bounded(uvec)), u0,
        n_iter=n_iter, learning_rate=learning_rate)
    logp_fin = np.asarray(logp_fin)
    if not np.isfinite(logp_fin).any():
        raise RuntimeError("no optimizer start reached finite posterior "
                           "probability; widen p_lo/p_up or check the priors")
    best = int(np.nanargmax(np.where(np.isfinite(logp_fin), logp_fin, -np.inf)))
    x_map = np.asarray(bounds.to_bounded(u_fin[best]))

    # KKT-style boundary-mode detection: a parameter sits ON a prior bound
    # (not merely near it) when the iterate is within 1e-3 of the bound in
    # scaled units AND the x-space gradient still pushes outward — at an
    # interior mode the gradient vanishes, so this cannot misfire on a
    # genuinely tight interior posterior. Laplace then runs conditional on
    # the pinned values (the full-space quadratic model is wrong at a
    # boundary mode: the gradient does not vanish there).
    g_map = np.asarray(jax.grad(log_posterior)(jnp.asarray(x_map)))
    scale = np.where(bounds.two_sided, bounds.upper - bounds.lower,
                     np.maximum(np.abs(x_map), 1.0))
    near_lo = np.isfinite(bounds.lower) & (x_map - bounds.lower < 1e-3 * scale)
    near_up = np.isfinite(bounds.upper) & (bounds.upper - x_map < 1e-3 * scale)
    at_bound = (near_lo & (g_map < 0)) | (near_up & (g_map > 0))
    # x_map itself stays strictly inside the box (priors are exclusive at the
    # bounds, so the curvature must be evaluated in the interior)
    cov, ok = laplace_covariance(log_posterior, x_map, free=~at_bound)
    result = _MAPFitResult(x_map, float(logp_fin[best]), cov, ok,
                           at_bound, nsamples, seed)
    if not quiet:
        spread = logp_fin[np.isfinite(logp_fin)]
        print(f"MAP: log-posterior {result.log_posterior:.2f} "
              f"({(spread >= spread.max() - 1.0).sum()}/{n_starts} starts "
              f"within 1 nat of the best)")
        if not ok:
            print("  curvature not positive definite (ridge saddle): "
                  "stderr values are order-of-magnitude only")
        for name, val, err, pinned in zip(model.input_names, x_map,
                                          result.stderr, at_bound):
            note = "  (at prior bound)" if pinned else ""
            print(f"  {name} = {val:.6g} +/- {err:.2g}{note}")
        try:
            # the Laplace cloud scatters off the curved ridge; always score
            # the MAP point itself so chi2 reflects the actual best fit
            goodness_of_fit(lc, model, result.flatchain, best=x_map,
                            use_sigma=use_sigma, sigma_type=sigma_type)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


# --------------------------------------------------------------------------
# Bayesian evidence (no reference counterpart: the reference has no
# model-comparison machinery at all)
# --------------------------------------------------------------------------

def _prior_log_norm(prior):
    """log of a prior's normalization constant over its support.

    The Prior classes return *unnormalized* log-densities (reference parity:
    reference models.py:1048-1098 never normalizes because MCMC doesn't care).
    The stepping-stone ratio Z(1)/Z(0) normalizes the prior automatically —
    any constant factor cancels — so the tempered drivers call this only to
    *validate properness* (an improper prior has no evidence) and discard
    the value; the Laplace-evidence cross-check uses the value itself.
    Uniform priors normalize analytically; everything else integrates
    numerically on a dense grid. Infinite supports are windowed where the
    mass is (Gaussian: mean +/- 15 sigma; KDE: sample range +/- 12
    bandwidths); anything else unbounded is rejected."""
    from .models import KDEPrior

    lo = getattr(prior, "p_min", -np.inf)
    hi = getattr(prior, "p_max", np.inf)
    if not hi > lo:
        raise ValueError(f"{prior!r} has empty support")
    if type(prior) is UniformPrior and np.isfinite(lo) and np.isfinite(hi):
        return float(np.log(hi - lo))
    if isinstance(prior, GaussianPrior):
        wlo = max(lo, prior.mean - 15.0 * prior.stddev)
        whi = min(hi, prior.mean + 15.0 * prior.stddev)
        # support disjoint from the 15-sigma core (a pure-tail truncation):
        # integrate the support directly, the max-shift handles underflow
        if whi > wlo:
            lo, hi = wlo, whi
    elif isinstance(prior, KDEPrior):
        s = np.asarray(prior.samples, float)
        lo = max(lo, s.min() - 12.0 * prior.bandwidth)
        hi = min(hi, s.max() + 12.0 * prior.bandwidth)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"evidence requires proper (normalizable) priors; "
                         f"{prior!r} has unbounded support")
    # integrate the raw (unmasked) density on the CLOSED interval — the
    # masked __call__ is -inf exactly at the bounds, which would drop the
    # edge slivers (the density often peaks at a bound, e.g. a truncated
    # Gaussian with its mean at p_min)
    g = np.linspace(lo, hi, 4097)
    vals = np.asarray(jax.vmap(prior.logp)(jnp.asarray(g)), float)
    if np.any(np.isposinf(vals)):
        raise ValueError(f"{prior!r} has a divergent density on its support; "
                         "its evidence normalization is undefined")
    finite = vals[np.isfinite(vals)]
    if finite.size == 0:
        raise ValueError(f"{prior!r} has zero density everywhere on "
                         f"[{lo}, {hi}]")
    m = finite.max()
    trapezoid = getattr(np, "trapezoid", np.trapz)
    return float(m + np.log(trapezoid(np.exp(vals - m), g)))  # exp(-inf) -> 0


def _tempered_setup(lc, model, priors, p_lo, p_up, nwalkers, use_sigma,
                    sigma_type, seed, state_dtype="auto"):
    """Shared setup for the tempered-ladder drivers (evidence and PT):
    derived fit columns, sigma parameter, prior properness validation, the
    (log prior, log likelihood) pair the kernel tracks separately, and the
    walker starting cloud.

    With ``state_dtype="auto"`` on accelerators, both functions are wrapped
    in the affine rescaling of the init window and ``p0`` is transformed, so
    the ladder's walker state runs in float32 (see ``_state_rescaling``).
    The evidence is invariant: the constant Jacobian of the affine map
    cancels in the stepping-stone ratio Z(1)/Z(0), and the log-likelihood
    values are identical functions of the underlying parameters."""
    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams
    if len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    for prior in priors:
        _prior_log_norm(prior)  # properness check; the constant cancels in
        #                         Z(1)/Z(0), so the value itself is not used

    def log_prior_fn(p):
        out = 0.0
        for i, prior in enumerate(priors):
            out = out + prior(p[i])
        return out

    log_like_fn = model.make_log_likelihood(lc, use_sigma=use_sigma,
                                            sigma_type=sigma_type)
    lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(lo, up, size=(nwalkers, ndim))

    state_kw = _state_rescaling(state_dtype, lo, up)
    if state_kw:
        import jax.numpy as jnp
        offset, scale = state_kw["param_offset"], state_kw["param_scale"]
        o, s = jnp.asarray(offset), jnp.asarray(scale)
        base_prior, base_like = log_prior_fn, log_like_fn
        log_prior_fn = lambda q: base_prior(o + s * q)   # noqa: E731
        log_like_fn = lambda q: base_like(o + s * q)     # noqa: E731
        p0 = (p0 - offset) / scale

    # fingerprint of everything the two closures bake in, so the tempered
    # ladder can cache its compiled kernels across calls (a per-call re-jit
    # can cost more than the sampling). Must capture model physics, priors (incl. KDE samples),
    # the photometry itself, and the affine rescaling.
    import hashlib
    from .parallel.population import _model_fingerprint, _prior_fingerprint
    oq = model.output_quantity
    data_digest = hashlib.sha1(
        np.ascontiguousarray(np.asarray(lc["MJD"], float)).tobytes()
        + np.ascontiguousarray(np.asarray(lc[oq], float)).tobytes()
        + np.ascontiguousarray(np.asarray(lc["d" + oq], float)).tobytes()
        + "|".join(str(f) for f in lc["filter"]).encode()).hexdigest()
    fns_key = (_model_fingerprint(model),
               tuple(_prior_fingerprint(p) for p in priors),
               data_digest, use_sigma, sigma_type,
               None if not state_kw else
               (tuple(state_kw["param_offset"]), tuple(state_kw["param_scale"]),
                str(state_kw.get("dtype"))))
    return log_prior_fn, log_like_fn, p0, state_kw, fns_key


def lightcurve_evidence(lc, model, priors, p_lo=None, p_up=None, nwalkers=64,
                        n_rungs=32, nsteps=500, nsteps_burnin=500,
                        use_sigma=False, sigma_type="relative", seed=None,
                        mesh=None, quiet=False, checkpoint_every=None,
                        checkpoint_file=None, resume_from=None,
                        state_dtype="auto"):
    """log marginal likelihood (Bayesian evidence) of a model for this light
    curve, by stepping-stone sampling over a ladder of power posteriors —
    the whole ladder runs as one vmapped device kernel
    (``parallel/evidence.py``), so this costs about one MCMC fit, not K.

    Differences in the returned ``log_z`` between models are log Bayes
    factors: ``lightcurve_evidence(lc, ShockCooling2(lc), priors2) -
    lightcurve_evidence(lc, ShockCooling4(lc), priors4)`` > 0 means the data
    prefer SW17 scaling over MSW23 *given those priors*. The stepping-stone
    ratio Z(1)/Z(0) normalizes each prior automatically (the Prior classes
    are unnormalized, reference parity; improper priors are rejected);
    evidence is prior-sensitive by nature — report the priors with the
    number.

    Returns ``(log_z, log_z_err, info)``; ``info`` has the ladder, per-rung
    terms, and per-rung acceptance.

    ``checkpoint_every``/``checkpoint_file``/``resume_from``: long ladder
    runs checkpoint the full state (all rung walkers + partial rung sums)
    every N steps and resume exactly — the per-step RNG keys are folded from
    the step index, so a resumed run reproduces the uninterrupted one.
    """
    from .parallel.evidence import stepping_stone_evidence

    log_prior_fn, log_like_fn, p0, state_kw, fns_key = _tempered_setup(
        lc, model, priors, p_lo, p_up, nwalkers, use_sigma, sigma_type, seed,
        state_dtype=state_dtype)
    log_z, log_z_err, info = stepping_stone_evidence(
        log_prior_fn, log_like_fn, p0, n_rungs=n_rungs, nsteps=nsteps,
        nsteps_burnin=nsteps_burnin, seed=seed if seed is not None else 0,
        mesh=mesh, checkpoint_every=checkpoint_every,
        checkpoint_file=checkpoint_file, resume_from=resume_from,
        state_dtype=state_kw.get("dtype"), fns_key=fns_key)
    if not quiet:
        print(f"log evidence: {log_z:.2f} +/- {log_z_err:.2f} "
              f"({n_rungs} rungs x {nwalkers} walkers x {nsteps} steps; "
              f"rung acceptance {info['acceptance'].min():.2f}-"
              f"{info['acceptance'].max():.2f})")
    return log_z, log_z_err, info


def _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type, kind):
    """Evaluate per-draw discrepancies of a posterior sample against the
    light curve's photometry: ``kind="chi2"`` returns the (S,) summed
    chi-square per draw; ``kind="pointwise_ll"`` the (S, N) per-point
    Gaussian log-densities (same variance model as the likelihood,
    reference models.py:93-136; absolute densities — the -log(yscale)
    normalization Jacobian is added back).

    One compiled kernel per (model physics, variance model, kind) serves
    every light curve — the photometry (t, quad, y, dy, sigma units,
    scale) are runtime ARGUMENTS, so a transient sweep compiles once, not
    per object, and a fresh jit per driver call would otherwise add a
    compile that dwarfs the diagnostic itself.
    Returns ``(values, yscale, n_points)``.
    """
    from .parallel.population import _model_fingerprint

    _derive_fit_columns(lc, model)
    oq = model.output_quantity
    f = np.asarray(lc["filter"])
    t = np.asarray(lc["MJD"], float)
    y = np.asarray(lc[oq], float)
    dy = np.asarray(lc["d" + oq], float)
    n_model = np.shape(draws)[1] - (1 if use_sigma else 0)

    key = (_model_fingerprint(model), use_sigma, sigma_type, n_model, kind)
    fn = _GOF_CACHE.get(key)
    if fn is None:
        def batch(stacked, t_a, quad_a, y_a, dy_a, su_a, inv_yscale_a):
            # population_goodness_of_fit carries a masked copy of this
            # variance model — parity is test-enforced; change both
            def one(p):
                y_fit = model._eval_points(t_a, quad_a,
                                           *[p[i] for i in range(n_model)])
                y_fit = y_fit * inv_yscale_a
                sigma2 = dy_a ** 2.0
                if use_sigma:
                    sigma2 = sigma2 + (p[-1] * su_a) ** 2.0
                r2 = (y_a - y_fit) ** 2.0 / sigma2
                if kind == "chi2":
                    return jnp.sum(r2)
                return -0.5 * (jnp.log(2.0 * jnp.pi * sigma2) + r2)
            return jax.vmap(one)(stacked)

        fn = jax.jit(batch)
        _GOF_CACHE[key] = fn

    # the same O(1) data normalization as the likelihood (float32 range
    # safety; chi-square is invariant under it, log densities regain
    # the Jacobian below)
    yscale, y_n, dy_n, sigma_units = model._normalized_data(y, dy, sigma_type)
    quad = model.prepare_quad(f)
    out = np.asarray(fn(jnp.asarray(np.asarray(draws, float)),
                        jnp.asarray(t), quad, jnp.asarray(y_n),
                        jnp.asarray(dy_n), jnp.asarray(sigma_units),
                        jnp.asarray(1.0 / yscale)))
    if kind == "pointwise_ll":
        out = out - np.log(yscale)
    return out, yscale, len(y)


def goodness_of_fit(lc, model, flatchain, use_sigma=False,
                    sigma_type="relative", n_draws=512, seed=0, quiet=False,
                    best=None):
    """Posterior-predictive goodness-of-fit of a completed fit.

    Beyond-reference diagnostic (the reference reports no fit-quality
    statistic at all; its workflow ends at the corner plot): for ``n_draws``
    posterior samples theta_j this computes the observed discrepancy
    chi2_j = sum_i ((y_i - m_i(theta_j)) / sigma_ij)^2 in one vmapped device
    call (sigma_ij includes the intrinsic-scatter parameter when
    ``use_sigma``, same variance model as the likelihood, reference
    models.py:93-136), and the posterior-predictive p-value

        p = E_theta[ Pr(chi2_rep >= chi2_obs | theta) ]
          = mean_j SF_chi2(chi2_j; N)

    (Gelman et al. 1996 with the chi-square discrepancy; given theta the
    replicated discrepancy is exactly chi-square with N degrees of freedom,
    so the inner probability is analytic — no replicate sampling noise).
    p near 0 means the model cannot reproduce its own residuals
    (misspecified or error bars too small); p near 1 means overfitting or
    inflated error bars. The classical reduced chi-square is reported at the
    best evaluated draw (the minimum over the posterior sample — the vector
    of componentwise medians is NOT used as the expansion point, because on
    curved ridge posteriors like the flagship's it lies off the ridge).

    ``best``: an optional parameter vector that is always evaluated and
    participates in the best-fit chi-square (but not the p-value, which
    averages over posterior draws only). :func:`lightcurve_map` passes its
    MAP point here — the Laplace cloud scatters off curved ridges, so the
    subsampled draws alone can badly overstate the best achievable chi2.

    Returns a dict with ``chi2`` (best-fit: minimum over the evaluated
    draws and ``best`` if given), ``dof`` (N - ndim), ``chi2_nu``,
    ``p_value``, ``n_points``, and ``n_invalid_draws`` (draws that evaluated
    outside the model's validity window — e.g. a Laplace sample overshooting
    ``t_0`` past the first epoch — and were excluded from the score).
    """
    from scipy.stats import chi2 as _chi2_dist

    flatchain = np.asarray(flatchain, float)
    ndim = flatchain.shape[1]

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), len(flatchain))
    draws = flatchain[rng.choice(len(flatchain), n_draws, replace=False)]
    # row 0 optionally carries the caller's best point (MAP) through the same
    # compiled kernel; it scores the chi2 minimum, not the p-value average
    n_extra = 0
    if best is not None:
        draws = np.concatenate([np.asarray(best, float)[None], draws])
        n_extra = 1
    chi2_all, _, npts = _posterior_discrepancy(lc, model, draws, use_sigma,
                                               sigma_type, kind="chi2")
    chi2_draws = chi2_all[n_extra:]
    # draws outside the model's validity window (e.g. t < t_0, or past t_max
    # for a Laplace sample that overshoots the bounds) evaluate to nan/inf;
    # score the diagnostic over the valid draws only
    finite = np.isfinite(chi2_draws)
    n_bad = int(np.sum(~finite))
    chi2_draws = chi2_draws[finite]
    chi2_pool = np.concatenate([chi2_all[:n_extra][np.isfinite(chi2_all[:n_extra])],
                                chi2_draws])
    if len(chi2_pool) == 0:
        out = {"chi2": np.nan, "dof": npts - ndim, "chi2_nu": np.nan,
               "p_value": np.nan, "n_points": npts, "n_invalid_draws": n_bad}
        if not quiet:
            print("goodness of fit: unavailable — every posterior draw "
                  "evaluated outside the model's validity window")
        return out
    p_value = float(np.mean(_chi2_dist.sf(chi2_draws, npts))) \
        if len(chi2_draws) else np.nan

    chi2_best = float(np.min(chi2_pool))
    dof = npts - ndim
    out = {"chi2": chi2_best, "dof": dof,
           "chi2_nu": chi2_best / dof if dof > 0 else np.nan,
           "p_value": p_value, "n_points": npts, "n_invalid_draws": n_bad}
    if not quiet:
        note = (f" ({n_bad}/{n_bad + len(chi2_draws)} draws outside the "
                f"model's validity window were excluded)" if n_bad else "")
        print(f"goodness of fit: chi^2/dof = {chi2_best:.1f}/{dof} "
              f"= {out['chi2_nu']:.2f} at the best posterior draw; "
              f"posterior-predictive p = {p_value:.3f}{note}")
    return out


def _exact_cv_elpd(lc, model, priors, masks, use_sigma, sigma_type,
                   flatchain, n_draws, seed, refit_options):
    """Exact leave-out cross-validation for importance-sampling failures.

    PSIS-LOO/LOGO terms whose Pareto tail shape exceeds 0.7 are unreliable
    (Vehtari+17 §3) — the full-data posterior is too far from the held-out
    posterior for reweighting. The repair is the definition itself: REFIT
    the model without each flagged subset and score the held-out points
    under the refit posterior,

        elpd_g = log mean_s exp( sum_{i in g} ll(y_i | theta_s^{(-g)}) ).

    All flagged refits run as ONE batched device call (``fit_population``
    masks the ragged per-refit data; the per-transient ensembles share one
    compiled kernel), windowed by the full-data posterior: the refit box is
    the chain's [2, 98] percentile box, which lies inside the prior support
    by construction and is close to every leave-out posterior (dropping one
    band barely moves a 149-point fit). Within that box the default
    ``init="map"`` runs the batched multi-start MAP stage — on thin curved
    ridges (the flagship) walkers started uniformly in the box are still
    contracting after thousands of steps, which would make the exact elpd
    as unreliable as the PSIS term it replaces. The held-out scores then
    reuse the SAME cached pointwise-log-likelihood kernel the PSIS stage
    compiled (``_posterior_discrepancy``).

    ``masks``: boolean (N,) arrays, one per refit, True on the held-out
    points. Returns (elpd (G,), refit acceptance (G,)); an elpd entry is
    NaN if fewer than 8 refit draws evaluated finitely on the held-out set.
    """
    from .parallel.population import fit_population
    from .parallel.ic import _logsumexp

    chain = np.asarray(flatchain, float)
    p_lo = np.percentile(chain, 2.0, axis=0)
    p_up = np.percentile(chain, 98.0, axis=0)
    degenerate = ~(p_up > p_lo)  # chain pinned to one value in a dimension
    if np.any(degenerate):
        eps = np.maximum(1e-8, 1e-8 * np.abs(p_lo))
        p_lo = np.where(degenerate, p_lo - eps, p_lo)
        p_up = np.where(degenerate, p_up + eps, p_up)
    # keep the box inside the prior support: a chain pinned AT a bound
    # (flagship t_0) would otherwise widen past it and seed walkers/MAP
    # starts in zero-density territory, silently failing every refit
    lo_b = np.array([getattr(p, "p_min", -np.inf) for p in priors], float)
    up_b = np.array([getattr(p, "p_max", np.inf) for p in priors], float)
    p_lo = np.clip(p_lo, lo_b, up_b)
    p_up = np.clip(p_up, lo_b, up_b)
    collapsed = ~(p_up > p_lo)  # clip collapsed a bound-pinned dimension
    if np.any(collapsed):
        width = np.minimum(np.maximum(1e-8, 1e-8 * np.abs(p_up)),
                           up_b - lo_b)
        grow_down = collapsed & (p_up - width >= lo_b)
        p_lo = np.where(grow_down, p_up - width, p_lo)
        p_up = np.where(collapsed & ~grow_down, p_lo + width, p_up)

    lcs = [lc[~m] for m in masks]
    models = [model.clone_for(sub) for sub in lcs]
    opts = dict(nwalkers=64, nsteps=500, nsteps_burnin=500, init="map")
    opts.update(refit_options or {})
    flat, acc = fit_population(models, lcs, priors, p_lo=p_lo, p_up=p_up,
                               use_sigma=use_sigma, sigma_type=sigma_type,
                               seed=seed, **opts)
    flat = np.asarray(flat, float)
    G = len(masks)
    rng = np.random.default_rng(seed)
    nd = min(int(n_draws), flat.shape[1])
    idx = rng.choice(flat.shape[1], nd, replace=False)
    # one cached-kernel call scores every refit's draws on the FULL curve;
    # each refit then reads off its own held-out columns
    draws = flat[:, idx, :].reshape(G * nd, flat.shape[2])
    ll, _, _ = _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type,
                                      kind="pointwise_ll")
    ll = ll.reshape(G, nd, -1)
    elpd = np.full(G, np.nan)
    for g, m in enumerate(masks):
        llg = ll[g][:, m].sum(axis=1)
        llg = llg[np.isfinite(llg)]
        if len(llg) >= 8:
            elpd[g] = float(_logsumexp(llg) - np.log(len(llg)))
    return elpd, np.asarray(acc)


def _apply_refit(res, pointwise_key, elpd_key, se_key, masks, bad_idx,
                 group_names, lc, model, priors, use_sigma, sigma_type,
                 flatchain, n_draws, seed, refit_options):
    """Patch a waic/psis result dict in place with exact-refit CV values for
    the flagged entries; records the provenance under ``res['refit']``.
    ``labels`` lists ONLY the entries actually repaired (exact-backed) —
    a refit that produced no finite held-out score leaves its entry on the
    PSIS estimate and lands in ``failed_labels`` instead, so downstream
    consumers never report a repair that did not happen."""
    elpd_exact, acc = _exact_cv_elpd(lc, model, priors, masks, use_sigma,
                                     sigma_type, flatchain, n_draws, seed,
                                     refit_options)
    ok = np.isfinite(elpd_exact)
    pw = np.asarray(res[pointwise_key], float).copy()
    elpd_psis = pw[bad_idx].copy()
    pw[bad_idx[ok]] = elpd_exact[ok]
    n = len(pw)
    res[pointwise_key] = pw
    res[elpd_key] = float(np.sum(pw))
    res[se_key] = float(np.sqrt(n * np.var(pw, ddof=1))) if n > 1 else np.nan
    group_names = np.asarray(group_names)
    res["refit"] = {
        "method": "exact_refit_cv",
        "labels": group_names[ok],
        "elpd_psis": elpd_psis[ok],
        "elpd_exact": elpd_exact[ok],
        "failed_labels": group_names[~ok],
        "acceptance": acc,
        "n_failed": int(np.sum(~ok)),
    }
    return res


def information_criteria(lc, model, flatchain, use_sigma=False,
                         sigma_type="relative", n_draws=1024, seed=0,
                         group_by=None, refit=False, priors=None,
                         refit_options=None, quiet=False):
    """WAIC and PSIS-LOO predictive scores of a completed fit.

    Beyond-reference capability (the reference has no model-selection
    machinery; its workflow ends at per-model fits, reference
    fitting.py:16-168): estimates the expected log pointwise predictive
    density directly from the posterior chain — the chain-based companion
    to :func:`compare_models` (which integrates the evidence on a tempered
    ladder). Unlike the evidence, elpd is insensitive to prior volume and
    needs no extra sampling: scoring a finished fit costs one vmapped
    device call for the (draws x points) pointwise log-likelihood matrix
    plus O(S N) host statistics (``parallel/ic.py``; Vehtari, Gelman &
    Gabry 2017).

    Returns a dict merging :func:`parallel.ic.waic` and
    :func:`parallel.ic.psis_loo` outputs (``elpd_loo``, ``se_elpd_loo``,
    ``p_loo``, ``looic``, ``pareto_k``, ``elpd_waic``, ``p_waic``,
    ``waic``, ``se_elpd_waic``) plus ``pointwise`` (per-point LOO elpd, for
    paired comparison via :func:`compare_information_criteria`),
    ``pointwise_waic``, and ``n_points``. Per-point reliability: any
    ``pareto_k`` > 0.7 means that point's LOO term is untrustworthy (the
    printed summary counts them).

    ``group_by`` (a light-curve column name like ``"filter"``, or an
    explicit length-N label array) adds leave-one-GROUP-out scores under
    ``out["logo"]`` (:func:`parallel.ic.psis_logo`): can the model predict
    a whole held-out band/epoch, not just one point given its bandmates.

    ``refit``: repair unreliable PSIS terms by EXACT cross-validation
    instead of only flagging them. Any point (and, with ``group_by``, any
    group) whose ``pareto_k`` exceeds the threshold (``refit=True`` uses
    the standard 0.7; pass a float for a custom threshold, e.g. ``-np.inf``
    to refit everything) is re-scored by refitting the model without it —
    all flagged refits in one batched device call seeded from this chain —
    and evaluating the held-out log density under the refit posterior (see
    :func:`_exact_cv_elpd`). Requires ``priors`` (the fit's prior list,
    including the intrinsic-scatter prior when ``use_sigma=True``);
    ``refit_options`` forwards sampler settings (``nwalkers``, ``nsteps``,
    ``nsteps_burnin``, ``init``) to :func:`parallel.population.fit_population`.
    Patched results carry the provenance under ``out["refit"]`` /
    ``out["logo"]["refit"]`` (PSIS vs exact values per flagged entry);
    ``pareto_k`` keeps the original diagnostics.
    """
    from .parallel.ic import (waic as _waic, psis_loo as _psis_loo, psis_logo,
                              _logsumexp as _ic_logsumexp)

    if refit is not False and priors is None:
        # validate at ENTRY: failing only when something happens to be
        # flagged would destroy an already-computed result data-dependently
        raise ValueError("refit of unreliable PSIS terms needs the fit's "
                         "priors: pass priors=[...] (including the "
                         "intrinsic-scatter prior when use_sigma=True)")

    flatchain = np.asarray(flatchain, float)

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), len(flatchain))
    draws = flatchain[rng.choice(len(flatchain), n_draws, replace=False)]
    ll, _, _ = _posterior_discrepancy(lc, model, draws, use_sigma,
                                      sigma_type, kind="pointwise_ll")
    # drop draws outside the model's validity window (nan/inf rows), as in
    # goodness_of_fit
    good = np.all(np.isfinite(ll), axis=1)
    n_bad = int(np.sum(~good))
    ll = ll[good]
    if len(ll) < 8:
        raise RuntimeError("fewer than 8 finite posterior draws — the chain "
                           "does not sample the model's validity window")

    loo = _psis_loo(ll)
    wa = _waic(ll)
    out = {"elpd_loo": loo["elpd_loo"], "se_elpd_loo": loo["se_elpd_loo"],
           "p_loo": loo["p_loo"], "looic": loo["looic"],
           "pareto_k": loo["pareto_k"],
           "elpd_waic": wa["elpd_waic"], "se_elpd_waic": wa["se_elpd_waic"],
           "p_waic": wa["p_waic"], "waic": wa["waic"],
           "pointwise": loo["pointwise"], "pointwise_waic": wa["pointwise"],
           "n_points": ll.shape[1], "n_invalid_draws": n_bad}

    threshold = 0.7 if refit is True else refit
    N = ll.shape[1]
    if refit is not False:
        # NaN k-hat ("tail too small to estimate") counts as unreliable
        bad_pts = np.flatnonzero(~(out["pareto_k"] <= threshold))
        if len(bad_pts):
            masks = [np.arange(N) == i for i in bad_pts]
            _apply_refit(out, "pointwise", "elpd_loo", "se_elpd_loo",
                         masks, bad_pts, bad_pts, lc, model, priors,
                         use_sigma, sigma_type, flatchain, n_draws, seed,
                         refit_options)
            out["looic"] = -2.0 * out["elpd_loo"]
            lppd = float(np.sum(_ic_logsumexp(ll, axis=0) - np.log(len(ll))))
            out["p_loo"] = lppd - out["elpd_loo"]

    if group_by is not None:
        labels = (np.asarray(lc[group_by]) if isinstance(group_by, str)
                  else np.asarray(group_by))
        lg = out["logo"] = psis_logo(ll, labels)
        if refit is not False:
            bad_g = np.flatnonzero(~(lg["pareto_k"] <= threshold))
            if len(bad_g):
                masks = [labels == lg["groups"][j] for j in bad_g]
                _apply_refit(lg, "pointwise", "elpd_logo", "se_elpd_logo",
                             masks, bad_g, lg["groups"][bad_g], lc, model,
                             priors, use_sigma, sigma_type, flatchain,
                             n_draws, seed, refit_options)
    if not quiet:
        def _notes(res, n_total, kind):
            # refit provenance prints whenever a repair ran, independent of
            # the 0.7 count (custom thresholds can repair below-0.7 terms)
            parts = []
            n_hi = int(np.sum(res["pareto_k"] > 0.7))
            if n_hi:
                parts.append(f"{n_hi}/{n_total} {kind} have pareto_k > 0.7"
                             + (" (unreliable LOO terms)"
                                if kind == "points" else ""))
            if "refit" in res:
                nf = res["refit"]["n_failed"]
                parts.append(f"{len(res['refit']['labels'])} repaired by "
                             f"exact refit CV"
                             + (f" ({nf} refits failed)" if nf else ""))
            return "; " + "; ".join(parts) if parts else ""

        print(f"elpd_loo = {out['elpd_loo']:.1f} +/- {out['se_elpd_loo']:.1f} "
              f"(p_loo = {out['p_loo']:.1f}); "
              f"elpd_waic = {wa['elpd_waic']:.1f} +/- {wa['se_elpd_waic']:.1f}"
              f"{_notes(out, ll.shape[1], 'points')}")
        if group_by is not None:
            lg = out["logo"]
            print(f"leave-one-group-out ({len(lg['groups'])} groups): "
                  f"elpd_logo = {lg['elpd_logo']:.1f} "
                  f"+/- {lg['se_elpd_logo']:.1f}"
                  f"{_notes(lg, len(lg['groups']), 'groups')}")
    return out


def compare_information_criteria(ics, labels=None, quiet=False):
    """Rank fitted models by PSIS-LOO elpd with paired standard errors.

    ``ics``: sequence of :func:`information_criteria` results for models
    scored on the SAME light curve. Returns a Table ranked best-first with
    columns ``model``, ``elpd_loo``, ``d_elpd`` (difference to the best
    model, <= 0) and ``se_d_elpd`` (the PAIRED pointwise SE of that
    difference, Vehtari+17 eq. 24 — per-point difficulty is shared, so this
    is much tighter than differencing marginal SEs). The usual reading: a
    model is distinguishable when |d_elpd| exceeds a few times se_d_elpd.

    The ``stacking_weight`` column carries the Bayesian-stacking simplex
    weights (Yao+18; :func:`~lightcurve_fitting_tpu.parallel.ic.
    stacking_weights`) — the optimal mixture of the candidates' LOO
    predictive distributions. Complementary misspecified models can both
    carry weight even when their d_elpd ranking is decisive.
    """
    from .parallel.ic import compare_elpd, stacking_weights
    from .utils.table import Table

    ics = list(ics)
    if labels is None:
        labels = [f"model#{i}" for i in range(len(ics))]
    if len(labels) != len(ics) or len(set(labels)) != len(labels):
        raise ValueError("labels must be one per model and unique")
    ranked = compare_elpd([ic["pointwise"] for ic in ics], list(labels))
    w = stacking_weights([ic["pointwise"] for ic in ics])
    weight = dict(zip(labels, w))
    tab = Table([[r["label"] for r in ranked],
                 [r["elpd"] for r in ranked],
                 [r["d_elpd"] for r in ranked],
                 [r["se_d_elpd"] for r in ranked],
                 [weight[r["label"]] for r in ranked]],
                names=["model", "elpd_loo", "d_elpd", "se_d_elpd",
                       "stacking_weight"])
    if not quiet:
        print("model ranking by PSIS-LOO elpd (best first):")
        for r in ranked:
            if r["d_elpd"] == 0.0:
                print(f"  {r['label']}: elpd_loo = {r['elpd']:.1f} (best), "
                      f"stacking weight {weight[r['label']]:.3f}")
            else:
                print(f"  {r['label']}: elpd_loo = {r['elpd']:.1f} "
                      f"(d_elpd = {r['d_elpd']:.1f} +/- {r['se_d_elpd']:.1f}), "
                      f"stacking weight {weight[r['label']]:.3f}")
    return tab


def _compare_args(models, priors, p_lo, p_up, labels):
    """Normalize the shared-vs-per-model argument shapes of the comparison
    drivers: priors (flat shared list or one list per model), p_lo/p_up
    (shared window or per-model), labels (default: deduplicated class
    names). Shared by ``compare_models`` and ``compare_models_loo``."""
    models = list(models)
    n = len(models)
    if n < 2:
        raise ValueError("model comparison needs at least two models")

    def per_model(arg, name):
        if arg is None:
            return [None] * n
        seq = list(arg)
        if seq and not np.iterable(seq[0]):      # one shared flat window
            return [seq] * n
        if len(seq) != n:
            raise ValueError(f"{name} must be shared or one entry per model "
                             f"({len(seq)} given for {n} models)")
        return seq

    if priors and callable(priors[0]):           # shared flat prior list
        ndims = {len(m.input_names) for m in models}
        if len(ndims) != 1:
            raise ValueError("a shared prior list requires all models to "
                             "have the same number of parameters; give one "
                             "prior list per model")
        priors = [list(priors)] * n
    elif len(priors) != n:
        raise ValueError(f"priors must be shared or one list per model "
                         f"({len(priors)} given for {n} models)")
    p_lo, p_up = per_model(p_lo, "p_lo"), per_model(p_up, "p_up")

    if labels is None:
        labels, seen = [], {}
        for m in models:
            base = type(m).__name__
            seen[base] = seen.get(base, 0) + 1
            labels.append(base if seen[base] == 1 else f"{base}#{seen[base]}")
    else:
        labels = [str(lb) for lb in labels]
        if len(labels) != n:
            raise ValueError(f"labels must be one per model "
                             f"({len(labels)} given for {n} models)")
        if len(set(labels)) != n:
            raise ValueError("labels must be unique")
    return models, priors, p_lo, p_up, labels


def _per_model_checkpoint_path(path, label):
    """Insert the model label before the extension (``ck.npz`` ->
    ``ck.SW17.npz``) so compared models never share a checkpoint file: the
    resume validation (shape/seed/steps) cannot tell same-shaped models
    apart."""
    if path is None:
        return None
    root, ext = os.path.splitext(path)
    safe = re.sub(r"[^\w.-]", "_", label)
    return f"{root}.{safe}{ext or '.npz'}"


def compare_models_loo(lc, models, priors, p_lo=None, p_up=None, labels=None,
                       nwalkers=100, nsteps=1000, nsteps_burnin=1000,
                       use_sigma=False, sigma_type="relative", seed=None,
                       n_draws=1024, refit=False, refit_options=None,
                       group_by=None, quiet=False, **mcmc_kwargs):
    """One-call chain-based model comparison: fit every candidate with
    :func:`lightcurve_mcmc`, score PSIS-LOO, and rank with paired
    standard errors.

    The cheaper, prior-volume-insensitive sibling of :func:`compare_models`
    (which integrates the evidence on a tempered ladder): elpd compares
    predictive accuracy, so diffuse priors do not penalize a model the way
    they shrink its evidence. The cost is one ordinary MCMC fit per model
    plus one vmapped device call each for the pointwise log-likelihood
    matrix. Chains must be converged — elpd from an unconverged sample
    inherits its bias (the defaults match the flagship notebook's
    1000+1000-step fits).

    Arguments shape-match ``compare_models`` (shared or per-model priors /
    windows / labels); ``mcmc_kwargs`` forward to every
    :func:`lightcurve_mcmc` call (replicas, mesh, init, ...).
    ``refit`` / ``refit_options`` / ``group_by`` forward to each model's
    :func:`information_criteria` (each candidate's priors back its own
    refits), so the ranking can be made robust to flagged PSIS terms —
    comparisons between misspecified candidates are exactly where heavy
    importance tails appear.
    ``checkpoint_file`` / ``resume_from`` are per-model-ized as in
    ``compare_models`` (label inserted before the extension; resume only
    applies to models whose file exists).

    Returns the :func:`compare_information_criteria` Table (columns
    ``model``, ``elpd_loo``, ``d_elpd``, ``se_d_elpd``);
    ``table.meta["ics"]`` keeps each model's full
    :func:`information_criteria` dict and ``table.meta["samplers"]`` the
    fitted samplers, keyed by label.
    """
    models, priors, p_lo, p_up, labels = _compare_args(models, priors, p_lo,
                                                       p_up, labels)
    # checkpoint_file/resume_from are per-model-ized exactly as in
    # compare_models: the resume validation (shape/seed/nsteps_burnin) cannot
    # tell same-ndim models apart, so a shared file would silently resume
    # model 2 from model 1's walker state
    ck_base = mcmc_kwargs.pop("checkpoint_file", None)
    resume_base = mcmc_kwargs.pop("resume_from", None)
    ics, samplers = {}, {}
    for label, model, pri, lo, up in zip(labels, models, priors, p_lo, p_up):
        resume = _per_model_checkpoint_path(resume_base, label)
        if resume is not None and not os.path.exists(resume):
            resume = None                       # this model starts fresh
        sampler = lightcurve_mcmc(lc, model, priors=pri, p_lo=lo, p_up=up,
                                  nwalkers=nwalkers, nsteps=nsteps,
                                  nsteps_burnin=nsteps_burnin,
                                  use_sigma=use_sigma, sigma_type=sigma_type,
                                  seed=seed, quiet=True,
                                  checkpoint_file=_per_model_checkpoint_path(
                                      ck_base, label),
                                  resume_from=resume, **mcmc_kwargs)
        ics[label] = information_criteria(lc, model, sampler.flatchain,
                                          use_sigma=use_sigma,
                                          sigma_type=sigma_type,
                                          n_draws=n_draws,
                                          seed=0 if seed is None else seed,
                                          refit=refit, priors=pri,
                                          refit_options=refit_options,
                                          group_by=group_by, quiet=True)
        samplers[label] = sampler
    tab = compare_information_criteria([ics[lb] for lb in labels],
                                       labels=labels, quiet=quiet)
    tab.meta["ics"] = ics
    tab.meta["samplers"] = samplers
    tab.meta["models"] = dict(zip(labels, models))  # for stacked_model_plot
    tab.meta["use_sigma"] = use_sigma
    if not quiet:
        worst = max(int(np.sum(ics[lb]["pareto_k"] > 0.7)) for lb in labels)
        if worst:
            print(f"  (up to {worst} points per model have pareto_k > 0.7 — "
                  "expected under misspecification, but verify convergence)")
    return tab


def compare_models(lc, models, priors, p_lo=None, p_up=None, labels=None,
                   quiet=False, **evidence_kwargs):
    """Bayes-factor model comparison: run ``lightcurve_evidence`` for each
    candidate model and rank them by log marginal likelihood.

    Beyond-reference capability (the reference offers no model-selection
    machinery; its workflow stops at per-model fits, reference
    fitting.py:16): this is the standard statistical answer to "SW17 or
    MSW23 scalings?" / "is a companion-shocking component supported?" —
    the question its model zoo exists to pose.

    Parameters
    ----------
    models : sequence of Model instances.
    priors : one prior list per model, or a single flat prior list shared by
        all models (only valid when every model has the same parameters).
    p_lo, p_up : per-model sequences (or one shared window) bounding the
        walker initialization, as in ``lightcurve_evidence``; None draws
        from the priors.
    labels : display names; defaults to each model class name (deduplicated
        with #k suffixes). User-supplied labels must be one per model and
        unique.
    evidence_kwargs : forwarded to ``lightcurve_evidence`` (nwalkers,
        n_rungs, nsteps, seed, mesh, ...). ``checkpoint_file`` /
        ``resume_from`` are per-model-ized: the label is inserted before the
        extension (``ck.npz`` -> ``ck.SW17.npz``) so compared models never
        share a checkpoint, and a resume only applies to models whose file
        exists (the others start fresh).

    Returns a Table ranked best-first with columns ``model``, ``log_z``,
    ``dlog_z`` (stepping-stone MC uncertainty), ``delta_log_z`` (log Bayes
    factor relative to the best model) and ``ddelta_log_z`` (its
    uncertainty, the two MC errors in quadrature); ``table.meta["info"]``
    keeps each run's full ladder diagnostics. Evidence is prior-sensitive:
    comparisons are only meaningful for deliberately chosen priors, so the
    priors are echoed in the printed report.
    """
    from .utils.table import Table

    models, priors, p_lo, p_up, labels = _compare_args(models, priors, p_lo,
                                                       p_up, labels)

    per_model_path = _per_model_checkpoint_path
    ck_base = evidence_kwargs.pop("checkpoint_file", None)
    resume_base = evidence_kwargs.pop("resume_from", None)

    rows = []
    for label, model, pri, lo, up in zip(labels, models, priors, p_lo, p_up):
        resume = per_model_path(resume_base, label)
        if resume is not None and not os.path.exists(resume):
            resume = None                       # this model starts fresh
        log_z, log_z_err, info = lightcurve_evidence(
            lc, model, pri, p_lo=lo, p_up=up, quiet=True,
            checkpoint_file=per_model_path(ck_base, label),
            resume_from=resume, **evidence_kwargs)
        rows.append((label, log_z, log_z_err, info, pri))

    rows.sort(key=lambda r: -r[1])
    best_z, best_err = rows[0][1], rows[0][2]
    table = Table(
        [[r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
         [r[1] - best_z for r in rows],
         [0.0 if i == 0 else np.hypot(r[2], best_err)
          for i, r in enumerate(rows)]],
        names=["model", "log_z", "dlog_z", "delta_log_z", "ddelta_log_z"])
    table.meta["info"] = {r[0]: r[3] for r in rows}
    if not quiet:
        print("model comparison (log Bayes factors vs best; "
              "evidence is prior-sensitive):")
        for i, (label, log_z, err, _, pri) in enumerate(rows):
            mark = " <- preferred" if i == 0 else ""
            print(f"  {label}: log Z = {log_z:.2f} +/- {err:.2f}, "
                  f"delta = {log_z - best_z:+.2f}{mark}")
            print("    priors: " + ", ".join(repr(p) for p in pri))
    return table


class _PTFitResult:
    """Cold-rung (beta = 1) production states of a parallel-tempering run,
    exposing the sampler surface the rest of the workflow expects, plus the
    evidence the ladder yields for free."""

    def __init__(self, cold_chain, cold_logl, log_z, log_z_err, info):
        self._chain = cold_chain          # (nsteps, nwalkers, ndim)
        self.cold_logl = cold_logl
        self.log_z = log_z
        self.log_z_err = log_z_err
        self.info = info
        self.swap_rate = info["swap_rate"]
        self.acceptance_fraction = np.broadcast_to(
            info["acceptance"][-1], cold_chain.shape[1:2]).copy()

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self._chain.shape[-1])

    @property
    def flatlnlikelihood(self):
        return self.cold_logl.reshape(-1)


def lightcurve_ptmcmc(lc, model, priors, p_lo=None, p_up=None, nwalkers=64,
                      n_rungs=16, nsteps=1000, nsteps_burnin=1000,
                      use_sigma=False, sigma_type="relative", seed=None,
                      mesh=None, save_sampler_as="", quiet=False,
                      checkpoint_every=None, checkpoint_file=None,
                      resume_from=None, state_dtype="auto"):
    """Parallel-tempering fit: robust to multimodal posteriors, and the
    evidence comes free.

    A ladder of tempered ensembles (hot rungs see a flattened likelihood and
    roam between modes; replica-exchange swaps carry their states down to the
    cold beta = 1 rung) runs as one compiled kernel — the stretch move alone
    cannot cross deep valleys between modes, which is when to reach for this
    over :func:`lightcurve_mcmc`. The same ladder yields the stepping-stone
    evidence, so ``result.log_z`` is populated at no extra cost (see
    :func:`lightcurve_evidence` for the model-comparison workflow and the
    prior-normalization caveats).

    Returns a :class:`_PTFitResult`: ``flatchain``/``chain`` are the cold
    rung's production states (posterior samples), ``log_z``/``log_z_err``
    the evidence, ``swap_rate`` the per-rung exchange acceptance (healthy
    ladders sit around 0.2-0.8; a rate near 0 flags a temperature gap).
    """
    from .parallel.evidence import stepping_stone_evidence

    log_prior_fn, log_like_fn, p0, state_kw, fns_key = _tempered_setup(
        lc, model, priors, p_lo, p_up, nwalkers, use_sigma, sigma_type, seed,
        state_dtype=state_dtype)
    log_z, log_z_err, info = stepping_stone_evidence(
        log_prior_fn, log_like_fn, p0, n_rungs=n_rungs, nsteps=nsteps,
        nsteps_burnin=nsteps_burnin, seed=seed if seed is not None else 0,
        return_cold_chain=True, mesh=mesh, checkpoint_every=checkpoint_every,
        checkpoint_file=checkpoint_file, resume_from=resume_from,
        state_dtype=state_kw.get("dtype"), fns_key=fns_key)
    cold = info.pop("cold_chain")
    if state_kw:
        # map the rescaled float32 cold chain back to absolute parameters
        cold = (np.asarray(cold, np.float64) * state_kw["param_scale"]
                + state_kw["param_offset"])
    result = _PTFitResult(cold, info.pop("cold_logl"),
                          log_z, log_z_err, info)
    if save_sampler_as:
        np.save(save_sampler_as, result.flatchain)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        print(f"PT: {n_rungs + 1} rungs x {nwalkers} walkers x {nsteps} steps; "
              f"cold acceptance {info['acceptance'][-1]:.2f}, swap rates "
              f"{info['swap_rate'].min():.2f}-{info['swap_rate'].max():.2f}; "
              f"log evidence {log_z:.2f} +/- {log_z_err:.2f}")
        try:
            goodness_of_fit(lc, model, result.flatchain,
                            use_sigma=use_sigma, sigma_type=sigma_type)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


# --------------------------------------------------------------------------
# posterior visualization
# --------------------------------------------------------------------------

def _offset_time_origin(flatchain, model, t0_offset):
    """Subtract a round reference date from any explosion-epoch-like column so
    corner axes show small numbers (reference fitting.py:243-251). Returns the
    shifted copy, per-axis labels, and the offset used."""
    shifted = flatchain.copy()
    labels = model.axis_labels
    for var in ("t_0", "t_\\mathrm{max}"):
        if var not in model.input_names:
            continue
        i = model.input_names.index(var)
        if t0_offset is None:
            t0_offset = np.floor(shifted[:, i].min())
        if t0_offset != 0.0:
            shifted[:, i] -= t0_offset
            offset_text = "{:f}".format(t0_offset).rstrip("0").rstrip(".")
            labels[i] = f"${var} - {offset_text}$ (d)"
    return shifted, labels, t0_offset


def lightcurve_corner(lc, model, sampler_flatchain, model_kwargs=None,
                      num_models_to_plot=100, lcaxis_posn=(0.7, 0.55, 0.2, 0.4),
                      filter_spacing=1.0, tmin=None, tmax=None, t0_offset=None,
                      save_plot_as="", ycol=None, textsize="medium", param_textsize="large",
                      use_sigma=False, xscale="linear", filters_to_model=None,
                      label_filters=True, lc_plot_kwargs=None, model_plot_kwargs=None,
                      seed=None):
    """Corner plot of the posterior with a light-curve inset showing posterior-
    draw model curves (behavioral spec: reference fitting.py:171-277).
    ``seed`` makes the inset's posterior-draw selection reproducible."""
    if model_kwargs is not None:
        raise Exception(MODEL_KWARGS_WARNING)
    if ycol is None:
        ycol = model.output_quantity
    import matplotlib.pyplot as plt
    plt.style.use(_STYLE)
    _ensure_sigma_param(model, use_sigma)

    sampler_flatchain = np.asarray(sampler_flatchain)
    corner_chain, corner_labels, t0_offset = _offset_time_origin(
        sampler_flatchain, model, t0_offset)

    fig = _corner(corner_chain, labels=corner_labels, label_kwargs={"size": textsize})
    ndim = sampler_flatchain.shape[-1]
    corner_axes = np.array(fig.get_axes()).reshape(ndim, ndim)
    for i in range(ndim):
        corner_axes[i, 0].tick_params(labelsize=textsize)
        corner_axes[-1, i].tick_params(labelsize=textsize)
    for ax in np.diag(corner_axes):
        for side in ("top", "left", "right"):
            ax.spines[side].set_visible(False)
        ax.xaxis.set_ticks_position("bottom")
        ax.yaxis.set_ticks_position("none")

    ax = fig.add_axes(lcaxis_posn)
    lightcurve_model_plot(lc, model, sampler_flatchain, model_kwargs, num_models_to_plot,
                          filter_spacing, tmin, tmax, ycol, textsize, ax, t0_offset,
                          use_sigma, xscale, filters_to_model, label_filters,
                          lc_plot_kwargs, model_plot_kwargs, seed=seed)

    paramtexts = format_credible_interval(sampler_flatchain, varnames=model.input_names,
                                          units=model.units)
    fig.text(0.45, 0.95, "\n".join(paramtexts), va="top", ha="center",
             fontdict={"size": param_textsize})
    if save_plot_as:
        fig.savefig(save_plot_as)
        print("saving figure as " + save_plot_as)

    return fig, corner_axes, ax


def _posterior_curves(model, flatchain, xfit, ufilts, num, use_sigma, seed=None):
    """Evaluate the model on ``num`` random posterior draws over a dense time
    grid; also returns the SiFTO template component for companion-shocking
    models (dashed overlay, reference fitting.py:354-362). ``seed`` makes the
    draw selection reproducible."""
    choices = np.random.default_rng(seed).choice(flatchain.shape[0], num)
    ps = flatchain[choices].T
    params = ps[:-1] if use_sigma else ps
    y_fit = model(xfit, ufilts, *params)

    if isinstance(model, CompanionShocking):
        y_sifto = model.stretched_sifto(xfit, ufilts, *ps[3:5])
        y_sifto[ufilts == filtdict["r"]] *= ps[5]
        y_sifto[ufilts == filtdict["i"]] *= ps[6]
    elif isinstance(model, BaseCompanionShocking):
        y_sifto = model.stretched_sifto(xfit, ufilts, *ps[3:7])
    else:
        y_sifto = [None] * len(ufilts)
    return y_fit, y_sifto


def _y_axis_spec(ycol, y_fit, y_sifto, ufilts, ax):
    """Per-quantity scaling of the model curves and the matching axis label.
    Magnitudes convert the curves through the filters' absolute zero points
    and flip the axis (reference fitting.py:366-385)."""
    if ycol == "lum":
        yscale = 10.0 ** np.round(np.log10(y_fit.max()))
        label = "Luminosity $L_\\nu$ (10$^{{{:.0f}}}$ erg s$^{{-1}}$ Hz$^{{-1}}$) + Offset".format(
            np.log10(yscale) + 7)
        return "dlum", yscale, label, y_fit, y_sifto
    if ycol == "flux":
        yscale = 10.0 ** np.round(np.log10(y_fit.max()))
        label = "Flux $F_\\nu$ (10$^{{{:.0f}}}$ erg s$^{{-1}}$ m$^{{-2}}$ Hz$^{{-1}}$) + Offset".format(
            np.log10(yscale) + 7)
        return "dflux", yscale, label, y_fit, y_sifto
    if ycol == "absmag":
        m0 = np.array([[[filt.M0]] for filt in ufilts])
        y_fit, _ = flux2mag(y_fit, zp=m0)
        if y_sifto[0] is not None:
            y_sifto, _ = flux2mag(y_sifto, zp=m0)
        ax.invert_yaxis()
        return "dmag", 1.0, "Absolute Magnitude + Offset", y_fit, y_sifto
    raise ValueError(f'ycol="{ycol}" is not recognized. Use "lum", "absmag", "flux".')


def _split_model_kwargs(model_plot_kwargs):
    """Derive the solid-curve and dashed-overlay style kwargs from the user's
    model_plot_kwargs (colors always come from the filter)."""
    solid = dict(model_plot_kwargs or {})
    solid.pop("color", None)
    dashed = dict(solid)
    solid.setdefault("alpha", 0.05)
    dashed.pop("linestyle", None)
    dashed["ls"] = "--"
    return solid, dashed


def lightcurve_model_plot(lc, model, sampler_flatchain, model_kwargs=None,
                          num_models_to_plot=100, filter_spacing=1.0, tmin=None, tmax=None,
                          ycol=None, textsize="medium", ax=None, mjd_offset=None,
                          use_sigma=False, xscale="linear", filters_to_model=None,
                          label_filters=True, lc_plot_kwargs=None, model_plot_kwargs=None,
                          seed=None):
    """Observed photometry with posterior-draw model light curves overplotted
    (behavioral spec: reference fitting.py:280-429). ``seed`` makes the
    posterior-draw selection reproducible."""
    if model_kwargs is not None:
        raise Exception(MODEL_KWARGS_WARNING)
    if ycol is None:
        ycol = model.output_quantity
    if ax is None:
        import matplotlib.pyplot as plt
        ax = plt.axes()
    _ensure_sigma_param(model, use_sigma)

    sampler_flatchain = np.asarray(sampler_flatchain)
    tmin, tmax, xfit, ufilts = _model_plot_grid(lc, tmin, tmax, xscale,
                                                filters_to_model)

    y_fit, y_sifto = _posterior_curves(model, sampler_flatchain, xfit, ufilts,
                                       num_models_to_plot, use_sigma, seed=seed)
    _render_model_plot(lc, y_fit, y_sifto, xfit, ufilts, ycol, ax,
                       filter_spacing, tmin, mjd_offset, xscale, textsize,
                       label_filters, lc_plot_kwargs, model_plot_kwargs)


def _model_plot_grid(lc, tmin, tmax, xscale, filters_to_model):
    """Shared time-grid / filter-selection setup of the model-overlay plots."""
    if tmin is None:
        tmin = float(np.min(np.asarray(lc["MJD"])))
    if tmax is None:
        tmax = float(np.max(np.asarray(lc["MJD"])))
    xfit = np.geomspace(tmin, tmax, 1000) if xscale == "log" else np.linspace(tmin, tmax, 1000)
    if filters_to_model is None:
        ufilts = np.array(sorted(set(lc["filter"])), dtype=object)
    else:
        ufilts = np.array([filtdict[f] for f in filters_to_model], dtype=object)
    return tmin, tmax, xfit, ufilts


def _render_model_plot(lc, y_fit, y_sifto, xfit, ufilts, ycol, ax,
                       filter_spacing, tmin, mjd_offset, xscale, textsize,
                       label_filters, lc_plot_kwargs, model_plot_kwargs):
    """Shared rendering tail of the model-overlay plots: photometry points +
    per-filter posterior-draw curves on one axes (reference
    fitting.py:363-429)."""
    import matplotlib.pyplot as plt
    dycol, yscale, ylabel, y_fit, y_sifto = _y_axis_spec(ycol, y_fit, y_sifto, ufilts, ax)
    solid_kwargs, dashed_kwargs = _split_model_kwargs(model_plot_kwargs)

    if mjd_offset is None:
        mjd_offset = np.floor(tmin)
    if xscale == "log":
        ax.set_xscale("log")
        ax.xaxis.set_major_formatter(plt.FormatStrFormatter("%g"))
        lc = lc.where(MJD_min=mjd_offset)
    else:
        lc = lc.copy()
    lc["MJD"] = lc["MJD"] - mjd_offset
    lc[ycol] = lc[ycol] / yscale
    lc[dycol] = lc[dycol] / yscale
    plt.sca(ax)
    lc.plot(xcol="MJD", ycol=ycol, offset_factor=filter_spacing, appmag_axis=False,
            tight_layout=False, **(lc_plot_kwargs or {}))
    plt.autoscale(False)

    _, curve_labels, _ = filter_legend(np.array(ufilts, dtype=object), filter_spacing)
    for curves, sifto, filt, txt in zip(y_fit, y_sifto, ufilts, curve_labels):
        offset = -filt.offset * filter_spacing
        ax.plot(xfit - mjd_offset, curves / yscale + offset, color=filt.linecolor,
                **solid_kwargs)
        if sifto is not None:
            ax.plot(xfit - mjd_offset, np.median(sifto, axis=1) / yscale + offset,
                    color=filt.linecolor, **dashed_kwargs)
        if label_filters:
            ax.text(1.03, curves[-1, 0] / yscale + offset, txt, color=filt.textcolor,
                    fontdict={"size": textsize}, ha="left", va="center",
                    transform=ax.get_yaxis_transform())
    ax.set_xlabel("MJD $-$ {:f}".format(mjd_offset).rstrip("0").rstrip("."), size=textsize)
    ax.set_ylabel(ylabel, size=textsize)
    ax.tick_params(labelsize=textsize)


def stacked_model_plot(lc, comparison, num_models_to_plot=100,
                       filter_spacing=1.0, tmin=None, tmax=None, ycol=None,
                       textsize="medium", ax=None, mjd_offset=None,
                       xscale="linear", filters_to_model=None,
                       label_filters=True, lc_plot_kwargs=None,
                       model_plot_kwargs=None, seed=None):
    """Model-AVERAGED posterior-draw light curves: each plotted curve comes
    from candidate k with probability equal to its Yao+18 stacking weight,
    so the overlay shows the stacked mixture's predictive distribution
    rather than a single winner's.

    ``comparison`` is the Table returned by :func:`compare_models_loo`
    (its ``meta`` carries the fitted samplers and models; the
    ``stacking_weight`` column carries the mixture). Candidates with zero
    allocated draws are simply absent. Returns the dict of draw counts per
    label actually used."""
    if ax is None:
        import matplotlib.pyplot as plt
        ax = plt.axes()
    labels = [str(lb) for lb in comparison["model"]]
    weights = np.asarray(comparison["stacking_weight"], float)
    samplers = comparison.meta["samplers"]
    models = comparison.meta["models"]
    use_sigma = comparison.meta.get("use_sigma", False)
    quantities = {models[lb].output_quantity for lb in labels}
    if len(quantities) > 1:
        raise ValueError("cannot stack candidates with different output "
                         f"quantities ({sorted(quantities)}): their curves "
                         "are not commensurable on one axis")
    if ycol is None:
        ycol = models[labels[0]].output_quantity
    if num_models_to_plot < 1:
        raise ValueError("num_models_to_plot must be >= 1")

    tmin, tmax, xfit, ufilts = _model_plot_grid(lc, tmin, tmax, xscale,
                                                filters_to_model)

    rng = np.random.default_rng(seed)
    counts = rng.multinomial(num_models_to_plot, weights / weights.sum())
    pieces = []
    for lb, n_k in zip(labels, counts):
        if n_k == 0:
            continue
        y_k, _ = _posterior_curves(models[lb], samplers[lb].flatchain, xfit,
                                   ufilts, int(n_k), use_sigma,
                                   seed=rng.integers(2 ** 31))
        pieces.append(y_k)
    y_fit = np.concatenate(pieces, axis=-1)  # (B, N, num) mixture draws
    _render_model_plot(lc, y_fit, [None] * len(ufilts), xfit, ufilts, ycol,
                       ax, filter_spacing, tmin, mjd_offset, xscale, textsize,
                       label_filters, lc_plot_kwargs, model_plot_kwargs)
    return {lb: int(n) for lb, n in zip(labels, counts)}


# --------------------------------------------------------------------------
# credible-interval formatting
# --------------------------------------------------------------------------

def _decimals_for(uncertainty, sigfigs):
    """Decimal places that keep ``sigfigs`` significant figures of the
    uncertainty. A degenerate (zero-width or non-finite) interval displays as
    an integer rather than crashing on log10(0)."""
    if not np.isfinite(uncertainty) or uncertainty <= 0.0:
        return 0
    return sigfigs - int(np.floor(np.log10(uncertainty))) - 1


def _interval_tex(lower_q, center_q, upper_q, sigfigs):
    """LaTeX ``c ± u`` / ``c^{+u}_{-l}`` for one parameter, rounded so the
    smaller uncertainty shows ``sigfigs`` significant figures. Rounding is
    applied twice: rounding the uncertainty itself can change its magnitude
    (0.098 -> 0.1), which changes the decimal place everything else rounds to
    (behavior of reference fitting.py:432-494)."""
    unc_lo = center_q - lower_q
    unc_up = upper_q - center_q
    smaller = min(unc_lo, unc_up)
    decimals = _decimals_for(smaller, sigfigs)
    decimals = _decimals_for(np.round(smaller, decimals), sigfigs)
    center = np.round(center_q, decimals)
    lo = np.round(unc_lo, decimals)
    up = np.round(unc_up, decimals)
    decimals = max(decimals, 0)
    if lo == up:
        return f"{center:.{decimals}f} \\pm {up:.{decimals}f}"
    return f"{center:.{decimals}f}^{{+{up:.{decimals}f}}}_{{-{lo:.{decimals}f}}}"


def _attach_units(texstrings, varnames, units):
    """Wrap each interval as ``$name = value$ unit``. Quantity units factor
    out their scale as ``x 10^e``; the reference then strips any ``.0}``
    substring from the wrapped value (including inside the interval braces) —
    that quirk is preserved for output parity (reference fitting.py:486-492)."""
    paramtexts = []
    for var, value, unit in zip(varnames, texstrings, units):
        if isinstance(unit, u.Quantity):
            wrapped = "({}) \\times 10^{{{:.1f}}}".format(value, np.log10(unit.value))
            value = re.sub(r"\.0\}", "}", wrapped)
            unit = unit.unit
        paramtexts.append("${} = {}$ {:latex_inline}".format(var, value, unit))
    return paramtexts


def format_credible_interval(x, sigfigs=1, percentiles=(15.87, 50.0, 84.14), axis=0,
                             varnames=None, units=None):
    """LaTeX equal-tailed credible intervals with sig-fig rounding of the
    uncertainty (behavioral spec: reference fitting.py:432-494; the 84.14
    default upper percentile reproduces the reference's documented default —
    callers wanting exact 1-sigma should pass (15.87, 50.0, 84.13))."""
    quantile_rows = np.atleast_2d(np.percentile(np.asarray(x), percentiles, axis=axis).T)
    texstrings = [_interval_tex(lo, mid, hi, sigfigs) for lo, mid, hi in quantile_rows]
    if varnames is None or units is None:
        return texstrings
    return _attach_units(texstrings, varnames, units)
