"""Production fit CLI: drive any of the fit drivers from a JSON config.

The reference is notebook-driven (its only CLI is spectral calibration,
reference speccal.py:593-610); production pipelines need a headless entry
point. One config file describes the data, model, priors, driver, and
outputs:

    {
      "data": "photometry.csv",
      "meta": {"dm": 30.79, "redshift": 0.002,
               "extinction": {"U": 0.069, "B": 0.061}},
      "where": {"MJD_min": 57468.0, "MJD_max": 57485.0},
      "model": "ShockCooling2",
      "priors": [["Uniform", 0, 100], ["Uniform", 0, 100],
                 ["Uniform", 0, 100], ["Uniform", 57468.0, 57468.7]],
      "p_lo": [20, 2, 20, 57468.5],
      "p_up": [50, 5, 50, 57468.7],
      "driver": "mcmc",     // mcmc | hmc | map | ptmcmc | evidence | compare | population | bolometric | sbc
      "driver_kwargs": {"nwalkers": 100, "nsteps": 1000, "nsteps_burnin": 1000},
      "outputs": {"flatchain": "chain.npy", "corner": "corner.pdf",
                  "summary": "summary.json"}
    }

Run:  python -m lightcurve_fitting_tpu.fit_cli fit.json
      (or the installed ``lcfit`` console script)

The summary JSON records the posterior medians and 16/84 percentiles per
parameter (or the MAP/stderr, or log-evidence), plus the driver diagnostics
and, for chain-producing drivers, the posterior-predictive goodness of fit
(`fitting.goodness_of_fit`).
"""

import argparse
import json
import os
import sys

import numpy as np

from .lightcurve import LC
from . import models as _models
from .models import UniformPrior, LogUniformPrior, GaussianPrior

_PRIORS = {"Uniform": UniformPrior, "LogUniform": LogUniformPrior,
           "Gaussian": GaussianPrior}


def _build_priors(spec):
    out = []
    for row in spec:
        kind, *args = row
        if kind not in _PRIORS:
            raise SystemExit(f"unknown prior type {kind!r}; "
                             f"choose from {sorted(_PRIORS)}")
        out.append(_PRIORS[kind](*args))
    return out


def _load_lc(cfg, config_dir):
    path = cfg["data"]
    if not os.path.isabs(path):
        path = os.path.join(config_dir, path)
    lc = LC.read(path)
    lc.meta.update(cfg.get("meta", {}))
    if cfg.get("where"):
        lc = lc.where(**cfg["where"])
    if not len(lc):
        raise SystemExit("no photometry rows left after the 'where' selection")
    return lc


def _summarize_chain(flatchain, model):
    med = np.median(flatchain, axis=0)
    lo, hi = np.percentile(flatchain, [15.87, 84.13], axis=0)
    return {name: {"median": float(m), "minus": float(m - l), "plus": float(h - m)}
            for name, m, l, h in zip(model.input_names, med, lo, hi)}


def _run_population(cfg, config_dir):
    """``driver: "population"`` — ``data`` is a LIST of photometry files;
    every transient is fit concurrently in one device call
    (`parallel.fit_population`; ``driver_kwargs`` passes through, e.g.
    ``init: "map"`` for MAP-seeded short burn-ins). The summary JSON carries
    per-transient posteriors keyed by file name. ``meta`` and ``where``
    apply to every file; per-transient metadata (distance modulus, redshift,
    extinction) goes in an optional ``per_file`` mapping keyed by the file
    name, merged over the shared ``meta``."""
    model_cls = getattr(_models, cfg["model"], None)
    if model_cls is None:
        raise SystemExit(f"unknown model {cfg['model']!r}")
    priors = _build_priors(cfg["priors"])
    if "p_lo" not in cfg or "p_up" not in cfg:
        raise SystemExit('driver "population" requires p_lo and p_up')

    lcs, names = [], []
    per_file = cfg.get("per_file", {})
    for path in cfg["data"]:
        name = os.path.basename(path)
        meta = dict(cfg.get("meta", {}))
        meta.update(per_file.get(name, {}).get("meta", {}))
        sub = dict(cfg, data=path, meta=meta)
        lcs.append(_load_lc(sub, config_dir))
        names.append(name)
    models = [model_cls(lc) for lc in lcs]

    from .parallel.population import fit_population
    kw = dict(cfg.get("driver_kwargs", {}))
    want_summaries = bool(kw.get("summaries", False))
    return_chains = bool(kw.get("return_chains", True))
    out = fit_population(models, lcs, priors, cfg["p_lo"], cfg["p_up"], **kw)
    # fit_population returns (flat, acc) or, with summaries=True, a 3-tuple
    # (flat, acc, (S, ndim, 3) 16/50/84 percentiles); with return_chains=False
    # flat is None and the percentiles are the only posterior record (the
    # fast path: chains never reach the host).
    if want_summaries:
        flat, acc, summ = out
    else:
        flat, acc = out
        summ = None

    summary = {"driver": "population", "model": cfg["model"],
               "n_transients": len(lcs), "transients": {}}
    for s, name in enumerate(names):
        if flat is not None:
            per = _summarize_chain(flat[s], models[s])
        else:
            # on-device 16/50/84 percentiles (vs _summarize_chain's
            # 15.87/84.13) — the documented summaries=True convention
            per = {pname: {"median": float(q[1]),
                           "minus": float(q[1] - q[0]),
                           "plus": float(q[2] - q[1])}
                   for pname, q in zip(models[s].input_names, summ[s])}
        summary["transients"][name] = dict(per, acceptance=float(acc[s]))

    outputs = cfg.get("outputs", {})

    def outpath(key):
        p = outputs.get(key)
        if p is not None and not os.path.isabs(p):
            p = os.path.join(config_dir, p)
        return p

    if outpath("flatchains"):
        if flat is None:
            print("note: outputs.flatchains skipped (return_chains=false — "
                  "chains were never transferred off device)")
        else:
            np.save(outpath("flatchains"), flat)
    if outpath("summary"):
        with open(outpath("summary"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def _run_bolometric(cfg, config_dir):
    """``driver: "bolometric"`` — the per-epoch blackbody pipeline
    (`bolometric.calculate_bolometric`): no model/priors keys; pass pipeline
    options (res, colors, batch_mode, nwalkers, steps, ...) through
    ``driver_kwargs``. Writes the results table (``outputs.table``, ascii
    fixed-width like the reference) and per-epoch corner PDFs into
    ``outputs.outpath`` (default: alongside the config)."""
    from .bolometric import calculate_bolometric

    lc = _load_lc(cfg, config_dir)
    outputs = cfg.get("outputs", {})
    outpath = outputs.get("outpath", ".")
    if not os.path.isabs(outpath):
        outpath = os.path.join(config_dir, outpath)
    os.makedirs(outpath, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    t0 = calculate_bolometric(lc, outpath=outpath,
                              **cfg.get("driver_kwargs", {}))
    table_path = outputs.get("table")
    if table_path:
        if not os.path.isabs(table_path):
            table_path = os.path.join(config_dir, table_path)
        t0.write(table_path, format="ascii.fixed_width_two_line",
                 overwrite=True)
    summary = {"driver": "bolometric", "n_epochs": int(len(t0)),
               "columns": list(t0.colnames)}
    if outputs.get("summary"):
        p = outputs["summary"]
        if not os.path.isabs(p):
            p = os.path.join(config_dir, p)
        with open(p, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def _run_compare(cfg, config_dir):
    """``driver: "compare"`` — ``models`` is a LIST of model names ranked by
    Bayes factor (`fitting.compare_models`); ``priors`` is per-model (a list
    of prior lists) or one shared list; ``p_lo``/``p_up`` likewise. With
    ``"method": "loo"`` the ranking is chain-based PSIS-LOO elpd
    (`fitting.compare_models_loo`: one MCMC fit per model, prior-volume
    insensitive) instead of the evidence ladder."""
    lc = _load_lc(cfg, config_dir)
    models = []
    for name in cfg["models"]:
        cls = getattr(_models, name, None)
        if cls is None:
            raise SystemExit(f"unknown model {name!r}")
        models.append(cls(lc))
    raw = cfg["priors"]
    # per-model: a list of prior LISTS ([[["Uniform",0,100],...], [...]]);
    # shared: one flat list of ["Type", args...] rows
    per_model = (raw and isinstance(raw[0], list)
                 and raw[0] and isinstance(raw[0][0], list))
    priors = [_build_priors(p) for p in raw] if per_model else _build_priors(raw)

    from . import fitting
    method = cfg.get("method", "evidence")
    try:
        if method == "loo":
            table = fitting.compare_models_loo(lc, models, priors,
                                               p_lo=cfg.get("p_lo"),
                                               p_up=cfg.get("p_up"),
                                               labels=cfg.get("labels"),
                                               **cfg.get("driver_kwargs", {}))
        elif method == "evidence":
            table = fitting.compare_models(lc, models, priors,
                                           p_lo=cfg.get("p_lo"),
                                           p_up=cfg.get("p_up"),
                                           labels=cfg.get("labels"),
                                           **cfg.get("driver_kwargs", {}))
        else:
            raise SystemExit(f"unknown compare method {method!r}; "
                             "choose evidence | loo")
    except ValueError as exc:
        # config-shape errors (too few models, prior/label length mismatch)
        # surface as clean CLI errors like the other invalid-config paths
        raise SystemExit(str(exc))
    if method == "loo":
        summary = {"driver": "compare", "method": "loo",
                   "models": list(cfg["models"]),
                   "ranking": [dict(model=str(m), elpd_loo=float(e),
                                    d_elpd=float(d), se_d_elpd=float(se),
                                    stacking_weight=float(w))
                               for m, e, d, se, w in zip(
                                   table["model"], table["elpd_loo"],
                                   table["d_elpd"], table["se_d_elpd"],
                                   table["stacking_weight"])]}
    else:
        summary = {"driver": "compare", "method": "evidence",
                   "models": list(cfg["models"]),
                   "ranking": [dict(model=str(m), log_z=float(z),
                                    dlog_z=float(dz), delta_log_z=float(d))
                               for m, z, dz, d in zip(table["model"],
                                                      table["log_z"],
                                                      table["dlog_z"],
                                                      table["delta_log_z"])]}
    out = cfg.get("outputs", {}).get("summary")
    if out:
        if not os.path.isabs(out):
            out = os.path.join(config_dir, out)
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    # the plot is rendered AFTER the summary is safely written: a plotting
    # failure must not discard hours of fit work
    plot_out = cfg.get("outputs", {}).get("stacked_plot")
    if plot_out and method == "loo":
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            if not os.path.isabs(plot_out):
                plot_out = os.path.join(config_dir, plot_out)
            fig = plt.figure()
            fitting.stacked_model_plot(lc, table, ax=fig.add_subplot(),
                                       seed=cfg.get("driver_kwargs", {}).get("seed"))
            fig.savefig(plot_out, bbox_inches="tight")
            plt.close(fig)
        except Exception as exc:
            print(f"(stacked plot unavailable: {exc})", file=sys.stderr)
    return 0


def _run_sbc(cfg, config_dir):
    """``driver: "sbc"`` — simulation-based calibration of the configured
    model + priors (`parallel.sbc.simulation_based_calibration`): no
    ``data`` key (the photometry is simulated); ``times`` (epoch grid) and
    ``filters`` (band names observed at every epoch) are required;
    n_sims/nwalkers/nsteps/... pass through ``driver_kwargs``. Writes the
    per-parameter uniformity p-values (``outputs.summary``), the rank
    matrix (``outputs.ranks``, .npy) and the rank-histogram figure
    (``outputs.plot``)."""
    from .parallel.sbc import simulation_based_calibration, plot_sbc

    model_cls = getattr(_models, cfg["model"], None)
    if model_cls is None:
        raise SystemExit(f"unknown model {cfg['model']!r}")
    model = model_cls(redshift=cfg.get("meta", {}).get("redshift", 0.0))
    priors = _build_priors(cfg["priors"])
    res = simulation_based_calibration(model, priors, cfg["times"],
                                       cfg["filters"],
                                       p_lo=cfg.get("p_lo"),
                                       p_up=cfg.get("p_up"),
                                       **cfg.get("driver_kwargs", {}))
    summary = {"driver": "sbc", "model": cfg["model"],
               "n_sims": int(len(res["ranks"])),
               "n_ranks": int(res["n_ranks"]),
               "p_values": {name: float(p) for name, p in
                            zip(model.input_names, res["p_values"])},
               "calibrated": bool(res["p_values"].min() > 0.01)}
    outputs = cfg.get("outputs", {})

    def outpath(key):
        p = outputs.get(key)
        if p is not None and not os.path.isabs(p):
            p = os.path.join(config_dir, p)
        return p

    if outpath("ranks"):
        np.save(outpath("ranks"), res["ranks"])
    if outpath("plot"):
        import matplotlib
        matplotlib.use("Agg")
        plot_sbc(res, model, save_plot_as=outpath("plot"))
    if outpath("summary"):
        with open(outpath("summary"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="lcfit", description="Fit a light-curve model from a JSON config "
        "(see lightcurve_fitting_tpu.fit_cli docstring for the schema).")
    parser.add_argument("config", help="path to the JSON fit configuration")
    parser.add_argument("--compile-cache", nargs="?", const="", default=None,
                        metavar="DIR",
                        help="persist compiled XLA executables across lcfit "
                             "invocations (cached reruns skip compilation). "
                             "Optional DIR overrides $JAX_COMPILATION_CACHE_DIR "
                             "/ ~/.cache/lightcurve_fitting_tpu/xla")
    args = parser.parse_args(argv)

    if args.compile_cache is not None:
        from .core.config import enable_compilation_cache
        enable_compilation_cache(args.compile_cache or None)

    with open(args.config) as f:
        cfg = json.load(f)
    config_dir = os.path.dirname(os.path.abspath(args.config))
    required = {"bolometric": ("data",),
                "compare": ("data", "models", "priors"),
                "sbc": ("model", "priors", "times", "filters")}.get(
        cfg.get("driver"), ("data", "model", "priors"))
    for key in required:
        if key not in cfg:
            raise SystemExit(f"config is missing the required {key!r} key")

    if cfg.get("driver") == "population":
        return _run_population(cfg, config_dir)
    if cfg.get("driver") == "bolometric":
        return _run_bolometric(cfg, config_dir)
    if cfg.get("driver") == "compare":
        return _run_compare(cfg, config_dir)
    if cfg.get("driver") == "sbc":
        return _run_sbc(cfg, config_dir)

    lc = _load_lc(cfg, config_dir)
    model_cls = getattr(_models, cfg["model"], None)
    if model_cls is None:
        raise SystemExit(f"unknown model {cfg['model']!r}")
    model = model_cls(lc)
    priors = _build_priors(cfg["priors"])
    driver = cfg.get("driver", "mcmc")
    kw = dict(cfg.get("driver_kwargs", {}))
    # checkpoint paths resolve relative to the config file, like outputs
    for pk in ("checkpoint_file", "resume_from"):
        if kw.get(pk) and not os.path.isabs(kw[pk]):
            kw[pk] = os.path.join(config_dir, kw[pk])
    outputs = cfg.get("outputs", {})

    def outpath(key):
        p = outputs.get(key)
        if p is not None and not os.path.isabs(p):
            p = os.path.join(config_dir, p)
        return p

    from . import fitting

    summary = {"driver": driver, "model": cfg["model"],
               "n_points": int(len(lc))}
    flatchain = None
    if driver == "mcmc":
        sampler = fitting.lightcurve_mcmc(lc, model, priors=priors,
                                          p_lo=cfg.get("p_lo"),
                                          p_up=cfg.get("p_up"), **kw)
        flatchain = sampler.flatchain
        summary["acceptance"] = float(np.mean(sampler.acceptance_fraction))
    elif driver == "hmc":
        result = fitting.lightcurve_hmc(lc, model, priors,
                                        p_lo=cfg.get("p_lo"),
                                        p_up=cfg.get("p_up"), **kw)
        flatchain = result.flatchain
        summary["acceptance"] = float(np.mean(result.acceptance_fraction))
    elif driver == "ptmcmc":
        result = fitting.lightcurve_ptmcmc(lc, model, priors,
                                           p_lo=cfg.get("p_lo"),
                                           p_up=cfg.get("p_up"), **kw)
        flatchain = result.flatchain
        summary["log_z"] = result.log_z
        summary["log_z_err"] = result.log_z_err
        summary["swap_rate"] = [float(r) for r in result.swap_rate]
    elif driver == "map":
        result = fitting.lightcurve_map(lc, model, priors,
                                        p_lo=cfg.get("p_lo"),
                                        p_up=cfg.get("p_up"), **kw)
        flatchain = result.flatchain
        summary["map"] = {n: float(v) for n, v in
                          zip(model.input_names, result.parameters)}
        summary["stderr"] = {n: float(v) for n, v in
                             zip(model.input_names, result.stderr)}
        summary["at_bound"] = [bool(b) for b in result.at_bound]
        summary["log_posterior"] = result.log_posterior
    elif driver == "evidence":
        log_z, err, info = fitting.lightcurve_evidence(lc, model, priors,
                                                       p_lo=cfg.get("p_lo"),
                                                       p_up=cfg.get("p_up"), **kw)
        summary["log_z"] = log_z
        summary["log_z_err"] = err
        summary["rung_acceptance"] = [float(a) for a in info["acceptance"]]
    else:
        raise SystemExit(f"unknown driver {driver!r}; choose from "
                         "mcmc | hmc | map | ptmcmc | evidence | compare | sbc | "
                         "population | bolometric")

    if flatchain is not None:
        summary["posterior"] = _summarize_chain(flatchain, model)
        try:
            # diagnostics must never discard a finished fit: the chain and
            # summary still get written if the GOF evaluation fails
            gof = fitting.goodness_of_fit(lc, model, flatchain,
                                          use_sigma=kw.get("use_sigma", False),
                                          sigma_type=kw.get("sigma_type",
                                                            "relative"),
                                          quiet=True)
            summary["goodness_of_fit"] = {
                k: (float(v) if np.isfinite(v) else None)
                for k, v in gof.items()}
        except Exception as exc:
            summary["goodness_of_fit"] = {"error": str(exc)}
        try:
            # config keys: "ic_group_by" (an LC column, e.g. "filter") adds
            # leave-one-group-out scores; "ic_refit" (true or a pareto_k
            # threshold) repairs flagged PSIS terms by exact refit CV using
            # this fit's priors; "ic_refit_options" forwards sampler sizes
            ic_kw = {}
            if cfg.get("ic_group_by"):
                ic_kw["group_by"] = cfg["ic_group_by"]
            # identity checks, not truthiness: "ic_refit": 0.0 is a valid
            # pareto_k threshold (refit every k > 0 term), only absent/false
            # disables
            ic_refit = cfg.get("ic_refit")
            if ic_refit is not None and ic_refit is not False:
                ic_kw.update(refit=ic_refit, priors=priors,
                             refit_options=cfg.get("ic_refit_options"))
            ic = fitting.information_criteria(
                lc, model, flatchain, use_sigma=kw.get("use_sigma", False),
                sigma_type=kw.get("sigma_type", "relative"), quiet=True,
                **ic_kw)
            summary["information_criteria"] = {
                k: (float(v) if np.isfinite(v) else None)
                for k, v in ic.items()
                if isinstance(v, (int, float, np.floating))}
            summary["information_criteria"]["n_pareto_k_above_0.7"] = int(
                np.sum(ic["pareto_k"] > 0.7))
            if "refit" in ic:
                summary["information_criteria"]["refit_backed_points"] = \
                    [int(i) for i in ic["refit"]["labels"]]
                summary["information_criteria"]["refit_failed_points"] = \
                    [int(i) for i in ic["refit"]["failed_labels"]]
            if "logo" in ic:
                lg = ic["logo"]
                summary["information_criteria"]["logo"] = {
                    "elpd_logo": float(lg["elpd_logo"]),
                    "se_elpd_logo": float(lg["se_elpd_logo"]),
                    "groups": [str(g) for g in lg["groups"]],
                    "pareto_k": [float(k) for k in lg["pareto_k"]],
                    "pointwise": [float(e) for e in lg["pointwise"]],
                    "refit_backed": ([str(g) for g in lg["refit"]["labels"]]
                                     if "refit" in lg else []),
                    "refit_failed": ([str(g) for g in
                                      lg["refit"]["failed_labels"]]
                                     if "refit" in lg else []),
                }
        except Exception as exc:
            summary["information_criteria"] = {"error": str(exc)}
        if outpath("flatchain"):
            np.save(outpath("flatchain"), flatchain)
        if outpath("corner"):
            import matplotlib
            matplotlib.use("Agg")
            # forward use_sigma so the inset's model curves don't consume the
            # sigma column as a physics parameter (same kw the GOF/IC calls use)
            try:
                fitting.lightcurve_corner(lc, model, flatchain,
                                          use_sigma=kw.get("use_sigma", False),
                                          save_plot_as=outpath("corner"))
            except Exception as exc:
                # plot failures must never discard a finished fit's summary
                # (same contract as the GOF/IC blocks above)
                summary["corner_error"] = str(exc)

    if outpath("summary"):
        with open(outpath("summary"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
