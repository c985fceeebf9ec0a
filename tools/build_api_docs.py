#!/usr/bin/env python
"""Generate the API reference (docs/api.md) by introspection.

The reference ships a Sphinx/numpydoc API page (reference
docs/source/api.rst:1); this environment has neither sphinx nor pdoc baked
in, so a small generator renders the same artifact: every public class,
method, and function of the user-facing modules with its live signature and
docstring. Regenerate after API changes::

    python tools/build_api_docs.py

The suite checks the committed page is in sync (tests/test_docs.py).
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("MPLBACKEND", "Agg")

# (module, [explicit names] or None for __all__/public defs)
SECTIONS = [
    ("Light-curve data (L0)", "lightcurve_fitting_tpu.lightcurve",
     ["LC", "flux2mag", "mag2flux", "binflux"]),
    ("Filters & synthetic photometry (L1)", "lightcurve_fitting_tpu.filters",
     ["Filter", "filtdict", "extinction_law"]),
    ("Device photometry kernels", "lightcurve_fitting_tpu.ops.filterbank",
     ["FilterBank"]),
    ("Device quantiles", "lightcurve_fitting_tpu.ops.quantile",
     ["percentile_f32"]),
    ("Models (L2)", "lightcurve_fitting_tpu.models.base", ["Model"]),
    ("Shock-cooling models", "lightcurve_fitting_tpu.models.shock_cooling",
     ["ShockCooling", "ShockCooling2", "ShockCooling3", "ShockCooling4"]),
    ("Companion-shocking models", "lightcurve_fitting_tpu.models.companion_shocking",
     ["CompanionShocking", "CompanionShocking2", "CompanionShocking3"]),
    ("Blackbody core", "lightcurve_fitting_tpu.models.blackbody",
     ["planck_fast", "planck", "blackbody_to_filters"]),
    ("Priors", "lightcurve_fitting_tpu.models.priors",
     ["Prior", "UniformPrior", "LogUniformPrior", "GaussianPrior", "KDEPrior"]),
    ("Fit drivers (L4)", "lightcurve_fitting_tpu.fitting",
     ["lightcurve_mcmc", "lightcurve_hmc", "lightcurve_map",
      "lightcurve_evidence", "lightcurve_ptmcmc", "compare_models", "compare_models_loo",
      "goodness_of_fit", "information_criteria",
      "compare_information_criteria", "lightcurve_corner", "lightcurve_model_plot", "stacked_model_plot",
      "format_credible_interval", "make_log_posterior"]),
    ("Bolometric pipeline", "lightcurve_fitting_tpu.bolometric",
     ["calculate_bolometric", "spectrum_mcmc", "spectrum_corner",
      "blackbody_lstsq", "integrate_sed", "pseudo", "stefan_boltzmann",
      "group_by_epoch", "median_and_unc", "calc_colors",
      "plot_bolometric_results", "plot_color_curves", "plot_chain"]),
    ("Spectral calibration", "lightcurve_fitting_tpu.speccal",
     ["readspec", "readfitsspec", "readOSCspec", "convert_spectrum_units",
      "calibrate_spectra", "create_wiserep_tsv"]),
    ("Ensemble samplers (L3)", "lightcurve_fitting_tpu.parallel.sampler",
     ["EnsembleSampler"]),
    ("Walker sharding", "lightcurve_fitting_tpu.parallel.mesh",
     ["ShardedEnsembleSampler", "walker_mesh"]),
    ("Gradient samplers", "lightcurve_fitting_tpu.parallel.hmc",
     ["HMCSampler", "BoundsTransform", "WhitenedPosterior"]),
    ("No-U-Turn sampler", "lightcurve_fitting_tpu.parallel.nuts", ["NUTSSampler"]),
    ("Evidence & parallel tempering", "lightcurve_fitting_tpu.parallel.evidence",
     ["stepping_stone_evidence", "make_beta_ladder"]),
    ("Population fitting", "lightcurve_fitting_tpu.parallel.population",
     ["pack_population", "fit_population", "population_goodness_of_fit",
      "population_information_criteria", "population_compare_elpd"]),
    ("Batched bolometric kernels", "lightcurve_fitting_tpu.parallel.batched",
     ["pack_epochs", "batched_blackbody_mcmc", "batched_map_centers"]),
    ("Multi-host execution", "lightcurve_fitting_tpu.parallel.distributed",
     ["initialize", "process_info", "local_shard", "fit_population_local_shard"]),
    ("Optimization", "lightcurve_fitting_tpu.parallel.optimize",
     ["multistart_maximize", "laplace_covariance"]),
    ("Information criteria (WAIC / PSIS-LOO)", "lightcurve_fitting_tpu.parallel.ic",
     ["waic", "psis_loo", "gpd_fit", "psis_smooth", "compare_elpd",
      "psis_logo", "stacking_weights"]),
    ("Simulation-based calibration", "lightcurve_fitting_tpu.parallel.sbc",
     ["simulation_based_calibration", "rank_statistic", "plot_sbc"]),
    ("Diagnostics", "lightcurve_fitting_tpu.parallel.diagnostics", None),
    ("Profiling & observability", "lightcurve_fitting_tpu.utils.profiling",
     ["trace", "Throughput"]),
    ("Configuration", "lightcurve_fitting_tpu.core.config", None),
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + line for line in doc.splitlines())


def _render_function(name, fn, level="###"):
    out = [f"{level} `{name}{_sig(fn)}`", ""]
    doc = _doc(fn)
    if doc:
        out += [doc, ""]
    return out


def _render_class(name, cls):
    out = [f"### class `{name}{_sig(cls)}`", ""]
    doc = _doc(cls)
    if doc:
        out += [doc, ""]
    members = []
    for mname, m in inspect.getmembers(cls):
        if mname.startswith("_"):
            continue
        if inspect.isfunction(m) and m.__qualname__.startswith(cls.__name__ + "."):
            members.append((mname, m, "method"))
        elif isinstance(inspect.getattr_static(cls, mname, None), property):
            members.append((mname, m, "property"))
    for mname, m, kind in sorted(members):
        if kind == "method":
            out += [f"- **`.{mname}{_sig(m)}`**"]
        else:
            out += [f"- **`.{mname}`** (property)"]
        mdoc = inspect.getdoc(m.fget if kind == "property" and hasattr(m, "fget") else m)
        if mdoc:
            first = mdoc.splitlines()[0]
            out += [f"  {first}"]
    if members:
        out += [""]
    return out


def build():
    lines = [
        "# lightcurve_fitting_tpu — API reference",
        "",
        "*Generated by `tools/build_api_docs.py` — do not edit by hand;*",
        "*regenerate after API changes.*",
        "",
        "The JAX counterpart of `lightcurve_fitting`'s Sphinx API page",
        "(reference docs/source/api.rst). See `docs/usage.md` for the guided",
        "workflow and `docs/design.md` for the architecture.",
        "",
        "## Contents",
        "",
    ]
    toc, body = [], []
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        anchor = title.lower().replace(" ", "-").replace("(", "").replace(")", "").replace("&", "")
        toc.append(f"- [{title}](#{anchor}) — `{modname}`")
        body += [f"## {title}", "", f"Module: `{modname}`", ""]
        mdoc = inspect.getdoc(mod)
        if mdoc:
            body += [mdoc.splitlines()[0], ""]
        if names is None:
            names = getattr(mod, "__all__", None) or [
                n for n, o in inspect.getmembers(mod)
                if not n.startswith("_") and getattr(o, "__module__", None) == modname]
        for name in names:
            obj = getattr(mod, name)
            if inspect.isclass(obj):
                body += _render_class(name, obj)
            elif callable(obj):
                body += _render_function(name, obj)
            else:
                body += [f"### `{name}`", "", f"{type(obj).__name__}: "
                         f"{len(obj) if hasattr(obj, '__len__') else obj!r}"
                         + (" entries" if hasattr(obj, "__len__") else ""), ""]
    return "\n".join(lines + toc + [""] + body) + "\n"


if __name__ == "__main__":
    text = build()
    out = os.path.join(os.path.dirname(__file__), "..", "docs", "api.md")
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {os.path.normpath(out)} ({len(text.splitlines())} lines)")
