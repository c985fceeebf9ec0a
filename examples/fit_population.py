#!/usr/bin/env python
"""Population fitting demo (BASELINE.json config 5): fit many transients
concurrently in a single device call, optionally sharded across a mesh.

Generates a synthetic population of shock-cooling transients, fits each with
its own 64-walker ensemble, and prints per-transient posterior summaries.

Run: python examples/fit_population.py [n_transients]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # run without installing

# LCF_EXAMPLE_FAST=1: smoke-run sizes so the test suite can execute this
# script end-to-end (tests/test_examples.py); results are NOT converged there
FAST = bool(os.environ.get("LCF_EXAMPLE_FAST"))

import time

import numpy as np

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior
from lightcurve_fitting_tpu.parallel import fit_population

S = int(sys.argv[1]) if len(sys.argv) > 1 else (8 if FAST else 64)
rng = np.random.default_rng(0)

# ------------------------------------------------------- synthetic population
filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
lcs, models, truths = [], [], []
for s in range(S):
    T1 = rng.uniform(8.0, 20.0)
    L1 = rng.uniform(1.0, 4.0)
    ttr = rng.uniform(25.0, 50.0)
    truths.append((T1, L1, ttr))
    n_epochs = rng.integers(4, 8)
    t = np.repeat(np.linspace(1.0, 8.0, n_epochs), len(filters))
    f = np.array(filters * n_epochs)
    m = ShockCooling2()
    y_true = m(t, f, T1, L1, ttr, 0.0)
    dy = 0.05 * y_true
    y = y_true + rng.normal(scale=dy)
    lc = LC([t, f, y, dy], names=["MJD", "filter", "lum", "dlum"])
    lcs.append(lc)
    models.append(ShockCooling2(lc))

# ----------------------------------------------------------------- joint fit
# summaries=True + return_chains=False: per-transient percentiles are computed
# on device and the (S, nsteps*nwalkers, ndim) chains never transfer to the
# host (pass return_chains=True if you need the raw samples)
priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0), UniformPrior(5.0, 100.0)]
t0 = time.time()
flat, acc, summ = fit_population(models, lcs, priors,
                                 p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                                 nwalkers=16 if FAST else 64,
                                 nsteps=40 if FAST else 500,
                                 nsteps_burnin=20 if FAST else 100,
                                 seed=1, init="map",
                                 summaries=True, return_chains=False)
print(f"fit {S} transients in {time.time() - t0:.1f}s "
      f"(incl. compilation; repeat calls reuse the executable; init='map' "
      f"seeds every transient at its MAP so 100 burn-in steps suffice)")

ok = 0
for s in range(min(S, 10)):
    (t_lo, t_med, t_hi) = summ[s, 0]
    print(f"transient {s:3d}: T1 = {t_med:5.2f} (+{t_hi-t_med:.2f}/-{t_med-t_lo:.2f}) "
          f"[truth {truths[s][0]:5.2f}]  acceptance {acc[s]:.2f}")
for s in range(S):
    if abs(summ[s, 0, 1] - truths[s][0]) < 0.2 * truths[s][0]:
        ok += 1
print(f"T1 recovered within 20% for {ok}/{S} transients")

# ------------------------------------------------- survey-level diagnostics
# Per-transient goodness of fit and information criteria, each ONE padded
# device call over the whole survey (not a Python loop). These need the raw
# chains, so refit a subset with return_chains=True; pack_population's
# content-keyed cache means re-packing the same transients re-uses the
# already-shipped device buffers.
from lightcurve_fitting_tpu.parallel.population import (
    population_goodness_of_fit, population_information_criteria)

S_diag = min(S, 8)
flat, _ = fit_population(models[:S_diag], lcs[:S_diag], priors,
                         p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                         nwalkers=16 if FAST else 64,
                         nsteps=40 if FAST else 500,
                         nsteps_burnin=20 if FAST else 100,
                         seed=1, init="map", summaries=False)
gof = population_goodness_of_fit(models[:S_diag], lcs[:S_diag],
                                 np.asarray(flat), seed=0, quiet=True)
ic = population_information_criteria(models[:S_diag], lcs[:S_diag],
                                     np.asarray(flat), seed=0, quiet=True)
for s in range(S_diag):
    print(f"transient {s:3d}: chi2/nu = {gof['chi2_nu'][s]:6.2f} "
          f"(p = {gof['p_value'][s]:.3f})  elpd_loo = {ic['elpd_loo'][s]:8.2f} "
          f"(max pareto_k {np.max(ic['pareto_k'][s]):.2f})")
