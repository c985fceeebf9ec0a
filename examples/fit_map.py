#!/usr/bin/env python
"""Instant MAP + Laplace fit of the SN 2016bkv ShockCooling2 posterior, then a
short MAP-seeded ensemble run — the fastest route to publication numbers.

``lightcurve_map`` runs a 64-start Adam ascent (all starts batched into one
compiled scan) and inverts the posterior curvature at the mode; parameters
pinned at a prior bound (here t_0 against its upper bound — physical) are
detected and the remaining curvature is taken conditional on them. The mode
and Laplace widths match the converged MCMC posterior to a few percent.

``lightcurve_mcmc(init="map")`` then seeds walkers from the Laplace draws, so
a 100-step burn-in suffices where wide-start ensembles need thousands of
steps on this thin curved ridge.

Run: python examples/fit_map.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # run without installing

# LCF_EXAMPLE_FAST=1: smoke-run sizes so the test suite can execute this
# script end-to-end (tests/test_examples.py); results are NOT converged there
FAST = bool(os.environ.get("LCF_EXAMPLE_FAST"))


import numpy as np

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.models import ShockCooling2, GaussianPrior
from lightcurve_fitting_tpu.fitting import lightcurve_map, lightcurve_mcmc

lc = LC.read(os.path.join(os.path.dirname(__file__), "..",
                          "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
lc.meta.update(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
lc.calcAbsMag()
lc.calcLum()
lc_early = lc.where(MJD_min=57468.0, MJD_max=57485.0)

model = ShockCooling2(lc_early)
priors = [GaussianPrior(0.0, 100.0, 30.0, 15.0),
          GaussianPrior(0.0, 100.0, 4.0, 3.0),
          GaussianPrior(0.0, 100.0, 30.0, 15.0),
          GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]

result = lightcurve_map(lc_early, model, priors, seed=0,
                        n_starts=8 if FAST else 64,
                        n_iter=200 if FAST else 1000)

# full sampling from the Laplace start: short burn-in is enough
sampler = lightcurve_mcmc(lc_early, model, priors=priors,
                          p_lo=[20, 2, 20, 57468.4], p_up=[50, 5, 50, 57468.69],
                          nwalkers=16 if FAST else 64,
                          nsteps=40 if FAST else 500,
                          nsteps_burnin=20 if FAST else 100,
                          init="map", seed=0)
print("MCMC medians:", np.round(np.median(sampler.flatchain, axis=0), 4))
print("MAP         :", np.round(result.parameters, 4))
