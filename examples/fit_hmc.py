#!/usr/bin/env python
"""Gradient-based NUTS on the SN 2016bkv ShockCooling2 posterior — inference the
reference package cannot perform (its numpy models are not differentiable).

One call: ``lightcurve_hmc`` warm-starts from a short ensemble run, removes the
hard prior box with a bounds bijection, whitens with the warm covariance, and
runs the no-U-turn sampler (dynamic trajectories) — no manual mass-matrix or
trajectory-length tuning. Soft Gaussian priors keep gradients informative
everywhere.

Note what the chains reveal (see tests/test_hmc.py and VALIDATION.md): this
posterior is a *thin* ridge — HMC contracts onto it from a wide start ~50x
faster than the stretch-move ensemble, whose apparent posterior widths at
reference-default chain lengths are still dominated by the initialization
transient.

Run: python examples/fit_hmc.py
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
from lightcurve_fitting_tpu.fitting import lightcurve_hmc
from lightcurve_fitting_tpu.parallel import summarize_chain

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

result = lightcurve_hmc(lc_early, model, priors,
                        nchains=4 if FAST else 16,
                        nsamples=50 if FAST else 1000,
                        n_warmup=100 if FAST else 800, seed=1)
print(summarize_chain(result._chain, names=["T_1", "L_1", "t_tr", "t_0"]))
print("medians:", np.round(np.median(result.flatchain, axis=0), 4))
