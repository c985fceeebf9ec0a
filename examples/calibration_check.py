#!/usr/bin/env python
"""Simulation-based calibration + model comparison demo.

1. SBC (Talts et al. 2018): validate that likelihood + priors + sampler
   yield calibrated posteriors — n_sims prior-predictive ShockCooling2
   datasets, all fit in ONE fit_population device call, truths ranked among
   thinned posterior draws, per-parameter uniformity tested.
2. Chain-based model comparison: compare_models_loo ranks a
   truth-compatible prior choice against one pinning t_tr far too low, by
   PSIS-LOO elpd with paired standard errors.

Run: python examples/calibration_check.py [n_sims]
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
from lightcurve_fitting_tpu.parallel.sbc import (simulation_based_calibration,
                                                 plot_sbc)
from lightcurve_fitting_tpu.fitting import compare_models_loo

n_sims = int(sys.argv[1]) if len(sys.argv) > 1 else (8 if FAST else 128)

# ------------------------------------------------------------- 1. SBC
model = ShockCooling2()
priors = [UniformPrior(8.0, 20.0), UniformPrior(1.0, 4.0),
          UniformPrior(25.0, 50.0), UniformPrior(-1.0, 1.0)]
start = time.time()
res = simulation_based_calibration(
    model, priors, times=np.linspace(1.0, 8.0, 5),
    filters=["g", "r", "i", "B"], n_sims=n_sims, n_ranks=63,
    nwalkers=16 if FAST else 32, nsteps=60 if FAST else 600,
    nsteps_burnin=40 if FAST else 400, seed=3)
print(f"  ({n_sims} prior-predictive fits in {time.time() - start:.1f} s)")
import matplotlib
matplotlib.use("Agg")
plot_sbc(res, model, save_plot_as="sbc_ranks.png")

# ------------------------------------------- 2. chain-based model comparison
rng = np.random.default_rng(4)
filters = [filtdict[n] for n in ["g", "r", "i", "B"]]
t = np.repeat(np.linspace(1.0, 12.0, 7), len(filters))
f = np.array(filters * 7)
y_true = ShockCooling2()(t, f, 12.0, 2.0, 15.0, 0.0)
dy = 0.05 * y_true
lc = LC([t, f, y_true + rng.normal(scale=dy), dy],
        names=["MJD", "filter", "lum", "dlum"])

good = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0),
        UniformPrior(5.0, 100.0), UniformPrior(-1.0, 1.0)]
pinned = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0),
          UniformPrior(1.0, 3.0), UniformPrior(-1.0, 1.0)]
compare_models_loo(lc, [ShockCooling2(lc), ShockCooling2(lc)],
                   [good, pinned],
                   p_lo=[[10.0, 1.5, 10.0, -0.3], [10.0, 1.5, 1.2, -0.3]],
                   p_up=[[14.0, 2.5, 25.0, 0.3], [14.0, 2.5, 2.8, 0.3]],
                   labels=["free t_tr", "pinned t_tr"],
                   nwalkers=16 if FAST else 32, nsteps=30 if FAST else 300,
                   nsteps_burnin=30 if FAST else 300, seed=6)
