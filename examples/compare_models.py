#!/usr/bin/env python
"""Chain-based model comparison on the SN 2016bkv early light curve:
SW17 (ShockCooling) vs MSW23 (ShockCooling4), ranked by PSIS-LOO elpd with
paired standard errors, Yao+18 stacking weights, a model-averaged overlay
plot, and leave-one-band-out scores for the winner.

``compare_models_loo`` wraps the whole loop — one ``lightcurve_mcmc`` fit
per candidate, one vmapped device call each for the pointwise
log-likelihood matrix, PSIS-LOO + paired ranking on top. It is the
prior-volume-insensitive sibling of the stepping-stone ``compare_models``
(see the notebook for that route; both appear in `lcfit compare` as
``"method": "loo"`` / ``"evidence"``).

Run: python examples/compare_models.py        (a few minutes on CPU;
     the chains must converge for elpd to mean anything — production
     comparisons should use the notebook's 1000+1000-step settings)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # run without installing

# LCF_EXAMPLE_FAST=1: smoke-run sizes so the test suite can execute this
# script end-to-end (tests/test_examples.py); results are NOT converged there
FAST = bool(os.environ.get("LCF_EXAMPLE_FAST"))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.models import (ShockCooling, ShockCooling4,
                                           UniformPrior, LogUniformPrior)
from lightcurve_fitting_tpu.fitting import (compare_models_loo,
                                            information_criteria,
                                            stacked_model_plot)

lc = LC.read(os.path.join(os.path.dirname(__file__), "..",
                          "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
lc.meta.update(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
lc.calcAbsMag()
lc.calcLum()
lc_early = lc.where(MJD_min=57468.0, MJD_max=57485.0)

# SW17 and MSW23 share the physical (v_s*, M_env, f_rho M, R, t_0) space,
# so one prior/window set serves both candidates
phys_priors = [UniformPrior(0.1, 20.0), UniformPrior(0.1, 30.0),
               LogUniformPrior(0.01, 100.0), UniformPrior(0.01, 50.0),
               UniformPrior(57468.0, 57468.7)]
p_lo = [0.5, 0.5, 0.1, 0.1, 57468.3]
p_up = [10.0, 20.0, 10.0, 20.0, 57468.7]

comparison = compare_models_loo(
    lc_early, [ShockCooling(lc_early), ShockCooling4(lc_early)],
    phys_priors, p_lo=p_lo, p_up=p_up,
    labels=["SW17 (ShockCooling)", "MSW23 (ShockCooling4)"],
    nwalkers=16 if FAST else 64, nsteps=40 if FAST else 500,
    nsteps_burnin=40 if FAST else 500, seed=7)

print()
print(comparison)  # model | elpd_loo | d_elpd | se_d_elpd | stacking_weight

# model-averaged overlay: posterior-draw curves allocated by stacking weight
counts = stacked_model_plot(lc_early, comparison, num_models_to_plot=100,
                            seed=0)
plt.savefig("stacked_models.png", dpi=120)
print(f"stacked_models.png written (draws per model: {counts})")

# leave-one-band-out for the winner: can it predict a held-out filter?
best = comparison["model"][0]
sampler = comparison.meta["samplers"][best]
ic = information_criteria(lc_early, comparison.meta["models"][best],
                          sampler.flatchain, group_by="filter", quiet=True)
logo = ic["logo"]
print(f"\n{best}: leave-one-band-out elpd = "
      f"{logo['elpd_logo']:.1f} +/- {logo['se_elpd_logo']:.1f} "
      f"over {len(logo['groups'])} bands "
      f"(pointwise LOO elpd = {ic['elpd_loo']:.1f})")
