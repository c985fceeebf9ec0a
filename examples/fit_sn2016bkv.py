#!/usr/bin/env python
"""End-to-end workflow on the bundled SN 2016bkv photometry — the equivalent of
the reference's example notebook (lightcurve_fitting.ipynb) and docs walkthrough
(docs/source/usage.rst:174-214): load + plot the light curve, fit ShockCooling2
with ensemble MCMC, make the corner plot, then compute the bolometric light
curve.

Run: python examples/fit_sn2016bkv.py [outdir]
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
import numpy as np

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior
from lightcurve_fitting_tpu.fitting import lightcurve_mcmc, lightcurve_corner
from lightcurve_fitting_tpu.bolometric import calculate_bolometric, plot_bolometric_results

outdir = sys.argv[1] if len(sys.argv) > 1 else "example_output"
os.makedirs(outdir, exist_ok=True)

# ----------------------------------------------------------------- load + plot
lc = LC.read(os.path.join(os.path.dirname(__file__), "..",
                          "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
lc.meta["dm"] = 30.79
lc.meta["extinction"] = {"U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045,
                         "0": 0.035, "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020}
lc.meta["redshift"] = 0.002

lc.calcAbsMag()
lc.calcPhase()
plt.figure(figsize=(8, 6))
lc.plot(loc_filt="above", loc_mark="above right")
plt.savefig(os.path.join(outdir, "lightcurve.png"), dpi=120)
plt.close("all")

# ------------------------------------------------------------- shock cooling fit
lc_early = lc.where(MJD_min=57468.0, MJD_max=57485.0)
model = ShockCooling2(lc_early)
priors = [UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
          UniformPrior(0.0, 100.0), UniformPrior(57468.0, 57468.7)]
sampler = lightcurve_mcmc(lc_early, model, priors=priors,
                          p_lo=[20.0, 2.0, 20.0, 57468.5],
                          p_up=[50.0, 5.0, 50.0, 57468.7],
                          nwalkers=16 if FAST else 100,
                          nsteps=50 if FAST else 1000,
                          nsteps_burnin=50 if FAST else 1000,
                          save_plot_as=os.path.join(outdir, "chains.png"),
                          save_sampler_as=os.path.join(outdir, "flatchain.npy"),
                          seed=0)
print("posterior medians:", np.median(sampler.flatchain, axis=0))
print("acceptance:", sampler.acceptance_fraction.mean())
print("autocorr times:", sampler.get_autocorr_time())

# validity check (usage.rst:205-214)
p_mean = sampler.flatchain.mean(axis=0)
t_max = model.t_max(p_mean)
if np.asarray(lc_early["MJD"], float).max() > t_max:
    print("Warning: your model is not valid for all your observations")

fig, corner_axes, ax = lightcurve_corner(
    lc_early, model, sampler.flatchain,
    save_plot_as=os.path.join(outdir, "corner.png"))
plt.close("all")

# --------------------------------------------------------- bolometric pipeline
lc_bolo = lc.where(MJD_max=57500.0) if FAST else lc
t0 = calculate_bolometric(lc_bolo, outpath=os.path.join(outdir, "bolometric"),
                          res=1.0, nwalkers=10,
                          burnin_steps=20 if FAST else 200,
                          steps=20 if FAST else 100,
                          colors=["B-V", "g-r", "r-i"], batch_mode=True, seed=0,
                          save_table_as=os.path.join(outdir, "bolometric.txt"))
fig = plot_bolometric_results(t0, xcol="MJD",
                              save_plot_as=os.path.join(outdir, "bolometric.png"))
plt.close("all")
print(f"wrote results to {outdir}/")
