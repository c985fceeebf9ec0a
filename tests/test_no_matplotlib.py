"""Fits that draw nothing must never import matplotlib: the package's fit
path runs on machines that have only numpy, scipy and JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import sys
sys.modules["matplotlib"] = None          # any import of it now raises
import numpy as np
import lightcurve_fitting_tpu.lightcurve
import lightcurve_fitting_tpu.fitting as fitting
import lightcurve_fitting_tpu.bolometric
import lightcurve_fitting_tpu.parallel.population
from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior

filters = [filtdict[n] for n in ["g", "r", "i"]]
t = np.repeat(np.linspace(1.0, 8.0, 4), 3)
f = np.array(filters * 4)
y = np.asarray(ShockCooling2()(t, f, 12.0, 2.0, 35.0, 0.0))
lc = LC([t, f, y, 0.05 * y], names=["MJD", "filter", "lum", "dlum"])
s = fitting.lightcurve_mcmc(lc, ShockCooling2(lc),
                            priors=[UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0),
                                    UniformPrior(5.0, 100.0), UniformPrior(-1.0, 1.0)],
                            p_lo=[5.0, 0.5, 20.0, -0.5], p_up=[25.0, 5.0, 60.0, 0.5],
                            nwalkers=8, nsteps=5, nsteps_burnin=5, seed=0, quiet=True)
assert np.isfinite(s.flatchain).all()
assert not any(m.split(".")[0] == "matplotlib" for m, v in sys.modules.items() if v is not None)
print("FIT_OK")
"""


def test_fit_without_matplotlib():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CODE], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FIT_OK" in r.stdout
