"""lightcurve_fitting_tpu: a JAX/XLA framework for fitting analytical
supernova light-curve models, with the full capabilities of
griffin-h/lightcurve_fitting redesigned for accelerator execution.

Layout (mirrors the reference's layer map, SURVEY.md §1):
  lightcurve  — LC table, photometric conversions, plotting (host)
  filters     — filter registry, transmission curves, synthetic photometry
  models      — analytical model zoo + priors (pure jax kernels)
  fitting     — ensemble-MCMC fit driver, corner/model plots
  bolometric  — per-epoch blackbody SED fits -> bolometric light curves
  speccal     — spectra I/O and photometric calibration
  ops         — device building blocks (FilterBank quadrature, F99, splines)
  parallel    — stretch-move sampler, walker sharding, batched epoch fits
  utils       — host substrate (table, units, cosmology, time, FITS, corner)
"""

# git-derived (versioneer-style, reference setup.cfg parity): BASE+g<sha>
# from a checkout, the plain base from an installed distribution
from ._version import __version__  # noqa: E402,F401

import os as _os

if not _os.environ.get("LCF_NO_X64"):
    # absolute MJD epochs (~5.7e4 with posterior widths of ~0.01 d) need
    # float64 parameter arithmetic; the transcendental-heavy hot paths run in
    # float32 regardless (core/config.py). Set LCF_NO_X64=1 to opt out.
    import jax as _jax
    _jax.config.update("jax_enable_x64", True)

from . import filters  # noqa: F401
from . import models  # noqa: F401
from .lightcurve import LC  # noqa: F401

__all__ = ["LC", "filters", "models", "__version__"]
