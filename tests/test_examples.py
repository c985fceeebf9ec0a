"""Every example and the flagship notebook EXECUTE in CI (VERDICT r4 #3).

The reference's de facto regression suite is its example notebook
(SURVEY.md §4); here each `examples/*.py` script runs end-to-end in a
subprocess at smoke scale (`LCF_EXAMPLE_FAST=1` — sizes only; every API
call is the real one), and `fit_sn2016bkv.ipynb` is executed cell-by-cell
with jupyter. A stale example — an API it uses having drifted — fails the
suite instead of silently rotting.

The three broadest-coverage scripts run in the default suite (~1 min
total); the remaining three and the notebook (~3 min) are `slow`.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _env():
    env = dict(os.environ)
    env.update(LCF_EXAMPLE_FAST="1", JAX_PLATFORMS="cpu",
               MPLBACKEND="Agg", PYTHONPATH=REPO)
    return env


def _run_script(name, tmp_path, args=()):
    r = subprocess.run([sys.executable, os.path.join(EXAMPLES, name), *args],
                       env=_env(), cwd=tmp_path, timeout=600,
                       capture_output=True, text=True)
    assert r.returncode == 0, (f"{name} failed:\n--- stdout ---\n"
                               f"{r.stdout[-3000:]}\n--- stderr ---\n"
                               f"{r.stderr[-3000:]}")
    return r


def test_example_fit_sn2016bkv(tmp_path):
    r = _run_script("fit_sn2016bkv.py", tmp_path, args=[str(tmp_path / "out")])
    assert "posterior medians" in r.stdout
    for f in ["lightcurve.png", "chains.png", "corner.png", "flatchain.npy",
              "bolometric.txt", "bolometric.png"]:
        assert (tmp_path / "out" / f).exists(), f


def test_example_compare_models(tmp_path):
    r = _run_script("compare_models.py", tmp_path)
    assert "stacking_weight" in r.stdout or "elpd" in r.stdout
    assert (tmp_path / "stacked_models.png").exists()
    assert "leave-one-band-out" in r.stdout


def test_example_fit_map(tmp_path):
    r = _run_script("fit_map.py", tmp_path)
    assert "MAP" in r.stdout and "MCMC medians" in r.stdout


@pytest.mark.slow
def test_example_fit_hmc(tmp_path):
    r = _run_script("fit_hmc.py", tmp_path)
    assert "medians:" in r.stdout


@pytest.mark.slow
def test_example_fit_population(tmp_path):
    r = _run_script("fit_population.py", tmp_path)
    assert "transients in" in r.stdout


@pytest.mark.slow
def test_example_calibration_check(tmp_path):
    r = _run_script("calibration_check.py", tmp_path)
    assert (tmp_path / "sbc_ranks.png").exists()


@pytest.mark.slow
def test_notebook_executes(tmp_path):
    """The flagship notebook runs end-to-end at smoke scale. Its cells load
    data via '../lightcurve_fitting_tpu/...', so it executes in a sandbox
    laid out like the repo (symlinked package, notebook one level down)."""
    nbdir = tmp_path / "examples"
    nbdir.mkdir()
    os.symlink(os.path.join(REPO, "lightcurve_fitting_tpu"),
               str(tmp_path / "lightcurve_fitting_tpu"))
    shutil.copy(os.path.join(EXAMPLES, "fit_sn2016bkv.ipynb"),
                str(nbdir / "fit_sn2016bkv.ipynb"))
    r = subprocess.run(
        [sys.executable, "-m", "jupyter", "nbconvert", "--to", "notebook",
         "--execute", "--output", "executed.ipynb",
         "--ExecutePreprocessor.timeout=900", "fit_sn2016bkv.ipynb"],
        env=_env(), cwd=str(nbdir), timeout=1500,
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    import nbformat
    nb = nbformat.read(str(nbdir / "executed.ipynb"), as_version=4)
    errors = [o for c in nb.cells if c.cell_type == "code"
              for o in c.get("outputs", []) if o.get("output_type") == "error"]
    assert not errors, errors[0]
