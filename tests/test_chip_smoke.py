"""chip_smoke.py's phases, run on the CPU at tiny sizes.

On the card every phase compares the GPU against the float64 CPU reference;
here both sides are the CPU, so these tests check the phases' control flow,
shapes and checks, not the card. The script itself must refuse to report a
result without a GPU.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {
    "likelihood": dict(n_draws=256, batch=64),
    "flagship": dict(nwalkers=16, nsteps=20, nsteps_burnin=40),
    "population": dict(S=4, nwalkers=8, nsteps=10, nsteps_burnin=5, S_exact=2),
    "bolometric": dict(nwalkers=4, burnin_steps=10, steps=10, mjd_max=57472.0),
    "four_cards": dict(n_cards=4, nwalkers=64, S=6, pop_nwalkers=8, nsteps=10,
                       nsteps_burnin=5),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_runs_and_passes_its_check_at_tiny_size(phase):
    out = getattr(chip_smoke, f"phase_{phase}")(**TINY[phase])
    assert isinstance(out, dict) and out


def test_device_phase_reports_the_platform():
    info = chip_smoke.phase_device()
    assert info["platform"] == "cpu" and info["count"] >= 1


def test_main_refuses_without_a_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert "FAIL: no GPU" in out


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins where it is set; otherwise the cache
    is <checkout>/.jax_cache. The script still exits non-zero on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import sys, jax, chip_smoke; rc = chip_smoke.main([]); "
            "print('CACHE=' + str(jax.config.jax_compilation_cache_dir)); sys.exit(rc)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout
    assert f"CACHE={want}" in r.stdout.splitlines(), r.stdout[-2000:]
    assert '"ok": true' not in r.stdout
