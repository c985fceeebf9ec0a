"""Production fit CLI (`lcfit` / python -m lightcurve_fitting_tpu.fit_cli):
config-driven headless fits with JSON summaries — a serving surface the
reference (notebook-driven; only CLI is speccal) lacks."""

import json
import os

import numpy as np
import pytest

from lightcurve_fitting_tpu.fit_cli import main
from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2


@pytest.fixture(scope="module")
def synth_csv(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("cli")
    filters = ["g", "r", "i"]
    t = np.repeat(np.linspace(1.0, 8.0, 5), 3)
    f = np.array([filtdict[n] for n in filters] * 5)
    m = ShockCooling2()
    y = m(t, f, 12.0, 2.0, 35.0, 0.0)
    dy = 0.05 * y
    lc = LC([t, np.array(filters * 5), y + rng.normal(scale=dy), dy],
            names=["MJD", "filter", "lum", "dlum"])
    path = str(d / "synth.csv")
    lc.write(path, format="ascii.csv", overwrite=True)
    return path


def _run(tmp_path, cfg):
    cfg_path = str(tmp_path / "fit.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    assert main([cfg_path]) == 0
    with open(str(tmp_path / "summary.json")) as f:
        return json.load(f)


def test_cli_mcmc(tmp_path, synth_csv):
    cfg = {"data": synth_csv, "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100], ["Uniform", -0.5, 0.5]],
           "p_lo": [5, 0.5, 20, -0.4], "p_up": [25, 5, 60, 0.4],
           "driver": "mcmc",
           "driver_kwargs": {"nwalkers": 16, "nsteps": 150,
                             "nsteps_burnin": 150, "seed": 1, "quiet": True,
                             "shard": False},
           "outputs": {"flatchain": "chain.npy", "summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    assert summary["posterior"]["T_1"]["median"] == pytest.approx(12.0, rel=0.3)
    chain = np.load(str(tmp_path / "chain.npy"))
    assert chain.shape == (150 * 16, 4)
    assert 0.1 < summary["acceptance"] < 0.9
    gof = summary["goodness_of_fit"]
    assert gof["n_points"] == 15 and gof["dof"] == 11
    assert 0.0 <= gof["p_value"] <= 1.0 and gof["chi2"] > 0


def test_cli_evidence(tmp_path, synth_csv):
    cfg = {"data": synth_csv, "model": "ShockCooling2",
           "priors": [["Uniform", 8, 16], ["Uniform", 1, 3],
                      ["Uniform", 25, 45], ["Uniform", -0.5, 0.5]],
           "driver": "evidence",
           "driver_kwargs": {"nwalkers": 16, "n_rungs": 8, "nsteps": 100,
                             "nsteps_burnin": 100, "seed": 2, "quiet": True},
           "outputs": {"summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    assert np.isfinite(summary["log_z"])
    assert len(summary["rung_acceptance"]) == 9


def test_cli_errors(tmp_path, synth_csv):
    with pytest.raises(SystemExit):
        _run(tmp_path, {"data": synth_csv, "model": "NoSuchModel",
                        "priors": [], "driver": "mcmc"})
    with pytest.raises(SystemExit):
        _run(tmp_path, {"data": synth_csv, "model": "ShockCooling2",
                        "priors": [["Cauchy", 0, 1]] * 4, "driver": "mcmc"})
    with pytest.raises(SystemExit):
        _run(tmp_path, {"data": synth_csv, "model": "ShockCooling2",
                        "priors": [["Uniform", 0, 1]] * 4,
                        "driver": "quantum"})


def test_cli_population(tmp_path, synth_csv):
    # second transient with different truths
    rng = np.random.default_rng(3)
    t = np.repeat(np.linspace(1.0, 8.0, 4), 3)
    f = np.array([filtdict[n] for n in ["g", "r", "i"]] * 4)
    m = ShockCooling2()
    y = m(t, f, 16.0, 2.5, 45.0, 0.0)
    dy = 0.05 * y
    lc2 = LC([t, np.array(["g", "r", "i"] * 4), y + rng.normal(scale=dy), dy],
             names=["MJD", "filter", "lum", "dlum"])
    second = str(tmp_path / "synth2.csv")
    lc2.write(second, format="ascii.csv", overwrite=True)

    cfg = {"data": [synth_csv, second], "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100]],
           "p_lo": [5, 0.5, 20], "p_up": [25, 5, 60],
           "driver": "population",
           "per_file": {"synth2.csv": {"meta": {"redshift": 0.0}}},
           "driver_kwargs": {"nwalkers": 16, "nsteps": 150,
                             "nsteps_burnin": 60, "seed": 4, "init": "map"},
           "outputs": {"flatchains": "chains.npy", "summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    assert summary["n_transients"] == 2
    per = summary["transients"]
    assert per["synth.csv"]["T_1"]["median"] == pytest.approx(12.0, rel=0.3)
    assert per["synth2.csv"]["T_1"]["median"] == pytest.approx(16.0, rel=0.3)
    chains = np.load(str(tmp_path / "chains.npy"))
    assert chains.shape == (2, 150 * 16, 3)


def test_cli_population_summaries(tmp_path, synth_csv):
    """driver_kwargs summaries/return_chains pass through (regression: the
    CLI unpacked fit_population as a 2-tuple, so the documented
    summaries-only fast path crashed after the fit finished)."""
    cfg = {"data": [synth_csv], "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100]],
           "p_lo": [5, 0.5, 20], "p_up": [25, 5, 60],
           "driver": "population",
           "driver_kwargs": {"nwalkers": 16, "nsteps": 150,
                             "nsteps_burnin": 60, "seed": 4, "init": "map",
                             "summaries": True, "return_chains": False},
           "outputs": {"flatchains": "chains.npy", "summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    per = summary["transients"]["synth.csv"]
    assert per["T_1"]["median"] == pytest.approx(12.0, rel=0.3)
    assert per["T_1"]["minus"] > 0 and per["T_1"]["plus"] > 0
    # chains never reached the host: the flatchains output is skipped, not fatal
    assert not os.path.exists(str(tmp_path / "chains.npy"))


def test_cli_corner_use_sigma(tmp_path, synth_csv):
    """outputs.corner forwards use_sigma so the inset's model curves don't
    consume the sigma column as a physics parameter (regression)."""
    cfg = {"data": synth_csv, "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100], ["Uniform", -0.5, 0.5],
                      ["Uniform", 0, 5]],
           "p_lo": [5, 0.5, 20, -0.4, 0.1], "p_up": [25, 5, 60, 0.4, 2.0],
           "driver": "mcmc",
           "driver_kwargs": {"nwalkers": 16, "nsteps": 60,
                             "nsteps_burnin": 60, "seed": 1, "quiet": True,
                             "shard": False, "use_sigma": True},
           "outputs": {"corner": "corner.png", "summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    assert "corner_error" not in summary, summary.get("corner_error")
    assert os.path.exists(str(tmp_path / "corner.png"))
    assert "\\sigma" in summary["posterior"]


def test_cli_bolometric(tmp_path):
    data = os.path.join(os.path.dirname(__file__), "..",
                        "lightcurve_fitting_tpu", "data", "SN2016bkv.csv")
    cfg = {"data": os.path.abspath(data),
           "meta": {"dm": 30.79, "redshift": 0.002},
           "where": {"MJD_min": 57470.0, "MJD_max": 57473.0},
           "driver": "bolometric",
           "driver_kwargs": {"res": 1.0, "nwalkers": 10, "burnin_steps": 30,
                             "steps": 30},
           "outputs": {"table": "bolo.txt", "summary": "summary.json",
                       "outpath": "epochs"}}
    summary = _run(tmp_path, cfg)
    assert summary["n_epochs"] >= 2
    assert "temp_mcmc" in summary["columns"]
    assert os.path.exists(str(tmp_path / "bolo.txt"))


def test_cli_hmc_and_ptmcmc(tmp_path, synth_csv):
    base = {"data": synth_csv, "model": "ShockCooling2",
            "priors": [["Gaussian", 1, 50, 12, 5], ["Gaussian", 0.1, 20, 2, 1],
                       ["Gaussian", 5, 100, 35, 10], ["Gaussian", -0.5, 0.5, 0, 0.2]],
            "p_lo": [5, 0.5, 20, -0.4], "p_up": [25, 5, 60, 0.4],
            "outputs": {"summary": "summary.json"}}

    hmc = dict(base, driver="hmc",
               driver_kwargs={"nchains": 4, "nsamples": 40, "n_warmup": 60,
                              "warmup_walkers": 16, "warmup_steps": 60,
                              "max_depth": 6, "seed": 5, "quiet": True})
    summary = _run(tmp_path, hmc)
    assert summary["posterior"]["T_1"]["median"] == pytest.approx(12.0, rel=0.4)
    assert summary["acceptance"] > 0.3

    pt = dict(base, driver="ptmcmc",
              driver_kwargs={"nwalkers": 16, "n_rungs": 5, "nsteps": 100,
                             "nsteps_burnin": 100, "seed": 6, "quiet": True})
    summary = _run(tmp_path, pt)
    assert summary["posterior"]["T_1"]["median"] == pytest.approx(12.0, rel=0.4)
    assert np.isfinite(summary["log_z"])
    assert len(summary["swap_rate"]) == 6


def test_cli_checkpoint_resume(tmp_path, synth_csv):
    """Checkpoint/resume rides through driver_kwargs; checkpoint paths
    resolve relative to the config file; the resumed chain equals the
    uninterrupted run exactly."""
    base = {"data": synth_csv, "model": "ShockCooling2",
            "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                       ["Uniform", 5, 100], ["Uniform", -0.5, 0.5]],
            "p_lo": [5, 0.5, 20, -0.4], "p_up": [25, 5, 60, 0.4],
            "driver": "mcmc",
            "outputs": {"flatchain": "chain.npy", "summary": "summary.json"}}
    kw = {"nwalkers": 16, "nsteps": 60, "nsteps_burnin": 40, "seed": 1,
          "quiet": True, "shard": False}

    _run(tmp_path, dict(base, driver_kwargs=kw))
    ref = np.load(str(tmp_path / "chain.npy"))

    # truncated run saving checkpoints (relative path), then resume
    _run(tmp_path, dict(base, driver_kwargs=dict(
        kw, nsteps=20, checkpoint_every=20, checkpoint_file="fit_ck.npz")))
    assert os.path.exists(str(tmp_path / "fit_ck.npz"))
    _run(tmp_path, dict(base, driver_kwargs=dict(kw, resume_from="fit_ck.npz")))
    resumed = np.load(str(tmp_path / "chain.npy"))
    np.testing.assert_array_equal(resumed, ref)


def test_cli_compare(tmp_path, synth_csv):
    """driver "compare": Occam ranking between a narrow truth-containing
    prior volume and a vastly wider one on the same model (per-model priors
    given as a list of prior lists; shared init window)."""
    narrow = [["Uniform", 8, 16], ["Uniform", 1, 3],
              ["Uniform", 25, 45], ["Uniform", -0.5, 0.5]]
    wide = [["Uniform", 1, 400], ["Uniform", 0.1, 100],
            ["Uniform", 1, 1000], ["Uniform", -3, 3]]
    cfg = {"data": synth_csv, "models": ["ShockCooling2", "ShockCooling2"],
           "labels": ["wide", "narrow"],
           "priors": [wide, narrow],
           "p_lo": [8, 1, 25, -0.5], "p_up": [16, 3, 45, 0.5],
           "driver": "compare",
           "driver_kwargs": {"nwalkers": 16, "n_rungs": 6, "nsteps": 60,
                             "nsteps_burnin": 60, "seed": 3, "quiet": True},
           "outputs": {"summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    ranking = summary["ranking"]
    assert [r["model"] for r in ranking] == ["narrow", "wide"]
    assert ranking[0]["delta_log_z"] == 0.0
    assert ranking[1]["delta_log_z"] < -3.0

    # missing "models" key is a clean config error
    bad = dict(cfg)
    del bad["models"]
    with pytest.raises(SystemExit, match="models"):
        _run(tmp_path, bad)


def test_cli_sbc(tmp_path):
    """driver "sbc": no data key — simulate, fit, and report per-parameter
    rank-uniformity; summary, ranks and plot written."""
    import matplotlib
    matplotlib.use("Agg")
    summary = _run(tmp_path, {
        "driver": "sbc",
        "model": "ShockCooling2",
        "priors": [["Uniform", 8.0, 20.0], ["Uniform", 1.0, 4.0],
                   ["Uniform", 25.0, 50.0]],
        "times": [1.0, 2.75, 4.5, 6.25, 8.0],
        "filters": ["g", "r", "i"],
        "driver_kwargs": {"n_sims": 16, "n_ranks": 31, "nwalkers": 16,
                          "nsteps": 40, "nsteps_burnin": 40, "seed": 0,
                          "quiet": True, "init": "window"},
        "outputs": {"summary": "summary.json", "ranks": "ranks.npy",
                    "plot": "sbc.png"},
    })
    assert summary["driver"] == "sbc"
    assert summary["n_sims"] == 16 and summary["n_ranks"] == 31
    assert set(summary["p_values"]) == {"T_1", "L_1", "t_\\mathrm{tr}"}
    assert all(0.0 <= p <= 1.0 for p in summary["p_values"].values())
    ranks = np.load(str(tmp_path / "ranks.npy"))
    assert ranks.shape == (16, 3)
    assert os.path.exists(str(tmp_path / "sbc.png"))

    # missing times/filters is a config error
    cfg_path = str(tmp_path / "bad.json")
    with open(cfg_path, "w") as f:
        json.dump({"driver": "sbc", "model": "ShockCooling2",
                   "priors": [["Uniform", 0, 1]]}, f)
    with pytest.raises(SystemExit, match="times"):
        main([cfg_path])


def test_cli_compare_loo(tmp_path, synth_csv):
    """driver "compare" with method "loo": chain-based PSIS-LOO ranking —
    the truth-compatible prior beats one pinning t_tr far too low."""
    good = [["Uniform", 1, 50], ["Uniform", 0.1, 20],
            ["Uniform", 5, 100], ["Uniform", -1, 1]]
    pinned = [["Uniform", 1, 50], ["Uniform", 0.1, 20],
              ["Uniform", 1, 3], ["Uniform", -1, 1]]
    summary = _run(tmp_path, {
        "data": synth_csv, "models": ["ShockCooling2", "ShockCooling2"],
        "labels": ["free", "pinned"], "method": "loo",
        "priors": [good, pinned],
        "p_lo": [[10, 1.5, 20, -0.3], [10, 1.5, 1.2, -0.3]],
        "p_up": [[14, 2.5, 50, 0.3], [14, 2.5, 2.8, 0.3]],
        "driver": "compare",
        "driver_kwargs": {"nwalkers": 32, "nsteps": 300,
                          "nsteps_burnin": 300, "seed": 6, "quiet": True},
        "outputs": {"summary": "summary.json", "stacked_plot": "stacked.png"}})
    assert summary["method"] == "loo"
    ranking = summary["ranking"]
    assert [r["model"] for r in ranking] == ["free", "pinned"]
    assert ranking[0]["d_elpd"] == 0.0
    assert ranking[1]["d_elpd"] < 0.0
    # stacking weights ride the summary; the model-averaged overlay is saved
    assert ranking[0]["stacking_weight"] > 0.9
    assert sum(r["stacking_weight"] for r in ranking) == pytest.approx(1.0)
    assert os.path.getsize(str(tmp_path / "stacked.png")) > 10000


def test_cli_compile_cache(tmp_path, synth_csv):
    """--compile-cache persists compiled executables across lcfit runs
    (core.config.enable_compilation_cache); the cache dir must be populated
    after a fit."""
    import jax
    cache_dir = str(tmp_path / "xla-cache")
    cfg = {"data": synth_csv, "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100], ["Uniform", -0.5, 0.5]],
           "p_lo": [5, 0.5, 20, -0.4], "p_up": [25, 5, 60, 0.4],
           "driver": "mcmc",
           "driver_kwargs": {"nwalkers": 16, "nsteps": 20,
                             "nsteps_burnin": 20, "seed": 1, "quiet": True,
                             "shard": False},
           "outputs": {"summary": "summary.json"}}
    cfg_path = str(tmp_path / "fit.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        # the flag must wire the cache directory into jax and run the fit
        assert main([cfg_path, "--compile-cache", cache_dir]) == 0
        assert jax.config.jax_compilation_cache_dir == cache_dir
        # executables persist once the threshold admits them (deterministic
        # check with threshold 0 on a kernel not yet compiled this process)
        from lightcurve_fitting_tpu.core.config import enable_compilation_cache
        assert enable_compilation_cache(cache_dir, min_compile_time_secs=0.0) \
            == cache_dir
        import jax.numpy as jnp

        @jax.jit
        def probe(x):
            return jnp.sin(x * 3.14159) @ x

        probe(jnp.ones((16, 16))).block_until_ready()
        assert len(os.listdir(cache_dir)) > 0, "no executables persisted"
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
        try:  # rebind the lazy cache object to the restored directory
            from jax.experimental.compilation_cache import compilation_cache
            compilation_cache.reset_cache()
        except Exception:
            pass


def test_cli_ic_group_by_and_refit(tmp_path, synth_csv):
    """Config keys ic_group_by / ic_refit: the summary carries the LOGO block
    and, with refit forced (threshold -inf), marks every band refit-backed."""
    cfg = {"data": synth_csv, "model": "ShockCooling2",
           "priors": [["Uniform", 1, 50], ["Uniform", 0.1, 20],
                      ["Uniform", 5, 100], ["Uniform", -0.5, 0.5]],
           "p_lo": [5, 0.5, 20, -0.4], "p_up": [25, 5, 60, 0.4],
           "driver": "mcmc",
           "ic_group_by": "filter",
           "ic_refit": -1e30,
           "ic_refit_options": {"nwalkers": 16, "nsteps": 100,
                                "nsteps_burnin": 100},
           "driver_kwargs": {"nwalkers": 16, "nsteps": 150,
                             "nsteps_burnin": 150, "seed": 1, "quiet": True,
                             "shard": False},
           "outputs": {"summary": "summary.json"}}
    summary = _run(tmp_path, cfg)
    ic = summary["information_criteria"]
    assert "error" not in ic, ic
    lg = ic["logo"]
    assert lg["groups"] == ["g", "r", "i"]
    assert set(lg["refit_backed"]) == {"g", "r", "i"}
    assert len(ic["refit_backed_points"]) == 15
    assert np.isfinite(lg["elpd_logo"])
