"""Population fitting: many transients in one device call, with and without a
transient-sharded mesh."""

import numpy as np
import pytest

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior, planck_fast
from lightcurve_fitting_tpu.parallel.population import fit_population
from lightcurve_fitting_tpu.parallel.mesh import walker_mesh


def make_synth_lc(seed, T1, L1, ttr, t0):
    """Synthetic ShockCooling2 photometry with noise."""
    rng = np.random.default_rng(seed)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    n_epochs = 3 + seed % 3  # ragged sizes across transients
    t = np.repeat(t0 + np.linspace(1.0, 8.0, n_epochs), len(filters))
    f = np.array(filters * n_epochs)
    m = ShockCooling2()
    y_true = m(t, f, T1, L1, ttr, t0)
    dy = 0.05 * y_true
    y = y_true + rng.normal(scale=dy)
    lc = LC([t, f, y, dy], names=["MJD", "filter", "lum", "dlum"])
    return lc


TRUTHS = [(12.0, 2.0, 35.0, 57000.0), (18.0, 3.0, 45.0, 57100.0),
          (9.0, 1.5, 30.0, 57200.0), (15.0, 2.5, 40.0, 57300.0),
          (11.0, 2.2, 38.0, 57400.0), (14.0, 1.8, 33.0, 57500.0),
          (16.0, 2.8, 42.0, 57600.0), (10.0, 2.1, 36.0, 57700.0)]


@pytest.fixture(scope="module")
def population():
    lcs = [make_synth_lc(i, *truth) for i, truth in enumerate(TRUTHS)]
    models = [ShockCooling2(lc) for lc in lcs]
    priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0), UniformPrior(5.0, 100.0)]
    return lcs, models, priors


def _check_recovery(flat, acc):
    assert flat.shape[0] == len(TRUTHS)
    assert np.all(acc > 0.1)
    for s, (T1, L1, ttr, t0) in enumerate(TRUTHS):
        med = np.median(flat[s], axis=0)
        assert med[0] == pytest.approx(T1, rel=0.2), s
        assert med[1] == pytest.approx(L1, rel=0.3), s


def test_fit_population_single_device(population):
    lcs, models, priors = population
    # t0 fixed: fit (T1, L1, ttr) with t_exp baked as 0-offset times
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    flat, acc = fit_population(models, lcs2, priors,
                               p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                               nwalkers=16, nsteps=300, nsteps_burnin=300, seed=1)
    _check_recovery(flat, acc)


def test_fit_population_sharded_matches(population):
    lcs, models, priors = population
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    mesh = walker_mesh(8, axis_name="transients")
    flat, acc = fit_population(models, lcs2, priors,
                               p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                               nwalkers=16, nsteps=300, nsteps_burnin=300, seed=1,
                               mesh=mesh)
    _check_recovery(flat, acc)


def test_fit_population_heterogeneous_table_degrees():
    """Transients whose filter sets land in different adaptive Chebyshev
    degree classes (griz-only -> deg 24; with the broadband unfiltered '0'
    -> deg 40) must still pack into one population: bb_coeffs rows pad with
    trailing zeros (exact no-ops in Clenshaw)."""
    truths = [(12.0, 2.0, 35.0, 0.0), (15.0, 2.5, 40.0, 0.0)]
    rng = np.random.default_rng(0)
    lcs = []
    for i, (T1, L1, ttr, t0) in enumerate(truths):
        names = ["g", "r", "i"] if i == 0 else ["g", "r", "i", "0"]
        filters = [filtdict[n] for n in names]
        t = np.repeat(t0 + np.linspace(1.0, 8.0, 4), len(filters))
        f = np.array(filters * 4)
        m = ShockCooling2()
        y_true = m(t, f, T1, L1, ttr, t0)
        dy = 0.05 * y_true
        lcs.append(LC([t, f, y_true + rng.normal(scale=dy), dy],
                      names=["MJD", "filter", "lum", "dlum"]))
    models = [ShockCooling2(lc) for lc in lcs]
    priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0), UniformPrior(5.0, 100.0)]
    flat, acc = fit_population(models, lcs, priors,
                               p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                               nwalkers=16, nsteps=200, nsteps_burnin=200, seed=2)
    for s, (T1, L1, ttr, t0) in enumerate(truths):
        med = np.median(flat[s], axis=0)
        assert med[0] == pytest.approx(T1, rel=0.3), s
        assert med[1] == pytest.approx(L1, rel=0.3), s


def test_fit_population_map_seeded_short_burnin(population):
    """init="map": a batched multi-start MAP stage seeds every transient's
    walkers inside its typical set, so a 60-step burn-in recovers all truths
    (wide starts need several hundred steps on these posteriors)."""
    lcs, models, priors = population
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    flat, acc = fit_population(models, lcs2, priors,
                               p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
                               nwalkers=16, nsteps=150, nsteps_burnin=60,
                               seed=3, init="map")
    _check_recovery(flat, acc)


def test_population_f32_phase_with_mjd_scale_ragged_times():
    """Raw-MJD population fits under the f32 hot path: hot_phase centers on
    floor(min t) per transient, and pack_population must pad times with the
    last REAL time (zero padding would drag the center to 0 and quantize
    5.7e4-day phases to f32 ulp ~11 minutes). Forces compute dtype f32 on CPU
    to exercise the accelerator code path."""
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.core import config

    rng = np.random.default_rng(7)
    truths = [(12.0, 2.0, 35.0), (15.0, 2.5, 40.0), (10.0, 1.8, 30.0)]
    lcs, models = [], []
    filters = [filtdict[n] for n in ["g", "r", "i"]]
    for s, (T1, L1, ttr) in enumerate(truths):
        n_ep = 4 + s  # ragged -> padding exercised
        t0 = 58000.0 + 50.0 * s
        t = np.repeat(t0 + np.linspace(1.0, 8.0, n_ep), len(filters))
        f = np.array(filters * n_ep)
        m = ShockCooling2()
        y = m(t, f, T1, L1, ttr, t0)
        dy = 0.05 * y
        lc = LC([t, f, y + rng.normal(scale=dy), dy],
                names=["MJD", "filter", "lum", "dlum"])
        # model with t_exp fixed at the known epoch via shifted times? no:
        # fit (T1, L1, ttr) with times left at raw MJD and t_exp baked
        lc["MJD"] = np.asarray(lc["MJD"], float) - t0 + 58000.0
        lcs.append(lc)
        models.append(ShockCooling2(lc))
    priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0),
              UniformPrior(5.0, 100.0), UniformPrior(57999.0, 58000.5)]

    # sharp precision check: the padded row's f32-centered phase must match
    # f64 to ~0.1 s (zero-padded times would drag t_ref to 0 and quantize
    # MJD-scale phases to f32 ulp ~0.004 d = 5.6 min)
    from lightcurve_fitting_tpu.parallel.population import pack_population
    from lightcurve_fitting_tpu.ops.mathx import hot_phase
    packed = pack_population(models, lcs)
    t_row = np.asarray(packed["t"])[0]          # ragged -> padded row
    config.set_compute_dtype(jnp.float32)
    try:
        ph32 = np.asarray(hot_phase(jnp.asarray(t_row), 58000.123), float)
    finally:
        config.set_compute_dtype(None)
    ph64 = t_row - 58000.123
    assert np.max(np.abs(ph32 - ph64)) < 2e-5   # days; ~2 s

    config.set_compute_dtype(jnp.float32)
    try:
        flat, acc = fit_population(models, lcs, priors,
                                   p_lo=[5.0, 0.5, 20.0, 57999.5],
                                   p_up=[25.0, 5.0, 60.0, 58000.4],
                                   nwalkers=16, nsteps=200, nsteps_burnin=200,
                                   seed=5)
    finally:
        config.set_compute_dtype(None)
    for s, (T1, L1, ttr) in enumerate(truths):
        med = np.median(flat[s], axis=0)
        assert med[0] == pytest.approx(T1, rel=0.3), (s, med)
        assert med[3] == pytest.approx(58000.0, abs=0.3), (s, med)


def test_compiled_cache_keys_distinguish_physics_and_kde_samples():
    """The compiled-kernel caches key on the model's baked-in physics and on
    KDEPrior sample content — not just class names (a second same-shape
    fit_population call with n=3.0 or different KDE samples must NOT reuse
    the n=1.5 executable)."""
    from lightcurve_fitting_tpu.models import ShockCooling, KDEPrior
    from lightcurve_fitting_tpu.parallel.population import (
        _model_fingerprint, _prior_fingerprint)

    m15 = ShockCooling(n=1.5)
    m30 = ShockCooling(n=3.0)
    assert _model_fingerprint(m15) != _model_fingerprint(m30)
    assert _model_fingerprint(m15) == _model_fingerprint(ShockCooling(n=1.5))

    k1 = KDEPrior(np.array([1.0, 2.0, 3.0]), 0.0, 10.0)
    k2 = KDEPrior(np.array([4.0, 5.0, 6.0]), 0.0, 10.0)
    assert _prior_fingerprint(k1) != _prior_fingerprint(k2)
    assert _prior_fingerprint(k1) == _prior_fingerprint(
        KDEPrior(np.array([1.0, 2.0, 3.0]), 0.0, 10.0))
    u1, u2 = UniformPrior(0.0, 1.0), UniformPrior(0.0, 2.0)
    assert _prior_fingerprint(u1) != _prior_fingerprint(u2)


def test_fit_population_f32_rescaled_state_matches_f64(population):
    """state_dtype=np.float32 (the accelerator default) runs the population
    walker state over the rescaled shared window; posteriors match the f64
    run statistically and chains come back absolute."""
    lcs, models, priors = population
    lcs2, models2 = [], []
    for lc in lcs:
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - lc2["MJD"].min() + 1.0
        lcs2.append(lc2)
        models2.append(type(models[0])(lc2))
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=150, nsteps_burnin=150, seed=3)
    f64, acc64 = fit_population(models2, lcs2, priors[:3], state_dtype=np.float64, **kw)
    f32, acc32 = fit_population(models2, lcs2, priors[:3], state_dtype=np.float32, **kw)
    assert f32.dtype == np.float64  # absolute values, mapped back
    assert np.all(acc32 > 0.1)
    for s in range(len(lcs2)):
        m64 = np.median(f64[s], axis=0)
        m32 = np.median(f32[s], axis=0)
        sig = f64[s].std(axis=0)
        assert np.all(np.abs(m64 - m32) < 3.0 * sig + 0.05 * np.abs(m64)), (s, m64, m32)


def test_fit_population_kill_and_resume_exact(population, tmp_path):
    """Population fits checkpoint/resume exactly like every other driver
    (index-folded per-step keys from per-transient base keys)."""
    lcs, models, priors = population
    lcs2, models2 = [], []
    for lc in lcs:
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - lc2["MJD"].min() + 1.0
        lcs2.append(lc2)
        models2.append(type(models[0])(lc2))
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=60, nsteps_burnin=45, seed=7)
    ref, ref_acc = fit_population(models2, lcs2, priors[:3], **kw)

    ck = str(tmp_path / "pop.ckpt")
    # truncated run 'killed' mid-production (25 of 60 production steps)
    fit_population(models2, lcs2, priors[:3], checkpoint_every=25,
                   checkpoint_file=ck, **dict(kw, nsteps=25))
    flat, acc = fit_population(models2, lcs2, priors[:3], resume_from=ck, **kw)
    np.testing.assert_array_equal(flat, ref)
    np.testing.assert_allclose(acc, ref_acc)
    with pytest.raises(ValueError, match="seed"):
        fit_population(models2, lcs2, priors[:3], resume_from=ck,
                       **dict(kw, seed=8))


def test_fit_population_non_divisible_mesh_pads(population):
    """Transient counts that don't divide the mesh are padded internally
    (repeat-last) and the padded chains sliced away; for window init the
    first-S chains are bitwise identical to the unsharded run (numpy uniform
    and jr.split both fill prefixes identically)."""
    lcs, models, priors = population
    lcs3, models3 = [], []
    for lc, truth in zip(lcs[:3], TRUTHS[:3]):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs3.append(LC(lc2))
    models3 = [ShockCooling2(lc) for lc in lcs3]
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=150, nsteps_burnin=150, seed=4)
    flat1, acc1 = fit_population(models3, lcs3, priors, **kw)
    flat8, acc8 = fit_population(models3, lcs3, priors,
                                 mesh=walker_mesh(8, axis_name="transients"),
                                 **kw)
    assert flat8.shape == flat1.shape == (3, 150 * 16, 3)
    np.testing.assert_array_equal(flat8, flat1)
    np.testing.assert_array_equal(acc8, acc1)


def test_fit_population_device_summaries(population):
    """summaries=True returns (S, ndim, 3) per-parameter percentiles computed
    on device in un-checkpointed runs; they must match host percentiles of
    the returned chains, and return_chains=False must reproduce them while
    eliding the chain transfer (identical acceptance)."""
    lcs, models, priors = population
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=80, nsteps_burnin=60, seed=3)
    flat, acc, summ = fit_population(models, lcs2, priors, summaries=True, **kw)
    assert summ.shape == (len(TRUTHS), 3, 3)
    host = np.moveaxis(np.percentile(flat, [16.0, 50.0, 84.0], axis=1), 0, -1)
    np.testing.assert_allclose(summ, host, rtol=1e-9, atol=1e-12)
    # percentile ordering and physicality
    assert np.all(summ[..., 0] <= summ[..., 1]) and np.all(summ[..., 1] <= summ[..., 2])

    flat2, acc2, summ2 = fit_population(models, lcs2, priors, summaries=True,
                                        return_chains=False, **kw)
    assert flat2 is None
    np.testing.assert_array_equal(summ2, summ)
    np.testing.assert_allclose(acc2, acc)

    with pytest.raises(ValueError, match="summaries"):
        fit_population(models, lcs2, priors, return_chains=False, **kw)


def test_fit_population_f32_state_summaries_use_bisection_path(population):
    """With the accelerator-default float32 rescaled state, the device
    summaries are float32 percentiles of the q-space chains. They must
    still match host float64 percentiles of the returned absolute chains —
    the affine q->absolute map commutes with linear percentile
    interpolation."""
    lcs, models, priors = population
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=80, nsteps_burnin=60, seed=3,
              state_dtype=np.float32)
    flat, acc, summ = fit_population(models, lcs2, priors, summaries=True, **kw)
    host = np.moveaxis(np.percentile(flat, [16.0, 50.0, 84.0], axis=1), 0, -1)
    # q-space f32 order stats map to absolute f64 exactly; only the f64
    # affine/interpolation arithmetic differs between the two sides
    np.testing.assert_allclose(summ, host, rtol=1e-6, atol=1e-9)
    assert np.all(summ[..., 0] <= summ[..., 1]) and np.all(summ[..., 1] <= summ[..., 2])


def test_fit_population_summaries_checkpointed_path(population, tmp_path):
    """Checkpointed runs compute the same summaries host-side (the chains
    already crossed to the host for the checkpoint)."""
    lcs, models, priors = population
    lcs2 = []
    for lc, truth in zip(lcs, TRUTHS):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lcs2.append(LC(lc2))
    kw = dict(p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
              nwalkers=16, nsteps=50, nsteps_burnin=40, seed=5)
    _, _, summ_fast = fit_population(models, lcs2, priors, summaries=True, **kw)
    ck = str(tmp_path / "pop_summ.ckpt")
    _, _, summ_ck = fit_population(models, lcs2, priors, summaries=True,
                                   checkpoint_every=20, checkpoint_file=ck, **kw)
    np.testing.assert_allclose(summ_ck, summ_fast, rtol=1e-9, atol=1e-12)


def test_population_goodness_of_fit_matches_single(population):
    """One padded device call for the whole population must reproduce the
    single-LC goodness_of_fit per transient (ragged lengths masked, not
    truncated), flag a deliberately broken transient, and honor the sigma
    variance model."""
    from lightcurve_fitting_tpu.fitting import goodness_of_fit
    from lightcurve_fitting_tpu.parallel.population import (
        population_goodness_of_fit)

    lcs, models, priors = population
    lcs2, models2 = [], []
    for lc, truth in zip(lcs[:4], TRUTHS[:4]):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lc2 = LC(lc2)
        lcs2.append(lc2)
        models2.append(ShockCooling2(lc2))
    # synthetic "posteriors": truth + small jitter; one transient corrupted
    rng = np.random.default_rng(0)
    M = 64
    flat = np.stack([np.asarray(truth[:3]) + 0.01 * rng.normal(size=(M, 3))
                     for truth in TRUTHS[:4]])
    flat[2] = flat[2] + np.array([8.0, 3.0, 30.0])      # badly wrong params

    pop = population_goodness_of_fit(models2, lcs2, flat, n_draws=M,
                                     seed=0, quiet=True)
    assert pop["chi2"].shape == (4,)
    for s in range(4):
        single = goodness_of_fit(lcs2[s], models2[s], flat[s], n_draws=M,
                                 seed=0, quiet=True)
        assert pop["n_points"][s] == single["n_points"]
        assert pop["dof"][s] == single["dof"]
        assert pop["chi2"][s] == pytest.approx(single["chi2"], rel=1e-4)
        assert pop["p_value"][s] == pytest.approx(single["p_value"],
                                                  abs=1e-6)
    # the corrupted transient is flagged, the honest ones are plausible
    assert pop["p_value"][2] < 1e-6
    assert pop["chi2_nu"][2] > 5 * np.nanmax(np.delete(pop["chi2_nu"], 2))

    # intrinsic-scatter variance model: parity with the single-LC
    # diagnostic for both sigma_type conventions (the masked nanmedian of
    # the 'absolute' path must ignore pad rows)
    flat_sig = np.concatenate(
        [flat, np.full((4, M, 1), 0.7)], axis=2)
    for stype in ("relative", "absolute"):
        pop_s = population_goodness_of_fit(models2, lcs2, flat_sig,
                                           use_sigma=True, sigma_type=stype,
                                           n_draws=M, seed=0, quiet=True)
        for s in range(4):
            single_s = goodness_of_fit(lcs2[s], models2[s], flat_sig[s],
                                       use_sigma=True, sigma_type=stype,
                                       n_draws=M, seed=0, quiet=True)
            assert pop_s["chi2"][s] == pytest.approx(single_s["chi2"],
                                                     rel=1e-4), stype
            assert pop_s["dof"][s] == single_s["dof"]


def test_population_information_criteria_matches_single(population):
    """Per-transient WAIC/PSIS-LOO from one padded device call must match
    the single-LC information_criteria on each transient's real points."""
    from lightcurve_fitting_tpu.fitting import information_criteria
    from lightcurve_fitting_tpu.parallel import (
        population_information_criteria)

    lcs, models, priors = population
    lcs2, models2 = [], []
    for lc, truth in zip(lcs[:3], TRUTHS[:3]):
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        lc2 = LC(lc2)
        lcs2.append(lc2)
        models2.append(ShockCooling2(lc2))
    rng = np.random.default_rng(1)
    M = 96
    flat = np.stack([np.asarray(truth[:3]) + 0.02 * rng.normal(size=(M, 3))
                     for truth in TRUTHS[:3]])

    pop = population_information_criteria(models2, lcs2, flat, n_draws=M,
                                          seed=0, quiet=True)
    assert pop["elpd_loo"].shape == (3,)
    for s in range(3):
        single = information_criteria(lcs2[s], models2[s], flat[s],
                                      n_draws=M, seed=0, quiet=True)
        assert pop["n_points"][s] == single["n_points"]
        assert pop["elpd_loo"][s] == pytest.approx(single["elpd_loo"],
                                                   rel=1e-4), s
        assert pop["elpd_waic"][s] == pytest.approx(single["elpd_waic"],
                                                    rel=1e-4)
        assert pop["p_loo"][s] == pytest.approx(single["p_loo"], rel=1e-3,
                                                abs=1e-6)
        np.testing.assert_allclose(pop["pointwise"][s], single["pointwise"],
                                   rtol=1e-4)


def test_population_compare_elpd():
    """Survey-level comparison: per-transient paired rankings + stacking
    weights from synthetic pointwise matrices with known structure."""
    from lightcurve_fitting_tpu.parallel.population import population_compare_elpd

    rng = np.random.default_rng(0)
    # family A wins transients 0 and 1, family B wins transient 2
    base = [rng.normal(-2.0, 0.3, 12) for _ in range(3)]
    ic_a = {"pointwise": [base[0], base[1], base[2] - 2.0]}
    ic_b = {"pointwise": [base[0] - 2.0, base[1] - 2.0, base[2]]}
    out = population_compare_elpd([ic_a, ic_b], ["A", "B"], quiet=True)
    assert list(out["best"]) == [0, 0, 1]
    assert list(out["n_best"]) == [2, 1]
    assert out["elpd_loo"].shape == (2, 3)
    # per-transient: the winner has d_elpd 0 and ~all stacking weight
    assert out["d_elpd"][0, 0] == 0.0 and out["d_elpd"][1, 0] < -20.0
    assert out["stacking_weight"][0, 0] > 0.99
    assert out["stacking_weight"][1, 2] > 0.99
    assert np.allclose(out["stacking_weight"].sum(axis=0), 1.0)
    # survey totals: A wins overall (2 transients to 1), paired SE is tight
    assert out["total_elpd"][0] > out["total_elpd"][1]
    assert out["total_d_elpd"][0] == 0.0 and out["total_se_d_elpd"][1] > 0.0

    with pytest.raises(ValueError):
        population_compare_elpd([ic_a], ["A", "B"], quiet=True)
    with pytest.raises(ValueError):
        population_compare_elpd([ic_a, {"pointwise": [base[0]]}], ["A", "B"],
                                quiet=True)


def test_pack_population_shipment_cache(population):
    """Repeat packs of identical data reuse the device buffers (no second
    device_put of the stacked payload); any content change re-ships; callers
    can add keys to the returned dicts without corrupting the cache."""
    from lightcurve_fitting_tpu.parallel.population import pack_population

    lcs, models, _ = population
    a = pack_population(models, lcs)
    b = pack_population(models, lcs)
    # same device buffers on a content hit (shallow copies of the entry)
    assert b["t"] is a["t"] and b["quad"]["bb_coeffs"] is a["quad"]["bb_coeffs"]
    assert b is not a and b["quad"] is not a["quad"]
    b["extra"] = 1
    b["quad"]["extra"] = 1
    c = pack_population(models, lcs)
    assert "extra" not in c and "extra" not in c["quad"]

    # content change -> miss (fresh buffers, correct values)
    lcs2 = [lc.copy() for lc in lcs]
    lcs2[0]["lum"] = np.asarray(lcs2[0]["lum"], float) * 1.5
    models2 = [m.clone_for(lc) for m, lc in zip(models, lcs2)]
    d = pack_population(models2, lcs2)
    assert d["y"] is not a["y"]
    np.testing.assert_allclose(np.asarray(d["y"][0]),
                               1.5 * np.asarray(a["y"][0]))
    np.testing.assert_allclose(np.asarray(d["y"][1]), np.asarray(a["y"][1]))
