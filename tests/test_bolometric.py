"""Bolometric pipeline: estimator unit checks and an end-to-end run over a few
epochs of SN 2016bkv."""

import os

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pytest

from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu import bolometric as bol
from lightcurve_fitting_tpu.core.constants import sigma_sb

EXAMPLE = os.path.join(os.path.dirname(__file__), "..",
                       "lightcurve_fitting_tpu", "data", "SN2016bkv.csv")


def load_lc():
    lc = LC.read(EXAMPLE)
    lc.meta["dm"] = 30.79
    lc.meta["extinction"] = {
        "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
        "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020,
    }
    lc.meta["redshift"] = 0.002
    return lc


def test_stefan_boltzmann():
    lum = bol.stefan_boltzmann(10.0, 5.0)
    assert lum == pytest.approx(4 * np.pi * 25.0 * sigma_sb * 1e4)
    lum2, dlum = bol.stefan_boltzmann(10.0, 5.0, 1.0, 0.5, 0.0)
    assert lum2 == lum and dlum > 0


def test_median_and_unc():
    x = np.random.default_rng(0).normal(10.0, 2.0, size=20000)
    med, lo, hi = bol.median_and_unc(x)
    assert med == pytest.approx(10.0, abs=0.1)
    assert lo == pytest.approx(2.0, abs=0.15)
    assert hi == pytest.approx(2.0, abs=0.15)


def test_pseudo_converges_to_full_bolometric():
    """The U-to-I pseudobolometric integral must be less than the full
    Stefan-Boltzmann luminosity but the same order of magnitude at ~8 kK."""
    L_pseudo = bol.pseudo(8.0, 10.0, 0.0)
    L_full = bol.stefan_boltzmann(8.0, 10.0)
    assert 0.1 * L_full < L_pseudo < L_full


def test_group_by_epoch():
    lc = load_lc()
    groups = bol.group_by_epoch(lc, res=1.0)
    assert sum(len(g) for g in groups) == len(lc)
    mjds = [np.median(np.asarray(g["MJD"], float)) for g in groups]
    assert mjds == sorted(mjds)
    # manual epoch column wins
    lc2 = load_lc()
    lc2["epoch"] = np.arange(len(lc2)) % 3
    groups2 = bol.group_by_epoch(lc2, res=1.0)
    assert len(groups2) == 3


def test_blackbody_lstsq_recovers_truth():
    """Synthetic SED from a known blackbody -> curve_fit recovers T, R."""
    from lightcurve_fitting_tpu.models import planck_fast
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    T_true, R_true = 12.0, 8.0
    freq = np.array([f.freq_eff.value for f in filters])
    lum = planck_fast(freq, T_true, R_true)
    epoch = LC([np.full(6, 57500.0), filters, freq, lum, 0.01 * lum],
               names=["MJD", "filter", "freq", "lum", "dlum"])
    temp, radius, dtemp, drad, L_bol, dL_bol, L_opt = bol.blackbody_lstsq(epoch, 0.0)
    # band-averaged vs monochromatic fluxes differ slightly; few-% recovery
    assert temp == pytest.approx(T_true, rel=0.05)
    assert radius == pytest.approx(R_true, rel=0.05)
    assert L_bol == pytest.approx(bol.stefan_boltzmann(temp, radius), rel=1e-6)


def test_integrate_sed():
    filters = [filtdict[n] for n in ["B", "V", "r"]]
    freq = np.array([f.freq_eff.value for f in filters])
    dfreq = np.array([f.dfreq.value for f in filters])
    lum = np.array([1.0, 2.0, 1.5]) * 1e15
    epoch = LC([np.full(3, 57500.0), filters, freq, dfreq, lum],
               names=["MJD", "filter", "freq", "dfreq", "lum"])
    L = bol.integrate_sed(epoch)
    order = np.argsort(freq)
    f_s, df_s, l_s = freq[order], dfreq[order], lum[order]
    fr = np.concatenate([[f_s[0] - df_s[0]], f_s, [f_s[-1] + df_s[-1]]])
    lm = np.concatenate([[0], l_s, [0]])
    assert L == pytest.approx(np.trapezoid(lm, fr) * 1e12)


@pytest.mark.parametrize("use_sigma", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_spectrum_mcmc_recovers_blackbody(use_sigma, tmp_path):
    from lightcurve_fitting_tpu.models import planck_fast, UniformPrior, LogUniformPrior, GaussianPrior
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    T_true, R_true = 10.0, 12.0
    freq = np.array([f.freq_eff.value for f in filters])
    lum = np.array([f.synthesize(planck_fast, T_true, R_true) for f in filters])
    rng = np.random.default_rng(1)
    dlum = 0.03 * lum
    epoch = LC([np.full(6, 57500.0), filters, freq, lum + rng.normal(scale=dlum), dlum],
               names=["MJD", "filter", "freq", "lum", "dlum"])
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
    guesses = np.abs(rng.normal(size=(10, 2))) + [10.0, 10.0]
    if use_sigma:
        priors.append(GaussianPrior(0.0, 10.0))
        guesses = np.append(guesses, np.abs(rng.normal(size=(10, 1))), axis=1)
    sampler = bol.spectrum_mcmc(planck_fast, epoch, priors, guesses, outpath=str(tmp_path),
                                nwalkers=10, burnin_steps=300, steps=200, seed=5,
                                use_sigma=use_sigma,
                                labels=["T", "R"] + (["sig"] if use_sigma else []))
    med = np.median(sampler.flatchain, axis=0)
    assert med[0] == pytest.approx(T_true, rel=0.15)
    assert med[1] == pytest.approx(R_true, rel=0.15)
    # corner pdf written
    assert any(p.suffix == ".pdf" for p in tmp_path.iterdir())
    plt.close("all")


def test_calculate_bolometric_e2e(tmp_path):
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57474.0)
    t0 = bol.calculate_bolometric(lc, outpath=str(tmp_path), res=1.0, nwalkers=10,
                                  burnin_steps=100, steps=60, seed=7,
                                  colors=["B-V", "g-r"], save_corners=False,
                                  save_table_as=str(tmp_path / "bol.txt"))
    assert len(t0) >= 3
    # curve_fit and MCMC estimates agree at the tens-of-percent level
    temp = np.asarray(t0["temp"], float)
    temp_mcmc = np.asarray(t0["temp_mcmc"], float)
    good = np.isfinite(temp) & np.isfinite(temp_mcmc)
    assert good.any()
    np.testing.assert_allclose(temp[good], temp_mcmc[good], rtol=0.5)
    # luminosities positive and ordered sensibly: L_bol >= pseudobolometric L
    L_bol = np.asarray(t0["L_bol"], float)[good]
    L = np.asarray(t0["L"], float)[good]
    assert np.all(L_bol > 0) and np.all(L > 0)
    assert np.all(L_bol >= L * 0.9)
    # deprecated aliases present
    for old, new in bol.DEPRECATED_BOLOMETRIC_COLNAMES:
        assert old in t0.colnames
    # table saved
    assert os.path.exists(tmp_path / "bol.txt")
    # plots run
    fig = bol.plot_bolometric_results(t0, xcol="MJD")
    plt.close(fig)
    fig = bol.plot_color_curves(t0)
    plt.close(fig)
    plt.close("all")


@pytest.mark.slow
def test_batch_mode_matches_sequential(tmp_path):
    """Batched (vmapped-epochs) MCMC agrees statistically with the sequential
    path on the same epochs."""
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57474.0)
    kwargs = dict(res=1.0, nwalkers=10, burnin_steps=150, steps=100, seed=7,
                  save_corners=False)
    t_seq = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "a"), **kwargs)
    t_bat = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "b"),
                                     batch_mode=True, **kwargs)
    assert len(t_seq) == len(t_bat)
    for col in ["temp_mcmc", "radius_mcmc"]:
        a = np.asarray(t_seq[col], float)
        b = np.asarray(t_bat[col], float)
        # posterior widths from the sequential run
        sig = (np.asarray(t_seq[f"d{col}0"], float) + np.asarray(t_seq[f"d{col}1"], float))
        good = np.isfinite(a) & np.isfinite(b)
        assert good.any()
        # medians agree within ~2x the posterior interval (short chains)
        assert np.all(np.abs(a[good] - b[good]) < 2.0 * sig[good] + 0.1 * np.abs(a[good]))
    # curve_fit columns identical (same host path)
    np.testing.assert_allclose(np.asarray(t_seq["temp"], float),
                               np.asarray(t_bat["temp"], float), rtol=1e-6)


def test_spectrum_mcmc_jnp_spectrum_runs_device_sampler(tmp_path):
    """A pure-jnp custom spectrum function must get the jitted device
    sampler (EnsembleSampler), not the ~19 evals/s host fallback — and
    without any fallback warning (the warning filter turns one into an
    error)."""
    import warnings
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.models import UniformPrior
    from lightcurve_fitting_tpu.parallel.sampler import EnsembleSampler

    def jnp_powerlaw(nu, amp, alpha):
        return amp * 1e15 * jnp.power(nu / 500.0, alpha)

    filters = [filtdict[n] for n in ["B", "V", "r", "i", "g"]]
    amp_true, alpha_true = 2.0, -1.0
    lum = np.array([f.synthesize(
        lambda nu, a, al: a * 1e15 * np.power(np.asarray(nu) / 500.0, al),
        amp_true, alpha_true) for f in filters])
    epoch = LC([np.full(5, 57000.0), filters, lum, 0.03 * lum],
               names=["MJD", "filter", "lum", "dlum"])
    priors = [UniformPrior(0.1, 10.0), UniformPrior(-3.0, 1.0)]
    rng = np.random.default_rng(0)
    guesses = np.column_stack([rng.uniform(1.0, 3.0, 10),
                               rng.uniform(-2.0, 0.0, 10)])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="device SED path unavailable")
        sampler = bol.spectrum_mcmc(jnp_powerlaw, epoch, priors, guesses,
                                    outpath=str(tmp_path), nwalkers=10,
                                    burnin_steps=150, steps=100, seed=4,
                                    make_corner=False)
    assert isinstance(sampler, EnsembleSampler)
    med = np.median(sampler.flatchain, axis=0)
    assert med[0] == pytest.approx(amp_true, rel=0.2)
    assert med[1] == pytest.approx(alpha_true, abs=0.3)


def test_spectrum_mcmc_generic_python_spectrum(tmp_path):
    """Arbitrary (non-jax-traceable) spectrum callables fall back to the host
    sampler, preserving the reference's generality (bolometric.py:87-97)."""
    from lightcurve_fitting_tpu.models import UniformPrior

    def numpy_powerlaw(nu, amp, alpha):
        nu = np.asarray(nu)  # forces host execution (fails on jax tracers)
        amp = np.atleast_1d(np.asarray(amp, float))
        alpha = np.atleast_1d(np.asarray(alpha, float))
        return np.squeeze(amp[:, None] * 1e15 * (nu / 500.0) ** alpha[:, None])

    filters = [filtdict[n] for n in ["B", "V", "r", "i"]]
    freq = np.array([f.freq_eff.value for f in filters])
    amp_true, alpha_true = 2.0, -1.0
    lum = np.array([f.synthesize(numpy_powerlaw, amp_true, alpha_true) for f in filters])
    dlum = 0.03 * lum
    epoch = LC([np.full(4, 57000.0), filters, freq, lum, dlum],
               names=["MJD", "filter", "freq", "lum", "dlum"])
    priors = [UniformPrior(0.1, 10.0), UniformPrior(-3.0, 1.0)]
    guesses = np.column_stack([np.random.default_rng(0).uniform(1.0, 3.0, 10),
                               np.random.default_rng(1).uniform(-2.0, 0.0, 10)])
    sampler = bol.spectrum_mcmc(numpy_powerlaw, epoch, priors, guesses,
                                outpath=str(tmp_path), nwalkers=10,
                                burnin_steps=150, steps=100, seed=4,
                                labels=["amp", "alpha"])
    med = np.median(sampler.flatchain, axis=0)
    assert med[0] == pytest.approx(amp_true, rel=0.2)
    assert med[1] == pytest.approx(alpha_true, abs=0.3)
    plt.close("all")


@pytest.mark.slow
def test_bolometric_options(tmp_path):
    """do_mcmc=False, cutoff_freq, also_group_by, save_chains, use_sigma."""
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57472.0)
    # no MCMC: mcmc columns masked, curve_fit columns present
    t_no = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "n"), res=1.0,
                                    do_mcmc=False, seed=1, save_corners=False)
    assert np.isfinite(np.asarray(t_no["temp"], float)).any()
    assert np.asarray(t_no.mask["temp_mcmc"]).all()
    # modified blackbody with a cutoff frequency
    t_cut = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "c"), res=1.0,
                                     nwalkers=10, burnin_steps=60, steps=40,
                                     cutoff_freq=700.0, seed=1, save_corners=False)
    assert np.isfinite(np.asarray(t_cut["L_bol"], float)).any()
    # save_chains writes per-epoch npy files
    bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "s"), res=1.0,
                             nwalkers=10, burnin_steps=60, steps=40,
                             save_chains=True, seed=1, save_corners=False)
    assert any(f.suffix == ".npy" for f in (tmp_path / "s").iterdir())
    # use_sigma adds the third parameter
    t_sig = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "g"), res=1.0,
                                     nwalkers=10, burnin_steps=60, steps=40,
                                     use_sigma=True, seed=1, save_corners=False)
    assert np.isfinite(np.asarray(t_sig["temp_mcmc"], float)).any()
    # also_group_by source splits epochs by source
    lc2 = load_lc().where(MJD_min=57468.0, MJD_max=57471.0)
    groups = bol.group_by_epoch(lc2, res=1.0, also_group_by=["source"])
    assert len(groups) >= len(bol.group_by_epoch(load_lc().where(MJD_min=57468.0, MJD_max=57471.0), res=1.0))
    plt.close("all")


def test_single_filter_epoch_kde_chaining(tmp_path):
    """min_nfilt=1: single-filter epochs chain the previous epoch's temperature
    posterior as a KDE prior (reference bolometric.py:753-759 — which would
    crash there on the subsequent bounds lookup; our KDEPrior keeps bounds)."""
    from lightcurve_fitting_tpu.models import planck_fast
    rng = np.random.default_rng(3)
    rows_t, rows_f, rows_m, rows_dm = [], [], [], []
    T_true, R_true = 9.0, 8.0
    # epoch 1: 4 filters; epoch 2: single filter
    for mjd, bands in [(57500.0, ["B", "V", "r", "i"]), (57501.0, ["r"])]:
        for b in bands:
            f = filtdict[b]
            lum = f.synthesize(planck_fast, T_true, R_true)
            mag = -2.5 * np.log10(lum) + f.m0 + 90.19 + 30.0
            rows_t.append(mjd)
            rows_f.append(b)
            rows_m.append(mag + rng.normal(scale=0.02))
            rows_dm.append(0.02)
    lc = LC([np.array(rows_t), np.array(rows_m), np.array(rows_dm), np.array(rows_f)],
            names=["MJD", "mag", "dmag", "filter"])
    lc.meta.update(dm=30.0, redshift=0.0, extinction={})
    t0 = bol.calculate_bolometric(lc, outpath=str(tmp_path), res=0.5, nwalkers=10,
                                  burnin_steps=60, steps=50, min_nfilt=1, seed=2,
                                  save_corners=False)
    assert len(t0) == 2
    temp = np.asarray(t0["temp_mcmc"], float)
    assert np.isfinite(temp).all()
    # the chained epoch's temperature stays near the first epoch's posterior
    assert temp[1] == pytest.approx(temp[0], rel=0.4)
    plt.close("all")


def test_missing_masks_numpy_masked_values():
    """np.ma.masked cells (e.g. a color from a masked absmag) must be masked
    in the output table, not written as their fill value."""
    from lightcurve_fitting_tpu.bolometric import _missing

    arr = np.ma.MaskedArray([1.0, 2.0], mask=[True, False])
    assert _missing(np.ma.masked)
    assert _missing(arr[0])
    assert not _missing(arr[1])
    assert _missing(np.nan)
    assert not _missing(0.0)
    assert not _missing(False)
    assert _missing("")
    assert not _missing("src")


def test_batched_mcmc_f32_state_matches_f64():
    """batched_blackbody_mcmc(state_dtype=np.float32) — the accelerator
    default — reproduces the f64-state posteriors (epoch parameters are
    O(1)-O(1e3), so f32 needs no rescaling here)."""
    from lightcurve_fitting_tpu.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu.models import UniformPrior, LogUniformPrior
    from lightcurve_fitting_tpu.models.blackbody import planck_lnu
    from lightcurve_fitting_tpu.parallel.batched import (pack_epochs,
                                                         batched_blackbody_mcmc)
    from lightcurve_fitting_tpu.utils.table import Table
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    filters = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filters)
    epochs, truths = [], []
    for e in range(4):
        T, R = rng.uniform(5.0, 18.0), rng.uniform(1.0, 20.0)
        truths.append((T, R))
        lnu = np.asarray(planck_lnu(jnp.asarray(bank.emitted_nodes(0.0)), T, R))
        y = (bank.weights * lnu).sum(-1)
        dy = 0.05 * np.abs(y)
        epochs.append(Table([filters, y + rng.normal(scale=dy), dy],
                            names=["filter", "lum", "dlum"]))
    packed = pack_epochs(epochs, bank, 0.0)
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
    guesses = np.stack([np.column_stack([rng.uniform(5, 20, 16), rng.uniform(1, 20, 16)])
                        for _ in range(4)])
    f64, a64 = batched_blackbody_mcmc(packed, priors, guesses, 16, 150, 150,
                                      state_dtype=np.float64, seed=1)
    f32, a32 = batched_blackbody_mcmc(packed, priors, guesses, 16, 150, 150,
                                      state_dtype=np.float32, seed=1)
    assert f32.dtype == np.float64
    for e, (T, R) in enumerate(truths):
        m64 = np.median(f64[e], axis=0)
        m32 = np.median(f32[e], axis=0)
        sig = f64[e].std(axis=0)
        assert np.all(np.abs(m64 - m32) < 3 * sig + 0.05 * np.abs(m64)), (e, m64, m32)
        assert abs(m32[0] - T) < 0.15 * T + 3 * sig[0], (e, m32, T)


def test_batched_mcmc_epoch_sharding_matches_single_device():
    """The epoch axis shards over a mesh (zero-collective shard_map) with
    identical results, including a non-divisible epoch count (5 epochs on 8
    devices -> padded with the last epoch, sliced back)."""
    from lightcurve_fitting_tpu.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu.models import UniformPrior, LogUniformPrior
    from lightcurve_fitting_tpu.models.blackbody import planck_lnu
    from lightcurve_fitting_tpu.parallel.batched import (
        pack_epochs, batched_blackbody_mcmc, batched_map_centers)
    from lightcurve_fitting_tpu.parallel.mesh import walker_mesh
    from lightcurve_fitting_tpu.utils.table import Table
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    filters = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filters)
    epochs = []
    for e in range(5):
        T, R = rng.uniform(5.0, 18.0), rng.uniform(1.0, 20.0)
        lnu = np.asarray(planck_lnu(jnp.asarray(bank.emitted_nodes(0.0)), T, R))
        y = (bank.weights * lnu).sum(-1)
        dy = 0.05 * np.abs(y)
        epochs.append(Table([filters, y + rng.normal(scale=dy), dy],
                            names=["filter", "lum", "dlum"]))
    packed = pack_epochs(epochs, bank, 0.0)
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
    mesh = walker_mesh(8, axis_name="epochs")

    c1 = batched_map_centers(packed, priors, seed=2)
    c8 = batched_map_centers(packed, priors, seed=2, mesh=mesh)
    np.testing.assert_allclose(c8, c1, rtol=1e-9)

    guesses = rng.normal(size=(5, 16, 2)) * 0.5 + c1[:, None, :]
    guesses[guesses <= 0.0] = 1.0
    f1, a1 = batched_blackbody_mcmc(packed, priors, guesses, 16, 50, 50, seed=3)
    f8, a8 = batched_blackbody_mcmc(packed, priors, guesses, 16, 50, 50, seed=3,
                                    mesh=mesh)
    assert f8.shape == f1.shape == (5, 50 * 16, 2)
    np.testing.assert_allclose(f8, f1, rtol=1e-12)
    np.testing.assert_allclose(a8, a1, rtol=1e-12)


def test_calculate_bolometric_mesh_smoke(tmp_path):
    """calculate_bolometric(batch_mode=True, mesh=...) runs the epoch-sharded
    device path end-to-end and matches the unsharded batch mode."""
    from lightcurve_fitting_tpu.parallel.mesh import walker_mesh

    lc = load_lc().where(MJD_min=57468.0, MJD_max=57472.0)
    kwargs = dict(res=1.0, nwalkers=10, burnin_steps=60, steps=40, seed=7,
                  save_corners=False, batch_mode=True)
    # mesh=False forces single-device (mesh=None would auto-shard over the
    # 8 virtual devices, same as passing the mesh explicitly)
    t_b = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "b"),
                                   mesh=False, **kwargs)
    t_m = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "m"),
                                   mesh=walker_mesh(8, axis_name="epochs"),
                                   **kwargs)
    for col in ["temp_mcmc", "radius_mcmc", "L_mcmc"]:
        np.testing.assert_allclose(np.asarray(t_m[col], float),
                                   np.asarray(t_b[col], float), rtol=1e-9)


def test_batched_device_summaries_match_host_record():
    """batched_blackbody_mcmc(summaries=...) computes _mcmc_record's
    percentiles on device; against the host path on the returned chains the
    records must agree to float32-integrand precision."""
    from lightcurve_fitting_tpu.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu.models import UniformPrior, LogUniformPrior
    from lightcurve_fitting_tpu.models.blackbody import planck_lnu
    from lightcurve_fitting_tpu.parallel.batched import (pack_epochs,
                                                         batched_blackbody_mcmc)
    from lightcurve_fitting_tpu.bolometric import (_mcmc_record, _pseudo_grid,
                                                   _summary_record)
    from lightcurve_fitting_tpu.utils.table import Table
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    filters = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filters)
    z = 0.01
    epochs = []
    for e in range(3):
        T, R = rng.uniform(5.0, 18.0), rng.uniform(1.0, 20.0)
        lnu = np.asarray(planck_lnu(jnp.asarray(bank.emitted_nodes(z)), T, R))
        y = (bank.weights * lnu).sum(-1)
        dy = 0.05 * np.abs(y)
        epochs.append(Table([filters, y + rng.normal(scale=dy), dy],
                            names=["filter", "lum", "dlum"]))
    packed = pack_epochs(epochs, bank, z)
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
    guesses = np.stack([np.column_stack([rng.uniform(5, 20, 16), rng.uniform(1, 20, 16)])
                        for _ in range(3)])
    cutoff = 800.0
    flat, acc, summ = batched_blackbody_mcmc(
        packed, priors, guesses, 16, 80, 60, cutoff_freq=cutoff, seed=5,
        summaries={"z": z, "pseudo_nu": _pseudo_grid()}, return_chains=True)
    assert summ.shape == (3, 4, 3)
    for e in range(3):
        host = _mcmc_record(flat[e], z, cutoff)
        dev = _summary_record(summ[e])
        assert set(dev) == set(host)
        for k, v in host.items():
            assert dev[k] == pytest.approx(v, rel=1e-5), k

    # return_chains=False elides the chain transfer but keeps the summaries
    none_flat, acc2, summ2 = batched_blackbody_mcmc(
        packed, priors, guesses, 16, 80, 60, cutoff_freq=cutoff, seed=5,
        summaries={"z": z, "pseudo_nu": _pseudo_grid()}, return_chains=False)
    assert none_flat is None
    np.testing.assert_allclose(summ2, summ, rtol=1e-12)


def test_epoch_summary_f32_compute_dtype_matches_f64():
    """With the accelerator compute dtype (float32) _epoch_summary runs
    ops/quantile.py's counting bisection on f32-cast samples; on identical
    input chains it must match the f64-sort path inside the f32-integrand
    budget (same 1e-5 budget as the host-record parity above)."""
    from lightcurve_fitting_tpu.parallel.batched import _epoch_summary
    from lightcurve_fitting_tpu.bolometric import _pseudo_grid
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    S = 16 * 40
    flat = jnp.asarray(np.column_stack([rng.uniform(4.0, 20.0, S),
                                        rng.uniform(1.0, 30.0, S)]))
    nu = _pseudo_grid()
    trap_w = np.gradient(nu)
    summ64 = np.asarray(_epoch_summary(flat, jnp.float64, None,
                                       jnp.asarray(nu), jnp.asarray(trap_w),
                                       800.0, 16))
    summ32 = np.asarray(_epoch_summary(flat, jnp.float64, jnp.float32,
                                       jnp.asarray(nu), jnp.asarray(trap_w),
                                       800.0, 16))
    assert summ64.shape == summ32.shape == (4, 3)
    # dt also controls the Planck integrand dtype, so the pseudobolometric
    # row carries f32 integration error; T/R/R^2T^4 percentiles only f32
    # sample rounding
    np.testing.assert_allclose(summ32[:3], summ64[:3], rtol=2e-6)
    np.testing.assert_allclose(summ32[3], summ64[3], rtol=1e-4)


def test_calculate_bolometric_summaries_only_matches_chain_path(tmp_path):
    """With save_corners=False/save_chains=False the batch path never reads
    chains back; its MCMC columns must equal the chain-returning run (same
    seed) exactly, since both use the device summaries."""
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57472.0)
    kwargs = dict(res=1.0, nwalkers=10, burnin_steps=60, steps=40, seed=9,
                  batch_mode=True, mesh=False)
    t_fast = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "f"),
                                      save_corners=False, **kwargs)
    t_full = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "c"),
                                      save_corners=False, save_chains=True,
                                      **kwargs)
    assert any(f.suffix == ".npy" for f in (tmp_path / "c").iterdir())
    for col in ["temp_mcmc", "radius_mcmc", "L_bol_mcmc", "L_mcmc",
                "dL_mcmc0", "dL_mcmc1"]:
        np.testing.assert_allclose(np.asarray(t_fast[col], float),
                                   np.asarray(t_full[col], float), rtol=1e-12)
    plt.close("all")


def test_batch_mode_respects_kde_chaining(tmp_path):
    """batch_mode with min_nfilt=1 and a [multi, single, multi] epoch order:
    the multi-filter epoch AFTER the chaining event must fit sequentially
    with the mutated (KDE) prior — pre-batching it with the original priors
    diverged from the sequential statistics."""
    from lightcurve_fitting_tpu.models import planck_fast
    rng = np.random.default_rng(3)
    rows_t, rows_f, rows_m, rows_dm = [], [], [], []
    T_true, R_true = 9.0, 8.0
    for mjd, bands in [(57500.0, ["B", "V", "r", "i"]), (57501.0, ["r"]),
                       (57502.0, ["B", "V", "r", "i"])]:
        for b in bands:
            f = filtdict[b]
            lum = f.synthesize(planck_fast, T_true, R_true)
            mag = -2.5 * np.log10(lum) + f.m0 + 90.19 + 30.0
            rows_t.append(mjd)
            rows_f.append(b)
            rows_m.append(mag + rng.normal(scale=0.02))
            rows_dm.append(0.02)
    lc = LC([np.array(rows_t), np.array(rows_m), np.array(rows_dm), np.array(rows_f)],
            names=["MJD", "mag", "dmag", "filter"])
    lc.meta.update(dm=30.0, redshift=0.0, extinction={})
    kwargs = dict(res=0.5, nwalkers=10, burnin_steps=80, steps=60,
                  min_nfilt=1, seed=2, save_corners=False)
    t_seq = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "s"),
                                     batch_mode=False, **kwargs)
    t_bat = bol.calculate_bolometric(lc.copy(), outpath=str(tmp_path / "b"),
                                     batch_mode=True, mesh=False, **kwargs)
    temp_s = np.asarray(t_seq["temp_mcmc"], float)
    temp_b = np.asarray(t_bat["temp_mcmc"], float)
    assert len(temp_s) == len(temp_b) == 3
    assert np.isfinite(temp_s).all() and np.isfinite(temp_b).all()
    # same statistics in both modes, including the post-chaining epoch
    np.testing.assert_allclose(temp_b, temp_s, rtol=0.25)
    plt.close("all")


def test_batched_mcmc_rejects_odd_nwalkers():
    """Round-4 review fix: batched_blackbody_mcmc raises the same clean
    ValueError as every sibling ensemble driver instead of a cryptic
    reshape error inside jit tracing."""
    from lightcurve_fitting_tpu.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu.parallel.batched import (
        pack_epochs, batched_blackbody_mcmc)
    from lightcurve_fitting_tpu.models import UniformPrior
    from lightcurve_fitting_tpu.utils.table import Table

    filters = [filtdict[n] for n in ["g", "r"]]
    bank = FilterBank(filters)
    epochs = [Table([filters, np.array([1.0, 1.1]), np.array([0.1, 0.1])],
                    names=["filter", "lum", "dlum"])]
    packed = pack_epochs(epochs, bank, 0.0)
    priors = [UniformPrior(1.0, 20.0), UniformPrior(0.1, 10.0)]
    guesses = np.full((1, 11, 2), 5.0)
    with pytest.raises(ValueError, match="even"):
        batched_blackbody_mcmc(packed, priors, guesses, nwalkers=11,
                               burnin_steps=10, steps=10)


def test_kde_chaining_use_sigma_and_no_prior_mutation(tmp_path):
    """Round-4 review fixes: (a) with use_sigma=True the chained p0 must use
    only the (T, R) flatchain columns — the intrinsic-scatter column crashed
    the 2-parameter lstsq stage; (b) the caller's priors list must not be
    mutated by the KDE rebinding (a second call reusing the list would
    silently inherit the previous run's KDE temperature prior)."""
    from lightcurve_fitting_tpu.models import planck_fast
    from lightcurve_fitting_tpu.models import UniformPrior, LogUniformPrior, GaussianPrior
    rng = np.random.default_rng(5)
    rows_t, rows_f, rows_m, rows_dm = [], [], [], []
    for mjd, bands in [(57500.0, ["B", "V", "r", "i"]), (57501.0, ["r"])]:
        for b in bands:
            f = filtdict[b]
            lum = f.synthesize(planck_fast, 9.0, 8.0)
            mag = -2.5 * np.log10(lum) + f.m0 + 90.19 + 30.0
            rows_t.append(mjd)
            rows_f.append(b)
            rows_m.append(mag + rng.normal(scale=0.02))
            rows_dm.append(0.02)
    lc = LC([np.array(rows_t), np.array(rows_m), np.array(rows_dm), np.array(rows_f)],
            names=["MJD", "mag", "dmag", "filter"])
    lc.meta.update(dm=30.0, redshift=0.0, extinction={})
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0),
              GaussianPrior(0.0, 10.0)]
    t_prior = priors[0]
    t0 = bol.calculate_bolometric(lc, outpath=str(tmp_path), res=0.5, nwalkers=10,
                                  burnin_steps=40, steps=30, min_nfilt=1, seed=2,
                                  priors=priors, use_sigma=True, save_corners=False)
    assert len(t0) == 2
    assert np.isfinite(np.asarray(t0["temp_mcmc"], float)).all()
    assert priors[0] is t_prior  # caller's list untouched
    plt.close("all")


def test_batch_mode_pads_odd_nwalkers(tmp_path):
    """Round-4 review fix: batch_mode pads odd nwalkers to even exactly like
    the sequential path does inside spectrum_mcmc, instead of crashing."""
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57474.0)
    t0 = bol.calculate_bolometric(lc, outpath=str(tmp_path), nwalkers=11,
                                  burnin_steps=20, steps=20, seed=1,
                                  batch_mode=True, mesh=False, save_corners=False)
    assert len(t0) >= 1
    assert np.isfinite(np.asarray(t0["temp_mcmc"], float)).any()
    plt.close("all")


def test_plot_chain_axes():
    """plot_chain: one trace panel per parameter (reference bolometric.py:62-84)."""
    from lightcurve_fitting_tpu.bolometric import plot_chain

    rng = np.random.default_rng(0)
    chain = rng.normal(size=(8, 30, 3))      # (nwalkers, nsteps, ndim)
    fig = plot_chain(chain, labels=["T", "R", "sigma"])
    assert len(fig.axes) == 3
    assert fig.axes[0].get_ylabel() == "T"
    import matplotlib.pyplot as plt
    plt.close(fig)


def test_spectrum_corner_smoke(tmp_path):
    """spectrum_corner: corner + SED inset with posterior-draw spectra over
    the observed points (behavioral spec: reference bolometric.py:193-287)."""
    from lightcurve_fitting_tpu.bolometric import spectrum_corner
    from lightcurve_fitting_tpu.models import planck_fast
    from lightcurve_fitting_tpu.filters import filtdict
    from lightcurve_fitting_tpu.lightcurve import LC

    rng = np.random.default_rng(1)
    filters = [filtdict[n] for n in ["B", "V", "r"]]
    freq = np.array([f.freq_eff.value for f in filters])
    T, R = 9.0, 10.0
    lum = planck_fast(freq, T, R)
    epoch1 = LC([np.full(3, 57500.0), filters, lum, 0.05 * lum, freq],
                names=("MJD", "filter", "lum", "dlum", "freq"))
    flat = np.column_stack([rng.normal(T, 0.1, 300), rng.normal(R, 0.2, 300)])
    out = str(tmp_path / "sc.png")
    fig = spectrum_corner(planck_fast, epoch1, flat, labels=["T", "R"],
                          save_plot_as=out)
    assert os.path.exists(out)
    import matplotlib.pyplot as plt
    plt.close(fig)


@pytest.mark.parametrize("state_dtype", ["auto", np.float32, np.float64],
                         ids=["auto", "float32", "float64"])
def test_calculate_bolometric_forwards_state_dtype(tmp_path, monkeypatch, state_dtype):
    """Batch mode hands ``state_dtype`` to the batched sampler, which
    resolves it: "auto" is float64 walker state on the CPU."""
    from lightcurve_fitting_tpu.parallel import batched
    seen = []
    real = batched.batched_blackbody_mcmc

    def spy(*args, **kwargs):
        seen.append(kwargs["state_dtype"])
        return real(*args, **kwargs)

    monkeypatch.setattr(batched, "batched_blackbody_mcmc", spy)
    lc = load_lc().where(MJD_min=57468.0, MJD_max=57471.0)
    t = bol.calculate_bolometric(lc, outpath=str(tmp_path), nwalkers=4,
                                 burnin_steps=10, steps=10, seed=0,
                                 batch_mode=True, mesh=False, save_corners=False,
                                 state_dtype=state_dtype)
    assert seen == [state_dtype]
    assert batched._epoch_state_is_f32(state_dtype) == (state_dtype is np.float32)
    assert len(t) > 0 and np.isfinite(np.asarray(t["temp_mcmc"], float)).all()
