"""Statistical validation of the stretch-move ensemble sampler on targets with
known posteriors (SURVEY.md §4: verification is statistical, 1 sigma / sqrt(N))."""

import numpy as np
import jax.numpy as jnp
import pytest

from lightcurve_fitting_tpu.parallel.sampler import EnsembleSampler


def test_gaussian_target_moments():
    """Correlated 3-D Gaussian: recovered mean/cov within Monte Carlo error."""
    mean = np.array([1.0, -2.0, 0.5])
    A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, -0.4], [0.0, -0.4, 0.5]])
    cov = A @ A.T
    icov = jnp.asarray(np.linalg.inv(cov))
    mu = jnp.asarray(mean)

    def logp(p):
        d = p - mu
        return -0.5 * d @ icov @ d

    nwalkers = 64
    s = EnsembleSampler(nwalkers, 3, logp, seed=42)
    rng = np.random.default_rng(0)
    p0 = mean + rng.normal(size=(nwalkers, 3))
    pos, lp, _ = s.run_mcmc(p0, 500)
    s.reset()
    s.run_mcmc(pos, 3000, skip_initial_state_check=True)

    flat = s.flatchain
    assert flat.shape == (3000 * nwalkers, 3)
    tau = s.get_autocorr_time()
    n_eff = flat.shape[0] / np.max(tau)
    # means within 5 sigma_MC
    se = np.sqrt(np.diag(cov) / n_eff)
    np.testing.assert_allclose(flat.mean(0), mean, atol=5 * se.max())
    # covariance within 10%
    np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.15, atol=0.05)
    # acceptance in the healthy range for a=2 on a Gaussian
    af = s.acceptance_fraction
    assert af.shape == (nwalkers,)
    assert 0.2 < af.mean() < 0.9


def test_bounded_target_rejects_outside():
    """Hard bounds via -inf: samples never leave the support."""
    def logp(p):
        inb = (p[0] > 0.0) & (p[0] < 1.0) & (p[1] > 0.0) & (p[1] < 1.0)
        return jnp.where(inb, 0.0, -jnp.inf)

    s = EnsembleSampler(32, 2, logp, seed=1)
    p0 = np.random.default_rng(2).uniform(0.2, 0.8, size=(32, 2))
    s.run_mcmc(p0, 500)
    flat = s.flatchain
    assert flat.min() >= 0.0 and flat.max() <= 1.0
    # uniform target: mean ~ 0.5
    np.testing.assert_allclose(flat.mean(0), [0.5, 0.5], atol=0.05)


def test_invalid_initial_state_raises():
    def logp(p):
        return jnp.where(p[0] > 0, 0.0, -jnp.inf)

    s = EnsembleSampler(8, 1, logp, seed=0)
    bad = -np.ones((8, 1))
    with pytest.raises(ValueError, match="non-finite"):
        s.run_mcmc(bad, 10)
    # but skip_initial_state_check tolerates it (reference fitting.py:145)
    s.run_mcmc(np.abs(bad), 10, skip_initial_state_check=True)


def test_chain_layouts_match_emcee_conventions():
    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    s = EnsembleSampler(10, 2, logp, seed=3)
    p0 = np.random.default_rng(3).normal(size=(10, 2))
    pos, lp, _ = s.run_mcmc(p0, 25)
    assert pos.shape == (10, 2)
    assert lp.shape == (10,)
    assert s.chain.shape == (10, 25, 2)          # legacy emcee layout
    assert s.get_chain().shape == (25, 10, 2)    # emcee 3 layout
    assert s.flatchain.shape == (250, 2)
    # chains accumulate across runs; reset clears
    s.run_mcmc(None, 5)
    assert s.chain.shape == (10, 30, 2)
    s.reset()
    assert s.flatchain.shape == (0, 2)


def test_reproducible_with_seed():
    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    chains = []
    for _ in range(2):
        s = EnsembleSampler(16, 2, logp, seed=7)
        p0 = np.random.default_rng(5).normal(size=(16, 2))
        s.run_mcmc(p0, 50)
        chains.append(s.flatchain)
    np.testing.assert_array_equal(chains[0], chains[1])


def test_checkpoint_resume(tmp_path):
    """Checkpoint -> restore reproduces the exact same continuation."""
    import jax.numpy as jnp

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    p0 = np.random.default_rng(9).normal(size=(16, 2))
    s1 = EnsembleSampler(16, 2, logp, seed=21)
    s1.run_mcmc(p0, 30)
    ckpt = str(tmp_path / "state.npz")
    s1.save_checkpoint(ckpt)
    s1.run_mcmc(None, 20)

    s2 = EnsembleSampler(16, 2, logp, seed=99)  # different seed; overwritten by restore
    s2.load_checkpoint(ckpt)
    s2.run_mcmc(None, 20)
    np.testing.assert_array_equal(s1.flatchain, s2.flatchain)
    np.testing.assert_array_equal(s1.acceptance_fraction, s2.acceptance_fraction)


def test_progress_segments_equivalent(capsys):
    """Segmented (progress) runs produce chains with identical statistics
    machinery: shapes, bookkeeping, and determinism per segment boundaries."""
    import jax.numpy as jnp

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    p0 = np.random.default_rng(2).normal(size=(16, 2))
    s = EnsembleSampler(16, 2, logp, seed=5)
    s.run_mcmc(p0, 100, progress=True)
    out = capsys.readouterr().out
    assert "100/100" in out
    assert s.flatchain.shape == (1600, 2)


def test_diagnostics_rhat_ess():
    """Split-R-hat ~1 and sensible ESS on a converged chain; large R-hat on a
    deliberately unconverged one."""
    from lightcurve_fitting_tpu.parallel.diagnostics import (split_rhat,
                                                             effective_sample_size,
                                                             summarize_chain)
    import jax.numpy as jnp

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    s = EnsembleSampler(32, 2, logp, seed=13)
    p0 = np.random.default_rng(0).normal(size=(32, 2))
    s.run_mcmc(p0, 200)
    s.reset()
    s.run_mcmc(None, 1000)
    chain = s.get_chain()  # (nsteps, nwalkers, ndim)
    rhat = split_rhat(chain)
    assert np.all(rhat < 1.05), rhat
    ess = effective_sample_size(chain)
    assert np.all(ess > 200), ess
    text = summarize_chain(chain, names=["a", "b"])
    assert "R-hat" in text and "ESS" in text
    # unconverged: two chains stuck at different values
    fake = np.concatenate([np.random.default_rng(1).normal(0, 0.1, (500, 16, 1)),
                           np.random.default_rng(2).normal(5, 0.1, (500, 16, 1))], axis=1)
    assert split_rhat(fake)[0] > 1.5


def test_thin_by():
    import jax.numpy as jnp

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    s = EnsembleSampler(16, 2, logp, seed=3)
    p0 = np.random.default_rng(3).normal(size=(16, 2))
    s.run_mcmc(p0, 50, thin_by=4)  # 200 actual steps, 50 stored
    assert s.get_chain().shape == (50, 16, 2)
    # acceptance accounts for all 200 proposals: both the counter AND the
    # accept flags (inner thinned steps used to be dropped, capping the
    # reported fraction at 1/thin_by)
    assert s._nsteps_total == 200
    af_thin = float(np.mean(s.acceptance_fraction))
    s2 = EnsembleSampler(16, 2, logp, seed=3)
    s2.run_mcmc(p0, 200, thin_by=1)  # identical RNG stream, unthinned
    af_full = float(np.mean(s2.acceptance_fraction))
    assert af_thin == pytest.approx(af_full, abs=1e-12)
    assert 0.2 < af_thin < 0.9


def test_replicated_ensembles_sample_correctly():
    """replicas=R runs R independent ensembles in one vmapped scan; pooled
    chains reproduce the target moments and bookkeeping shapes scale by R."""
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.parallel.sampler import EnsembleSampler

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    s = EnsembleSampler(16, 3, logp, seed=0, replicas=4)
    assert s.total_walkers == 64
    rng = np.random.default_rng(0)
    pos, lp, _ = s.run_mcmc(rng.normal(size=(64, 3)), 50)
    assert pos.shape == (64, 3) and lp.shape == (64,)
    s.reset()
    s.run_mcmc(None, 300)
    flat = s.flatchain
    assert flat.shape == (300 * 64, 3)
    assert s.chain.shape == (64, 300, 3)
    assert np.all(np.abs(flat.mean(0)) < 0.15)
    assert np.all(np.abs(flat.std(0) - 1.0) < 0.15)
    assert 0.2 < s.acceptance_fraction.mean() < 0.9
    # checkpoint roundtrip preserves the replicated state
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        s.save_checkpoint(path)
        s2 = EnsembleSampler(16, 3, logp, seed=1, replicas=4)
        s2.load_checkpoint(path)
        p1, l1, _ = s.run_mcmc(None, 1)
        # same restored positions feed the next step
        assert s2._pos_internal.shape == s._pos_internal.shape


def test_auto_float32_storage_past_memory_bound(monkeypatch, capsys):
    """A run whose projected chain history exceeds the memory bound downcasts
    the *stored* chains to float32 (with a printed note), including the
    accumulated host-side history (concatenate must not promote back to
    f64); explicit store_dtype=np.float64 opts out."""
    from lightcurve_fitting_tpu.parallel import sampler as sampler_mod

    def logp(p):
        return -0.5 * jnp.sum(p ** 2)

    monkeypatch.setattr(sampler_mod, "_AUTO_STORE_BYTES", 10_000)
    rng = np.random.default_rng(0)
    s = sampler_mod.EnsembleSampler(16, 2, logp, seed=1)
    s.run_mcmc(rng.normal(size=(16, 2)), 100)
    assert "float32" in capsys.readouterr().out
    assert s._chain.dtype == np.float32
    assert s.flatchain.dtype == np.float32
    # a second segment stays f32 (no silent promotion)
    s.run_mcmc(None, 50)
    assert s._chain.dtype == np.float32
    assert s._chain.shape == (150, 16, 2)

    s64 = sampler_mod.EnsembleSampler(16, 2, logp, seed=1, store_dtype=np.float64)
    s64.run_mcmc(rng.normal(size=(16, 2)), 100)
    assert s64._chain.dtype == np.float64


def test_vectorized_autocorr_matches_per_walker_loop():
    """The batched-FFT tau estimator reproduces the per-walker 1-D Sokal
    estimator exactly on AR(1) chains (the round-2 loop was ~500k serial
    FFTs at bench walker counts)."""
    from lightcurve_fitting_tpu.parallel.sampler import (_integrated_autocorr,
                                                         _next_pow_two)

    def old_tau(chain_2d, c=5.0):
        f = np.zeros(chain_2d.shape[0])
        for w in range(chain_2d.shape[1]):
            x = chain_2d[:, w]
            n = _next_pow_two(len(x))
            fw = np.fft.fft(x - np.mean(x), n=2 * n)
            acf = np.fft.ifft(fw * np.conjugate(fw))[: len(x)].real
            f += acf / acf[0]
        f /= chain_2d.shape[1]
        taus = 2.0 * np.cumsum(f) - 1.0
        window = np.arange(len(taus)) >= c * taus
        return taus[np.argmax(window)] if np.any(window) else taus[-1]

    rng = np.random.default_rng(0)
    n, w = 400, 24
    chain = np.empty((n, w, 2))
    for k, rho in enumerate([0.6, 0.9]):
        x = rng.normal(size=(n, w))
        for i in range(1, n):
            x[i] = rho * x[i - 1] + np.sqrt(1 - rho ** 2) * x[i]
        chain[:, :, k] = x
    new = _integrated_autocorr(chain)
    old = np.array([old_tau(chain[:, :, k]) for k in range(2)])
    np.testing.assert_allclose(new, old, rtol=1e-8)
    # zero-variance columns contribute zeros instead of roundoff garbage
    chain[:, 3, 0] = 42.0
    assert np.all(np.isfinite(_integrated_autocorr(chain)))


def test_param_rescaled_f32_state_matches_f64_statistics():
    """param_offset/param_scale: walkers hold an affine-rescaled float32
    state; every public surface stays absolute, the stretch move is
    affine-equivariant, and a narrow posterior far from zero (the absolute-
    f32 killer: MJD-scale epochs quantize at ~6 min) is still resolved."""
    import jax.numpy as jnpp

    mu = np.array([57468.6999, 5.0])
    sig = np.array([2e-4, 0.05])
    mu_j, sig_j = jnp.asarray(mu), jnp.asarray(sig)

    def logp(p):
        return -0.5 * jnp.sum(((p - mu_j) / sig_j) ** 2)

    rng = np.random.default_rng(0)
    p0 = mu + sig * rng.normal(size=(64, 2))
    offset = np.array([57468.5, 4.0])
    scale = np.array([0.5, 2.0])

    s32 = EnsembleSampler(64, 2, logp, seed=3, dtype=jnpp.float32,
                          param_offset=offset, param_scale=scale)
    s32.run_mcmc(p0, 400)
    s32.reset()
    s32.run_mcmc(None, 1200)

    s64 = EnsembleSampler(64, 2, logp, seed=4)
    s64.run_mcmc(p0, 400)
    s64.reset()
    s64.run_mcmc(None, 1200)

    a, b = s32.flatchain, s64.flatchain
    assert a.shape == b.shape
    # absolute values recovered: means within MC error, widths match f64
    for d in range(2):
        assert abs(a[:, d].mean() - mu[d]) < 5 * sig[d] / np.sqrt(200)
        assert 0.9 < a[:, d].std() / b[:, d].std() < 1.1, (d, a[:, d].std(), b[:, d].std())
    # the t_0-like dimension is resolved far below the absolute-f32 ulp (~0.004)
    assert a[:, 0].std() < 3e-4
    assert 0.2 < s32.acceptance_fraction.mean() < 0.9
    assert abs(s32.acceptance_fraction.mean() - s64.acceptance_fraction.mean()) < 0.05


def test_param_rescaled_checkpoint_roundtrip(tmp_path):
    """Checkpoints store the rescaled state + the affine map; resume with a
    different map is rejected; with the same map the chain continues
    exactly."""
    import jax.numpy as jnpp

    def logp(p):
        return -0.5 * jnp.sum((p - 3.0) ** 2)

    offset, scale = np.array([3.0, 3.0]), np.array([2.0, 2.0])
    kw = dict(dtype=jnpp.float32, param_offset=offset, param_scale=scale)
    rng = np.random.default_rng(1)
    p0 = 3.0 + rng.normal(size=(16, 2))

    ref = EnsembleSampler(16, 2, logp, seed=5, **kw)
    ref.run_mcmc(p0, 60)

    s = EnsembleSampler(16, 2, logp, seed=5, **kw)
    s.run_mcmc(p0, 25)
    path = str(tmp_path / "ck.npz")
    s.save_checkpoint(path)

    s2 = EnsembleSampler(16, 2, logp, seed=5, **kw)
    s2.load_checkpoint(path)
    s2.run_mcmc(None, 35)
    np.testing.assert_array_equal(s2.flatchain, ref.flatchain)

    bad = EnsembleSampler(16, 2, logp, seed=5, dtype=jnpp.float32,
                          param_offset=offset + 1.0, param_scale=scale)
    with pytest.raises(ValueError, match="rescaling"):
        bad.load_checkpoint(path)
    plain = EnsembleSampler(16, 2, logp, seed=5)
    with pytest.raises(ValueError, match="rescaling"):
        plain.load_checkpoint(path)


def test_rank_normalized_split_rhat():
    """Vehtari+21 rank-normalized bulk/tail R-hat: ~1 on well-mixed chains
    (even heavy-tailed ones, where plain R-hat is unstable), large on a
    mean-shifted chain, and — the case plain R-hat misses — large when
    chains share a mean but disagree in spread."""
    from lightcurve_fitting_tpu.parallel.diagnostics import (
        split_rhat, rank_normalized_split_rhat)

    rng = np.random.default_rng(0)
    good = rng.normal(size=(1000, 8, 2))
    assert np.all(rank_normalized_split_rhat(good) < 1.01)

    # heavy tails: well-mixed Cauchy draws must not read as unconverged
    cauchy = rng.standard_cauchy(size=(1000, 8, 1))
    assert rank_normalized_split_rhat(cauchy)[0] < 1.01

    shifted = good.copy()
    shifted[:, :4, 0] += 4.0
    assert rank_normalized_split_rhat(shifted)[0] > 1.5

    # same mean, different variances: plain R-hat is blind (W dominated by
    # the wide chains covers B), the folded/tail variant fires
    scales = np.concatenate([rng.normal(0, 1, (1000, 4, 1)),
                             rng.normal(0, 20, (1000, 4, 1))], axis=1)
    assert split_rhat(scales)[0] < 1.05
    assert rank_normalized_split_rhat(scales)[0] > 1.1


def test_ess_constant_parameter_is_finite():
    """Round-5 review fix: a zero-variance (pinned) parameter gets
    ESS = n*m, not NaN from 0/0; a single pinned chain among varying ones
    is excluded from the ACF average instead of poisoning it."""
    from lightcurve_fitting_tpu.parallel.diagnostics import effective_sample_size

    rng = np.random.default_rng(0)
    chain = rng.normal(size=(200, 4, 2))
    chain[:, :, 1] = 3.0                     # fully pinned parameter
    ess = effective_sample_size(chain)
    assert np.all(np.isfinite(ess))
    assert ess[1] == 200 * 4
    chain[:, 0, 0] = -1.0                    # one pinned chain, others vary
    ess = effective_sample_size(chain)
    assert np.all(np.isfinite(ess)) and ess[0] > 0


def test_host_sampler_requires_initial_state():
    """Round-5 review fix: HostEnsembleSampler.run_mcmc(None) before any run
    raises the jitted sampler's clear ValueError, not AttributeError."""
    from lightcurve_fitting_tpu.parallel.host_sampler import HostEnsembleSampler

    s = HostEnsembleSampler(4, 2, lambda p: -float(np.sum(p ** 2)))
    with pytest.raises(ValueError, match="initial_state"):
        s.run_mcmc(None, 5)


@pytest.mark.parametrize("n_other", [2, 16, 32, 128, 129, 512])
def test_partner_pick_returns_exact_rows(n_other):
    """The stretch-move pivot is an exact row of the complementary pool, bit
    for bit, at every pool size (a rounded one-hot product would give a
    point near a walker, breaking detailed balance), and it is the row the
    partner index names."""
    import jax
    import jax.random as jr
    from lightcurve_fitting_tpu.parallel.sampler import pick_partners

    x_other = (jr.normal(jr.PRNGKey(n_other), (n_other, 4), jnp.float32)
               * jnp.asarray([1.0, 1e-3, 1e3, 1.0], jnp.float32))
    key = jr.PRNGKey(7)
    got = np.asarray(jax.jit(pick_partners, static_argnums=1)(key, 64, x_other))
    j = np.asarray(jr.randint(key, (64,), 0, n_other))
    np.testing.assert_array_equal(got, np.asarray(x_other)[j])
    assert got.dtype == np.float32


def test_partner_pick_depends_on_pool_only():
    """One partner-pick path for every backend: nothing in the sampler
    branches on the backend's name."""
    import inspect
    from lightcurve_fitting_tpu.parallel import sampler
    assert "default_backend" not in inspect.getsource(sampler)
