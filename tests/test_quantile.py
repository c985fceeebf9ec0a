"""ops/quantile.py: sort-free float32 percentiles vs the numpy reference.

The counting-bisection path must reproduce np.percentile of the same data
(cast to float64 for interpolation) to float64 round-off, because the
population summaries it powers are compared against host percentiles of
the returned chains (test_population.py)."""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from lightcurve_fitting_tpu.ops.quantile import percentile_f32

Q = [16.0, 50.0, 84.0]


def _check(a_f32, q=Q, axis=-1, rtol=0.0, atol=5e-13):
    got = np.asarray(percentile_f32(jnp.asarray(a_f32), q, axis=axis))
    want = np.percentile(a_f32.astype(np.float64), q, axis=axis)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_matches_numpy_on_random_batches():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((7, 501, 3)) * 10).astype(np.float32)
    _check(a, axis=1)
    _check(a, axis=-1)
    _check(a, axis=0)


def test_negative_zero_duplicates_and_ties():
    a = np.array([[-0.0, 0.0, 0.0, -0.0, 1.0, -1.0, 1.0, 1.0]],
                 np.float32)
    _check(a, q=[0.0, 10.0, 25.0, 50.0, 75.0, 100.0])
    # all-equal column: every percentile is that value
    b = np.full((4, 9), 3.25, np.float32)
    _check(b)


def test_extreme_magnitudes():
    """Full supported magnitude range (package contract: ~[1.2e-38, 3e38];
    sub-normals below that rank correctly but may flush in interpolation —
    documented in ops/quantile.py)."""
    a = np.array([1.5e-38, -1e38, 5e-30, 3e38, -2.5e-20, 0.0, -7e37, 1.0],
                 np.float32).reshape(1, -1)
    got = np.asarray(percentile_f32(jnp.asarray(a),
                                    [5.0, 16.0, 50.0, 84.0, 95.0]))
    want = np.percentile(a.astype(np.float64),
                         [5.0, 16.0, 50.0, 84.0, 95.0], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0)


def test_denormals_rank_correctly():
    """Sub-normal float32 bit patterns are ordered exactly by the int32 key
    (the flush is only in the final float64 interpolation)."""
    from lightcurve_fitting_tpu.ops.quantile import _sortable_key
    a = np.array([5e-39, -2.5e-40, 1e-38, -1e-44, 0.0, 1.18e-38],
                 np.float32)
    k = np.asarray(_sortable_key(jnp.asarray(a)))
    assert np.array_equal(np.argsort(k, kind="stable"),
                          np.argsort(a.astype(np.float64), kind="stable"))


def test_infinities_take_order_statistic_positions():
    a = np.array([np.inf, -np.inf, 1.0, 2.0, -np.inf, np.inf, 0.5],
                 np.float32).reshape(1, -1)
    # exact-rank quantiles (frac == 0 for N=7 at these q) avoid inf-inf
    # interpolation, which numpy also leaves to the order statistics
    got = np.asarray(percentile_f32(jnp.asarray(a), [0.0, 50.0, 100.0]))
    want = np.percentile(a.astype(np.float64), [0.0, 50.0, 100.0], axis=-1)
    np.testing.assert_array_equal(got, want)


def test_single_element_and_two_elements():
    _check(np.array([[42.5]], np.float32), q=[0.0, 37.0, 100.0])
    _check(np.array([[2.0, 1.0]], np.float32), q=[0.0, 25.0, 50.0, 100.0])


def test_empty_axis_returns_nan():
    out = np.asarray(percentile_f32(jnp.zeros((3, 0), jnp.float32), Q))
    assert out.shape == (3, 3) and np.all(np.isnan(out))


def test_non_f32_falls_back_to_jnp_percentile():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 101))
    got = np.asarray(percentile_f32(jnp.asarray(a), Q, axis=1))
    want = np.percentile(a, Q, axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_population_summary_shape_convention():
    """The population fast path relies on (len(q),) + batch ordering."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 400, 4)).astype(np.float32)
    out = np.asarray(percentile_f32(jnp.asarray(a), Q, axis=1))
    assert out.shape == (3, 6, 4)
    want = np.percentile(a.astype(np.float64), Q, axis=1)
    np.testing.assert_allclose(out, want, atol=5e-13)


def test_compiles_once_per_shape():
    """Repeat calls at one (shape, q, axis) reuse one executable, whatever
    form q and axis take: called un-jitted, the 32-pass loop was compiled
    again on every call, which cost more than the search itself."""
    from lightcurve_fitting_tpu.ops import quantile
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 50, 2)).astype(np.float32)
    percentile_f32(jnp.asarray(a), Q, axis=1)
    n = quantile._bisect._cache_size()
    for q, axis in ((Q, 1), (np.asarray(Q), -2), (tuple(Q), 1)):
        b = rng.standard_normal(a.shape).astype(np.float32)
        _check(b, q=q, axis=axis)
    assert quantile._bisect._cache_size() == n


def test_population_summary_ab_probe_at_tiny_size(capsys):
    """tools/population_summary_ab.py times fit_population with each
    percentile path; at a tiny size on the CPU every arm runs and the
    bisection and sort summaries agree to float32 rounding."""
    import json
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import population_summary_ab
    rc = population_summary_ab.main(["--S", "2", "--nwalkers", "8", "--nsteps", "6",
                                     "--nsteps-burnin", "4", "--rounds", "1",
                                     "--reps", "1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["end_to_end"]) == {"bisection", "eager", "sort", "none"}
    assert all(v["n"] == 2 for v in out["end_to_end"].values())
    assert set(out["alone"]) == {"bisection", "eager", "sort"}
    assert out["max_summary_diff"] < 1e-4
