#!/usr/bin/env python
"""Smoke test of the library's main fitting paths on a GPU.

Everything runs in ONE process (a second JAX process would find the card's
memory already reserved). Each phase drives a public entry point on the
first GPU at the sizes users run, and checks the result against the
float64 CPU reference computed in the same process, or against the
published posterior of the flagship fit (VALIDATION.md):

1. device      — platform, device kind and count, JAX version, the card's
                 name and power limit, and which way each float32-on-
                 accelerator branch resolves;
2. likelihood  — the flagship log-posterior (ShockCooling2 on SN 2016bkv)
                 over 131,072 draws on the card, vmapped in batches of
                 16,384 (float32 hot path)
                 against the float64 CPU evaluation, held to the
                 1e-5 * |ll| band-table parity budget (docs/design.md);
3. flagship    — ``lightcurve_mcmc`` at the reference defaults (100 walkers,
                 1000 + 1000 steps); pooled medians within 3 sigma of truth;
4. population  — ``fit_population`` at S=512 x 64 walkers x 1100 steps with
                 device summaries, and at S=8 against ``np.percentile`` of
                 the returned chains;
5. bolometric  — ``calculate_bolometric(batch_mode=True)`` on the card and
                 on the CPU; per-epoch T and R medians within 2 combined
                 posterior sigma.

``--four-cards`` runs only the multi-card phase: the automatically
walker-sharded ``lightcurve_mcmc`` against ``shard=False``, and the
transient-sharded ``fit_population`` at S=512 against the one-card run.

Run::

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards

The last line of stdout is one JSON object, ``{"ok": true, "device":
{...}}``, printed only when every phase passed. Without a GPU the script
exits non-zero after the device phase and prints no result.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
Q = [16.0, 50.0, 84.0]


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _quiet():
    """The fit drivers print reference-parity notes; keep phase lines clean."""
    return contextlib.redirect_stdout(io.StringIO())


def _card_name_and_power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return (r.stdout.strip() or r.stderr.strip()).replace("\n", "; ")


def phase_device():
    """Report the device, enable the compile cache, and print which way each
    float32-on-accelerator branch resolves here."""
    import jax
    from lightcurve_fitting_tpu.core import config
    from lightcurve_fitting_tpu.fitting import _state_rescaling
    from lightcurve_fitting_tpu.parallel.batched import _epoch_state_is_f32

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__}
    _log("device", json.dumps(info))
    _log("device", f"nvidia-smi name, power.limit: {_card_name_and_power_limit()}")
    cache = config.enable_compilation_cache(default=os.path.join(REPO, ".jax_cache"))
    _log("device", f"compile cache: {cache}")
    dt = config.get_compute_dtype()
    state = _state_rescaling("auto", [0.0], [1.0])
    _log("device", "float32 branches: core.config compute dtype -> "
         f"{'ambient (float64)' if dt is None else np.dtype(dt).name}; "
         f"lightcurve_mcmc/fit_population walker state -> "
         f"{'float32 rescaled' if state else 'float64 absolute'}; "
         f"batched epoch walker state -> "
         f"{'float32' if _epoch_state_is_f32() else 'float64'}")
    return info


def phase_likelihood(n_draws=131072, batch=16384, seed=0):
    """Device log-posterior (production compute dtype) vs the float64 CPU
    evaluation of the same function on the same draws. The device vmaps in
    batches: XLA's GPU compile time of the vmapped log-posterior grows
    faster than the batch (9 s at 16,384 rows, 128 s at 65,536, 766 s at
    131,072 on an H100; PERF.md)."""
    import jax
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.core import config
    from __graft_entry__ import _build_logposterior, P_LO, P_UP

    p = np.random.default_rng(seed).uniform(P_LO, P_UP, size=(n_draws, 4))
    config.set_compute_dtype(config.AUTO)
    with _quiet():
        logpost, _ = _build_logposterior()
    t0 = time.perf_counter()
    batched = jax.jit(lambda x: jax.lax.map(logpost, x, batch_size=min(batch, n_draws)))
    ll = np.asarray(batched(jnp.asarray(p)))
    t_dev = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    config.set_compute_dtype(None)
    try:
        with jax.default_device(cpu), _quiet():
            logpost_ref, _ = _build_logposterior()
            ll_ref = np.asarray(jax.jit(jax.vmap(logpost_ref))(jax.device_put(p, cpu)))
    finally:
        config.set_compute_dtype(config.AUTO)
    ok = np.isfinite(ll_ref)
    assert ok.all(), f"{(~ok).sum()} reference draws non-finite"
    assert np.isfinite(ll).all(), f"{(~np.isfinite(ll)).sum()} device draws non-finite"
    diff = np.abs(ll - ll_ref)
    rel = diff / np.abs(ll_ref)
    over = int(np.sum(diff > np.maximum(1e-3, 1e-5 * np.abs(ll_ref))))
    _log("likelihood", f"{n_draws} draws, device dtype {ll.dtype}, |dll|/|ll| "
         f"max {rel.max():.3e} median {np.median(rel):.3e}; draws over the "
         f"max(1e-3, 1e-5*|ll|) budget: {over} (device call incl. compile "
         f"{t_dev:.2f} s)")
    assert over == 0, f"{over} draws exceed the parity budget"
    return {"max_rel": float(rel.max()), "median_rel": float(np.median(rel))}


def phase_flagship(nwalkers=100, nsteps=1000, nsteps_burnin=1000, seed=0):
    """lightcurve_mcmc at the reference's defaults, started in the typical
    set; pooled medians within 3 posterior sigma of the published truth."""
    from lightcurve_fitting_tpu.models import ShockCooling2
    from lightcurve_fitting_tpu.fitting import lightcurve_mcmc
    from __graft_entry__ import (flagship_lc, flagship_priors, TYPICAL_LO,
                                 TYPICAL_UP, TRUTH_MED, TRUTH_STD)

    _, lc_early = flagship_lc()
    walls = []
    for _ in range(2):  # the first call compiles
        t0 = time.perf_counter()
        with _quiet():
            s = lightcurve_mcmc(lc_early, ShockCooling2(lc_early),
                                priors=flagship_priors(), p_lo=TYPICAL_LO,
                                p_up=TYPICAL_UP, nwalkers=nwalkers, nsteps=nsteps,
                                nsteps_burnin=nsteps_burnin, seed=seed, quiet=True)
            flat = s.flatchain
        walls.append(time.perf_counter() - t0)
    med = np.median(flat, axis=0)
    z = np.abs(med - TRUTH_MED) / TRUTH_STD
    acc = float(np.mean(s.acceptance_fraction))
    with np.printoptions(precision=5, suppress=True):
        _log("flagship", f"{nwalkers} walkers x ({nsteps_burnin} + {nsteps}) steps: "
             f"medians {med}, |med - truth|/sigma {z}, acceptance {acc:.3f}, "
             f"wall first {walls[0]:.2f} s, second {walls[1]:.2f} s")
    assert np.all(z < 3.0), f"medians off truth by {z} sigma"
    return {"medians": med, "acceptance": acc, "wall_s": walls[1]}


def phase_population(S=512, nwalkers=64, nsteps=1000, nsteps_burnin=100,
                     S_exact=8, seed=0):
    """fit_population with device summaries at survey scale (all finite),
    then at S_exact against host percentiles of the returned chains (equal
    within float32 rounding of the rescaled walker state)."""
    from lightcurve_fitting_tpu.parallel.population import fit_population
    from __graft_entry__ import flagship_population, flagship_priors, P_LO, P_UP

    lcs, models = flagship_population(S, seed)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=nwalkers, nsteps=nsteps,
              nsteps_burnin=nsteps_burnin, summaries=True)
    walls = []
    for i in range(2):  # the first call compiles
        t0 = time.perf_counter()
        _, acc, summ = fit_population(models, lcs, flagship_priors(), seed=seed + i,
                                      return_chains=False, **kw)
        walls.append(time.perf_counter() - t0)
    assert summ.shape == (S, 4, 3), summ.shape
    assert np.isfinite(summ).all() and np.isfinite(acc).all()
    _log("population", f"S={S} x {nwalkers} walkers x ({nsteps_burnin} + {nsteps}) "
         f"steps: summaries finite, mean acceptance {acc.mean():.3f}, wall first "
         f"{walls[0]:.2f} s, second {walls[1]:.2f} s "
         f"({S / walls[1]:.1f} transients/s)")

    flat, _, summ = fit_population(models[:S_exact], lcs[:S_exact], flagship_priors(),
                                   seed=seed, return_chains=True, **kw)
    host = np.moveaxis(np.percentile(flat, Q, axis=1), 0, -1)
    lo, up = np.asarray(P_LO), np.asarray(P_UP)
    mid, half = ((lo + up) / 2)[:, None], ((up - lo) / 2)[:, None]
    # a few float32 ulps of the rescaled state (p - mid) / half
    tol = 4 * np.finfo(np.float32).eps * (np.abs(host - mid) + half)
    err = np.abs(summ - host) / tol
    _log("population", f"S={S_exact}: device summaries vs np.percentile of the "
         f"returned chains: max error {err.max():.3f} of the float32 tolerance")
    assert np.all(err <= 1.0), "device summaries differ from host percentiles"
    return {"wall_s": walls[1], "transients_per_s": S / walls[1]}


def phase_bolometric(nwalkers=10, burnin_steps=200, steps=100, seed=0,
                     mjd_min=57468.0, mjd_max=57485.0):
    """calculate_bolometric(batch_mode=True) on the card and on the CPU
    (float64 compute and float64 walker state): per-epoch T and R medians
    within 2 combined posterior sigma."""
    import jax
    from lightcurve_fitting_tpu.core import config
    from lightcurve_fitting_tpu.bolometric import calculate_bolometric
    from __graft_entry__ import flagship_lc

    lc, _ = flagship_lc()

    def run(state_dtype="auto"):
        with tempfile.TemporaryDirectory() as td, _quiet():
            return calculate_bolometric(lc.where(MJD_min=mjd_min, MJD_max=mjd_max),
                                        outpath=td, nwalkers=nwalkers,
                                        burnin_steps=burnin_steps, steps=steps,
                                        seed=seed, batch_mode=True,
                                        save_corners=False, state_dtype=state_dtype)

    t0 = time.perf_counter()
    t_dev = run()
    wall = time.perf_counter() - t0
    config.set_compute_dtype(None)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            # inside default_device(cpu) jax.default_backend() is still the
            # GPU, so "auto" would pick float32 state: ask for float64
            t_ref = run(np.float64)
    finally:
        config.set_compute_dtype(config.AUTO)

    def col(t, name):
        return np.ma.filled(np.ma.MaskedArray(t[name]).astype(float), np.nan)

    z = []
    for par in ("temp", "radius"):
        med, ref = col(t_dev, f"{par}_mcmc"), col(t_ref, f"{par}_mcmc")
        sig = (col(t_dev, f"d{par}_mcmc0") + col(t_dev, f"d{par}_mcmc1")) / 2
        sig_ref = (col(t_ref, f"d{par}_mcmc0") + col(t_ref, f"d{par}_mcmc1")) / 2
        z.append(np.abs(med - ref) / np.hypot(sig, sig_ref))
    z = np.column_stack(z)
    fitted = np.isfinite(z).all(axis=1)
    agree = fitted & (z < 2.0).all(axis=1)
    _log("bolometric", f"{len(t_dev)} epochs, {fitted.sum()} with MCMC fits; "
         f"{agree.sum()} of {fitted.sum()} agree with the CPU reference within "
         f"2 combined sigma (max {np.nanmax(z):.3f}); wall incl. compile {wall:.2f} s")
    assert len(t_dev) == len(t_ref) and fitted.sum() > 0
    assert agree.sum() == fitted.sum(), "epochs disagree with the CPU reference"
    return {"epochs": int(fitted.sum()), "agree": int(agree.sum())}


def phase_four_cards(n_cards=4, nwalkers=128, S=512, pop_nwalkers=64,
                     nsteps=1000, nsteps_burnin=100, seed=0):
    """The walker-sharded flagship fit (automatic when several devices are
    visible) against shard=False, and the transient-sharded population
    against the one-card run: per-transient medians within 0.5 sigma."""
    import jax
    from lightcurve_fitting_tpu.parallel.mesh import walker_mesh
    from lightcurve_fitting_tpu.parallel.population import fit_population
    from __graft_entry__ import (flagship_lc, flagship_population, flagship_priors,
                                 sharded_equivalence, P_LO, P_UP, TRUTH_STD)

    assert len(jax.devices()) >= n_cards, f"need {n_cards} devices"
    _, lc_early = flagship_lc()
    med_sh, med_1, ratio = sharded_equivalence(lc_early, None, nwalkers)
    with np.printoptions(precision=5, suppress=True):
        _log("four-cards", f"lightcurve_mcmc {nwalkers} walkers sharded over "
             f"{len(jax.devices())} devices: medians {med_sh} vs shard=False "
             f"{med_1} (|d|/sigma {np.abs(med_sh - med_1) / TRUTH_STD} < 1), "
             f"width ratios {ratio} in (0.6, 1.7)")

    lcs, models = flagship_population(S, seed)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=pop_nwalkers, nsteps=nsteps,
              nsteps_burnin=nsteps_burnin, summaries=True, return_chains=False,
              seed=seed)
    out = {}
    for name, mesh in (("one card", None),
                       (f"{n_cards} cards", walker_mesh(n_cards, axis_name="transients"))):
        walls = []
        for _ in range(2):  # the first call compiles
            t0 = time.perf_counter()
            _, _, summ = fit_population(models, lcs, flagship_priors(), mesh=mesh, **kw)
            walls.append(time.perf_counter() - t0)
        out[name] = (summ, walls)
    (s1, w1), (s4, w4) = out.values()
    width = (s1[..., 2] - s1[..., 0]) / 2
    z = np.abs(s4[..., 1] - s1[..., 1]) / width
    agree = (z <= 0.5).all(axis=1)
    _log("four-cards", f"fit_population S={S}: {agree.sum()} of {S} transients' "
         f"medians agree within 0.5 sigma (max {z.max():.3g}); wall one card "
         f"{w1[1]:.2f} s (first {w1[0]:.2f} s), {n_cards} cards {w4[1]:.2f} s "
         f"(first {w4[0]:.2f} s)")
    assert agree.all(), "sharded population disagrees with the one-card run"
    return {"wall_one_s": w1[1], "wall_sharded_s": w4[1]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded phase")
    args = parser.parse_args(argv)

    # the CPU reference runs in this process beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    info = phase_device()
    if info["platform"] != "gpu":
        _log("device", f"FAIL: no GPU (platform {info['platform']!r}); "
             "this smoke test measures the card only")
        return 1
    if args.four_cards:
        if info["count"] < 4:
            _log("device", f"FAIL: --four-cards needs 4 devices, have {info['count']}")
            return 1
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("likelihood", phase_likelihood), ("flagship", phase_flagship),
                  ("population", phase_population), ("bolometric", phase_bolometric)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:  # report every phase, then fail the run
            failed.append(name)
            traceback.print_exc()
            _log(name, f"FAIL after {time.perf_counter() - t0:.1f} s: "
                 f"{type(exc).__name__}: {exc}")
        else:
            _log(name, f"OK in {time.perf_counter() - t0:.1f} s")
    if failed:
        _log("summary", f"FAILED phases: {', '.join(failed)}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
