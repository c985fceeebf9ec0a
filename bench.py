#!/usr/bin/env python
"""Headline benchmark: log-likelihood evaluations/second on one chip.

Workload: the reference's flagship fit — ShockCooling2 on the SN 2016bkv early
light curve (149 photometry points, 9 bands, Chebyshev band-integral tables) —
run as the framework's production configuration: jit-compiled stretch-move
ensemble MCMC, whole chain in one lax.scan, float32 hot path with float64
time/parameter arithmetic. Headline at 131072 walkers (population scale:
128 transients' worth of reference-default ensembles; throughput saturates
here); detail records 32768 walkers, the reference-default scale (1024
walkers, alone and replica-batched), the bolometric/population/evidence
pipelines, and native host binning.

Baseline: the reference performs these evaluations serially in Python
(~2e5 evals for a default fit; no published throughput numbers — BASELINE.md).
``vs_baseline`` reports value / 1e7 (BASELINE.json's target).

Architecture: the parent process is an orchestrator that never imports jax,
so exactly one process at a time holds the accelerator. Every measurement
(including the headline) runs in a subprocess with its own wall-clock
deadline, inside a total budget (``LCF_BENCH_BUDGET_S``, default 1800 s);
sections that no longer fit are skipped and recorded under
``"truncated"``. The headline runs first and is staged the moment it
returns; ``atexit`` + SIGTERM/SIGINT/SIGALRM handlers guarantee exactly one
JSON line on stdout however the run ends. If the full-scale headline fails,
the orchestrator degrades to the smaller scales rather than report nothing.

A section refuses to measure on the CPU: every number it reports comes from
the accelerator named in ``detail.device``. Test hooks
(tests/test_bench_harness.py exercises the orchestrator on the CPU):
``LCF_BENCH_ALLOW_CPU=1`` lets sections run on a CPU backend;
``LCF_BENCH_SMOKE=1`` shrinks every section to smoke scale. The platform is
chosen by ``JAX_PLATFORMS`` as usual.

Prints exactly one JSON line on stdout; progress goes to stderr.
"""

import argparse
import atexit
import json
import os
import signal
import subprocess
import sys
import time

# numpy is imported lazily inside the section functions: the orchestrator
# parent must reach its signal-handler registration as fast as the
# interpreter allows (a SIGTERM landing before registration kills any
# Python program silently — keep that window to bare startup)

BASELINE = 1e7  # north-star target (BASELINE.json)
SMOKE = os.environ.get("LCF_BENCH_SMOKE", "") == "1"
ALLOW_CPU = os.environ.get("LCF_BENCH_ALLOW_CPU", "") == "1"


# ---------------------------------------------------------------------------
# measurement sections — each runs in its OWN subprocess (bench.py --section
# NAME --out FILE) with a parent-enforced deadline, and returns a plain dict
# ---------------------------------------------------------------------------


def _bench_host_binning():
    """Ingestion-side benchmark: greedy inverse-variance binning, native C++
    kernel vs the numpy fallback, rows/s (the native kernel's reason to
    exist)."""
    import numpy as np
    from lightcurve_fitting_tpu.utils import native
    from lightcurve_fitting_tpu import lightcurve as lcmod

    rng = np.random.default_rng(0)
    n = 20_000 if SMOKE else 200_000
    t = np.sort(rng.uniform(0, 2000.0, n))        # ~100 rows/night at delta=1
    f = rng.normal(1.0, 0.1, n)
    df = rng.uniform(0.05, 0.2, n)
    bad = np.zeros(n, bool)

    if not native.available():
        return {"native_available": False}
    t0 = time.perf_counter()
    out = native.binflux_native(t, f, df, bad, 1.0)
    native_s = time.perf_counter() - t0

    # numpy fallback (the reference algorithm) on a subset, extrapolated
    n_np = min(n, 20_000)
    tt, ff, dd = (np.ma.MaskedArray(a[:n_np]) for a in (t, f, df))
    t0 = time.perf_counter()
    groups = lcmod._seeded_groups(tt, 1.0)
    [lcmod._merge_bin(tt[i], ff[i], dd[i], True) for i in groups]
    numpy_s = (time.perf_counter() - t0) * (n / n_np)  # linear-ish in rows here

    return {"native_available": True, "rows": n, "nbins": len(out[0]),
            "native_rows_per_sec": n / native_s,
            "numpy_rows_per_sec_est": n / numpy_s,
            "native_speedup": numpy_s / native_s}


def _bench_bolometric(E=256, nwalkers=32, burnin_steps=200, steps=100):
    """Bolometric-pipeline throughput: E blackbody epochs fit concurrently
    (batched MAP centering + batched per-epoch ensembles + on-device posterior
    summaries, the calculate_bolometric(batch_mode=True, save_corners=False)
    device path — chains never reach the host; only the (E, 4, 3) summary
    percentiles do). Metric: epochs/s end-to-end (centering + MCMC +
    summaries; the reference fits epochs serially, ~3e3 emcee evals each,
    bolometric.py:648-671)."""
    import numpy as np
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.filters import filtdict
    from lightcurve_fitting_tpu.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu.models import UniformPrior, LogUniformPrior
    from lightcurve_fitting_tpu.models.blackbody import planck_lnu
    from lightcurve_fitting_tpu.parallel.batched import (pack_epochs,
                                                         batched_blackbody_mcmc,
                                                         batched_map_centers)
    from lightcurve_fitting_tpu.utils.table import Table

    if SMOKE:
        E, nwalkers, burnin_steps, steps = 8, 8, 4, 4
    rng = np.random.default_rng(0)
    filts = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filts)
    epochs = []
    for e in range(E):
        T = rng.uniform(4.0, 20.0)
        R = rng.uniform(1.0, 30.0)
        nodes = bank.emitted_nodes(0.0)
        lnu = np.asarray(planck_lnu(jnp.asarray(nodes), T, R))
        y = (bank.weights * lnu).sum(-1)
        dy = 0.05 * np.abs(y)
        y = y + rng.normal(scale=dy)
        epochs.append(Table([filts, y, dy], names=["filter", "lum", "dlum"]))
    priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]

    packed = pack_epochs(epochs, bank, 0.0)
    from lightcurve_fitting_tpu.bolometric import _pseudo_grid
    summaries = {"z": 0.0, "pseudo_nu": _pseudo_grid()}

    def run(seed):
        centers = batched_map_centers(packed, priors, seed=seed)
        guesses = rng.normal(size=(E, nwalkers, 2)) * 0.5 + centers[:, None, :]
        guesses[guesses <= 0.0] = 1.0
        flat, acc, summ = batched_blackbody_mcmc(packed, priors, guesses, nwalkers,
                                                 burnin_steps, steps, seed=seed,
                                                 summaries=summaries,
                                                 return_chains=False)
        return float(np.asarray(summ).mean())  # forced host transfer

    run(0)  # compile both kernels
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        run(1 + i)
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    return {"epochs": E, "nwalkers": nwalkers, "steps": burnin_steps + steps,
            "elapsed_s": elapsed, "epochs_per_sec": E / elapsed}


def _flagship_early_lc():
    """SN 2016bkv early light curve with luminosities, quietly."""
    from __graft_entry__ import flagship_lc
    return flagship_lc()[1]


def _bench_evidence(nwalkers=4096, n_rungs=16, nsteps=150, nsteps_burnin=150):
    """Tempered-ladder throughput: stepping-stone evidence on the flagship
    fit, whole K-rung ladder in one compiled kernel (lightcurve_evidence;
    un-checkpointed fast path — the stepping-stone reduction runs on device
    and the (nsteps, K, nwalkers) logl array never reaches the host).
    Metric: ladder log-likelihood evals/s = K*nwalkers*steps/elapsed with
    K = n_rungs+1 (make_beta_ladder includes both the beta=0 prior rung and
    beta=1, and every rung evaluates the likelihood each step); repeat calls
    hit the compiled-kernel cache."""
    import numpy as np
    from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior
    from lightcurve_fitting_tpu.fitting import lightcurve_evidence

    if SMOKE:
        nwalkers, n_rungs, nsteps, nsteps_burnin = 16, 3, 4, 4
    early = _flagship_early_lc()
    model = ShockCooling2(early)
    priors = [UniformPrior(0.0, 100.0)] * 3 + [UniformPrior(57468.0, 57468.7)]
    kw = dict(p_lo=[20.0, 2.0, 20.0, 57468.5], p_up=[50.0, 5.0, 50.0, 57468.7],
              nwalkers=nwalkers, n_rungs=n_rungs, nsteps=nsteps,
              nsteps_burnin=nsteps_burnin, quiet=True)

    def go(seed):
        import contextlib
        import io
        with contextlib.redirect_stdout(io.StringIO()):
            # each driver call re-derives the lum column (reference-parity,
            # fitting.py:68-72) and prints the extinction notes
            log_z, err, _ = lightcurve_evidence(early, model, priors,
                                                seed=seed, **kw)
        return log_z, err  # floats: the host transfer already happened

    go(0)  # compile (cached for the repeats via the ladder-kernel cache)
    times, zs = [], []
    for i in range(2):
        t0 = time.perf_counter()
        zs.append(go(1 + i))
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    evals = (n_rungs + 1) * nwalkers * (nsteps + nsteps_burnin)
    return {"n_rungs": n_rungs, "nwalkers": nwalkers,
            "steps": nsteps + nsteps_burnin, "elapsed_s": elapsed,
            "evals_per_sec": evals / elapsed, "log_z": zs[-1][0],
            "log_z_err": zs[-1][1]}


def _bench_population(S=64, nwalkers=64, nsteps=1000, nsteps_burnin=100):
    """Population-fitting throughput: S ShockCooling2 transients, each with
    its own ensemble, in one device call (fit_population(summaries=True,
    return_chains=False) — per-transient percentiles computed on device; the
    (S, nsteps*nwalkers, ndim) chains never transfer).

    Run at TWO scales: the reference-comparison point S=64
    (4096 total walkers — per-scan-iteration floor territory) and survey
    scale S=512 (32768 total walkers — the throughput-asymptote regime the
    framework exists for vs the reference's serial per-object loop,
    reference bolometric.py:735)."""
    import numpy as np
    from lightcurve_fitting_tpu.models import UniformPrior
    from lightcurve_fitting_tpu.parallel.population import fit_population
    from __graft_entry__ import flagship_population

    if SMOKE:
        S, nwalkers, nsteps, nsteps_burnin = 4, 8, 4, 4
    lcs, models = flagship_population(S)
    priors = [UniformPrior(0.0, 100.0)] * 3 + [UniformPrior(57468.0, 57468.7)]
    kw = dict(p_lo=[20.0, 2.0, 20.0, 57468.5], p_up=[50.0, 5.0, 50.0, 57468.7],
              nwalkers=nwalkers, nsteps=nsteps, nsteps_burnin=nsteps_burnin,
              summaries=True, return_chains=False)

    def go(seed):
        _, _, summ = fit_population(models, lcs, priors, seed=seed, **kw)
        return float(np.asarray(summ).mean())  # forced host transfer

    go(0)  # compile
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        go(1 + i)
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    evals = S * nwalkers * (nsteps + nsteps_burnin)
    return {"transients": S, "nwalkers": nwalkers,
            "steps": nsteps + nsteps_burnin, "elapsed_s": elapsed,
            "transients_per_sec": S / elapsed, "evals_per_sec": evals / elapsed}


def _measure_ensemble(nwalkers, nsteps, repeats=2, replicas=1):
    """One headline-style throughput measurement: the production sampler
    configuration (lightcurve_mcmc state_dtype="auto" on accelerators) —
    float32 walker state over the affine-rescaled init window (the absolute
    f32 state would quantize t_0 at ~6 min) + f32 chain storage (halves the
    per-step chain write and the host transfer)."""
    import numpy as np
    import contextlib
    import io
    import jax
    import jax.numpy as jnp
    import jax.random as jr
    from lightcurve_fitting_tpu.core import config
    from lightcurve_fitting_tpu.parallel.sampler import EnsembleSampler

    config.set_compute_dtype(jnp.float32)
    from __graft_entry__ import _build_logposterior
    with contextlib.redirect_stdout(io.StringIO()):
        logpost, _ = _build_logposterior()

    lo = np.array([20.0, 2.0, 20.0, 57468.5])
    up = np.array([50.0, 5.0, 50.0, 57468.7])
    offset = (lo + up) / 2.0
    scale = (up - lo) / 2.0

    sampler = EnsembleSampler(nwalkers, 4, logpost, seed=0, replicas=replicas,
                              store_dtype=np.float32, dtype=jnp.float32,
                              param_offset=offset, param_scale=scale)
    rng = np.random.default_rng(0)
    p0 = rng.uniform(lo, up, size=(sampler.total_walkers, 4))
    shape = sampler._state_shape()
    x = jnp.asarray(((p0 - offset) / scale).reshape(shape), jnp.float32)
    logp = sampler.batched_logp(x.reshape(-1, 4)).reshape(shape[:-1])
    run = sampler._compiled_run(nsteps, 1)

    def step_keys(seed):
        keys = jr.split(jr.PRNGKey(seed), nsteps * replicas)
        return keys.reshape((nsteps, replicas) + keys.shape[1:]) if replicas > 1 else keys

    out = run(x, logp, step_keys(1))  # warmup (compile + one full run)
    jax.block_until_ready(out)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        out = run(x, logp, step_keys(2 + i))
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    return {"nwalkers": nwalkers, "replicas": replicas, "nsteps": nsteps,
            "elapsed_s": elapsed,
            "evals_per_sec": sampler.total_walkers * nsteps / elapsed,
            "acceptance_check": float(np.asarray(out[4]).mean())}


def _roofline(evals_per_sec):
    """Auditable arithmetic for the headline number: FLOP/eval from the live
    flagship quadrature (adaptive Chebyshev degree read off the actual
    table, not assumed) and the achieved FLOP/s it implies. The likelihood
    is elementwise work with no matrix products."""
    import numpy as np
    from lightcurve_fitting_tpu.models import ShockCooling2
    early = _flagship_early_lc()
    model = ShockCooling2(early)
    f = np.asarray(early["filter"])
    quad = model.prepare_quad(f)
    n_points = len(f)
    deg = int(quad["bb_coeffs"].shape[-1]) - 1
    # per point per eval: Clenshaw deg*3 (mul+sub+add per term; trailing
    # zero-pad terms still execute) + ~38 for the SC2 T/L power laws,
    # the table's log/affine/exp wrapper, and the residual
    flops_clenshaw = n_points * 3 * deg
    flops_other_est = n_points * 38
    flops_total = flops_clenshaw + flops_other_est
    return {
        "n_points": n_points,
        "chebyshev_degree": deg,
        "flops_per_eval_clenshaw": flops_clenshaw,
        "flops_per_eval_other_est": flops_other_est,
        "flops_per_eval_total_est": flops_total,
        "achieved_tflops_est": evals_per_sec * flops_total / 1e12,
        "formula": "evals/s x n_points x (3*deg + 38) flops; "
                   "deg read from the live adaptive band table",
    }


def _section_headline(nwalkers, nsteps=300, replicas=1, with_roofline=False):
    if SMOKE:
        nwalkers, nsteps = max(8, nwalkers // 8192), 4
    out = _measure_ensemble(nwalkers, nsteps, replicas=replicas)
    if with_roofline:
        out["roofline"] = _roofline(out["evals_per_sec"])
    return out


SECTIONS = {
    # name -> (runner, wall-clock cap in seconds at full scale). Caps cover
    # a cold compile; the persistent cache amortizes compiles across
    # sections and reruns. The budget logic shrinks these near the deadline,
    # so generous caps cost nothing when warm.
    "headline131k": (lambda: _section_headline(131072, with_roofline=True), 900),
    "headline32k": (lambda: _section_headline(32768), 420),
    "headline1k_rep": (lambda: _section_headline(1024, replicas=32), 420),
    "headline1k": (lambda: _section_headline(1024), 300),
    "binning": (_bench_host_binning, 120),
    "bolometric": (_bench_bolometric, 420),
    "population": (_bench_population, 420),
    "population512": (lambda: _bench_population(S=512), 540),
    "evidence": (_bench_evidence, 420),
}


def _run_section_child(name, out_path):
    """Child-process entry: run one section, write its JSON to out_path."""
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu" and not ALLOW_CPU:
        raise SystemExit("no accelerator: bench.py measures on a GPU only "
                         "(LCF_BENCH_ALLOW_CPU=1 is the CPU test hook)")
    jax.config.update("jax_enable_x64", True)
    from lightcurve_fitting_tpu.core import config
    # all bench subprocesses share the persistent cache, so each kernel is
    # compiled at most once across sections and repeat runs. Timed regions
    # all follow a warmup call, so the cache cannot affect the numbers.
    cache = config.enable_compilation_cache(
        default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".jax_cache"))
    result = SECTIONS[name][0]()
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": jax.device_count()}
    result["compile_cache"] = cache
    with open(out_path, "w") as fh:
        json.dump(result, fh)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


class _Emitter:
    """Stages the result JSON and guarantees exactly one stdout line."""

    def __init__(self):
        self.staged = {
            "metric": "log_likelihood_evals_per_sec_per_chip",
            "value": 0.0, "unit": "evals/s", "vs_baseline": 0.0,
            "error": "benchmark did not complete any headline measurement",
        }
        self.emitted = False
        self.child = None  # current section subprocess, killed on signal

    def emit(self):
        if self.emitted:
            return
        self.emitted = True
        sys.stdout.write(json.dumps(self.staged) + "\n")
        sys.stdout.flush()

    def on_signal(self, signum, frame):
        self.staged.setdefault("truncated", []).append(
            f"interrupted by signal {signum}")
        if self.child is not None and self.child.poll() is None:
            try:
                self.child.kill()
            except Exception:
                pass
        self.emit()
        os._exit(0)  # rc 0: the JSON line IS the deliverable


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _run_section(emitter, name, timeout_s):
    """Run one section in a subprocess with a hard deadline. Returns the
    section's result dict, or an {"error": ...} dict on timeout/failure."""
    import tempfile
    fd, out_path = tempfile.mkstemp(prefix=f"lcf_bench_{name}_", suffix=".json")
    os.close(fd)
    t0 = time.time()
    try:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--section", name, "--out", out_path],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        emitter.child = child
        try:
            _, err = child.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate()
            _log(f"section {name} timed out after {timeout_s:.0f}s")
            return {"error": f"timed out after {timeout_s:.0f}s"}
        finally:
            emitter.child = None
        if child.returncode != 0:
            tail = err.decode(errors="replace")[-400:]
            _log(f"section {name} failed rc={child.returncode}: {tail!r}")
            return {"error": f"rc={child.returncode}", "stderr_tail": tail}
        with open(out_path) as fh:
            result = json.load(fh)
        _log(f"section {name} OK in {time.time() - t0:.1f}s")
        return result
    finally:
        try:
            os.unlink(out_path)
        except OSError:
            pass


def main():
    budget = float(os.environ.get("LCF_BENCH_BUDGET_S", "1800"))
    t_start = time.time()
    emitter = _Emitter()
    atexit.register(emitter.emit)
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM,
                signal.SIGHUP):
        signal.signal(sig, emitter.on_signal)
    # absolute backstop: even if the orchestrator itself wedges, the alarm
    # fires inside the budget and the staged JSON still lands on stdout
    signal.alarm(max(10, int(budget)))
    _log("armed")  # handlers registered: a SIGTERM from here on emits JSON

    def remaining():
        return budget - (time.time() - t_start)

    detail = {
        "workload": "ShockCooling2 x SN2016bkv early LC (149 pts, 9 bands), "
                    "jitted stretch-move ensemble, Chebyshev band tables, "
                    "f32 hot path + f64 epochs, affine-rescaled f32 walker "
                    "state, f32 chain store",
        "budget_s": budget,
    }
    truncated = []
    emitter.staged["detail"] = detail
    emitter.staged["truncated"] = truncated

    # headline first, largest scale first; degrade to smaller scales if the
    # full-scale run cannot land inside the budget
    headline_order = [("headline131k", 131072), ("headline32k", 32768),
                      ("headline1k_rep", 1024 * 32), ("headline1k", 1024)]
    detail_key = {"headline131k": None,
                  "headline32k": "evals_per_sec_at_32768_walkers",
                  "headline1k_rep": "evals_per_sec_at_1024_walkers",
                  "headline1k": "evals_per_sec_at_1024_walkers_single_ensemble"}
    have_headline = False
    for name, scale in headline_order:
        cap = SECTIONS[name][1]
        # always leave room for at least one more (possibly smaller) attempt
        timeout_s = min(cap, remaining() - 60.0)
        if timeout_s < 30.0:
            truncated.append(name)
            continue
        res = _run_section(emitter, name, timeout_s)
        if "error" in res:
            truncated.append(f"{name}: {res['error']}")
            continue
        if not have_headline:
            # stage the headline the moment the first (largest) scale lands
            have_headline = True
            emitter.staged["value"] = float(res["evals_per_sec"])
            emitter.staged["vs_baseline"] = float(res["evals_per_sec"] / BASELINE)
            emitter.staged.pop("error", None)
            detail["headline_nwalkers"] = res["nwalkers"]
            detail["headline_replicas"] = res["replicas"]
            detail["nsteps"] = res["nsteps"]
            detail["elapsed_s"] = res["elapsed_s"]
            detail["acceptance_check"] = res["acceptance_check"]
            if "roofline" in res:
                detail["roofline"] = res["roofline"]
            detail["device"] = res["device"]
            detail["compile_cache"] = res["compile_cache"]
            if name != "headline131k":
                detail["headline_note"] = (f"full-scale headline unavailable; "
                                           f"headline is the {name} scale")
        if detail_key[name]:
            detail[detail_key[name]] = float(res["evals_per_sec"])
            if name == "headline1k_rep":
                detail["evals_at_1024_walkers_replicas"] = res["replicas"]

    sub_order = [("binning", "host_binning"),
                 ("bolometric", "bolometric_pipeline"),
                 ("population", "population_pipeline"),
                 ("population512", "population_pipeline_survey_scale"),
                 ("evidence", "evidence_ladder")]
    for name, key in sub_order:
        cap = SECTIONS[name][1]
        timeout_s = min(cap, remaining() - 30.0)
        if timeout_s < 20.0:
            truncated.append(name)
            continue
        res = _run_section(emitter, name, timeout_s)
        if "error" in res:
            truncated.append(f"{name}: {res['error']}")
        else:
            detail[key] = res

    if not truncated:
        emitter.staged.pop("truncated", None)
    emitter.staged["total_elapsed_s"] = time.time() - t_start
    emitter.emit()
    return 0 if have_headline else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--section", choices=sorted(SECTIONS))
    parser.add_argument("--out")
    cli = parser.parse_args()
    if cli.section:
        _run_section_child(cli.section, cli.out)
        sys.exit(0)
    sys.exit(main())
