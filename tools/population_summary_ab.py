#!/usr/bin/env python
"""A/B of the population summary percentiles, end to end, in one process.

``fit_population(summaries=True, return_chains=False)`` reduces each
transient's chains to 16/50/84th percentiles on device with
``ops.quantile.percentile_f32`` (counting bisection). This script times

* the whole call with that function ("bisection"),
* the whole call with the same bisection called un-jitted, as it was
  before ``percentile_f32`` was jitted ("eager": its loop is traced and
  compiled again on every call),
* the whole call with ``jnp.percentile`` swapped in ("sort"),
* the same call with a percentile that returns zeros without reading the
  chains ("none": the fit alone),

interleaved (each arm once, then in reverse order, per round) after
one warm-up call each, and then each percentile function alone, called the
way ``fit_population`` calls it, on the float32 walker-state chains of the
same population. All of it on the first device, at the S=512 population of
``bench.py`` and ``chip_smoke.py`` by default.

Run::

    python tools/population_summary_ab.py
    python tools/population_summary_ab.py --S 4 --nwalkers 8 --nsteps 10 \\
        --nsteps-burnin 5 --rounds 1 --reps 2          # tiny, for the CPU

The last line of stdout is one JSON object with every timing in seconds.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
Q = [16.0, 50.0, 84.0]


def _card():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def _stats(ts):
    return {"median": float(np.median(ts)), "min": float(np.min(ts)),
            "max": float(np.max(ts)), "n": len(ts), "runs": [float(t) for t in ts]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--nwalkers", type=int, default=64)
    ap.add_argument("--nsteps", type=int, default=1000)
    ap.add_argument("--nsteps-burnin", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.ops import quantile
    from lightcurve_fitting_tpu.fitting import _state_rescaling
    from lightcurve_fitting_tpu.parallel.population import fit_population
    from __graft_entry__ import flagship_population, flagship_priors, P_LO, P_UP

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}, jax {jax.__version__}; "
          f"card: {_card()}; host: {os.cpu_count()} cores, {platform.processor() or platform.machine()}",
          flush=True)

    bisection = quantile.percentile_f32

    def sort(a, q, axis=-1):
        return jnp.percentile(a, jnp.asarray(q, a.dtype), axis=axis)

    def eager(a, q, axis=-1):
        return quantile._bisect_impl(a, tuple(q), axis % a.ndim)

    def none(a, q, axis=-1):
        return jnp.zeros((len(q),) + tuple(np.delete(a.shape, axis)), a.dtype)

    lcs, models = flagship_population(args.S)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=args.nwalkers, nsteps=args.nsteps,
              nsteps_burnin=args.nsteps_burnin, summaries=True,
              state_dtype=np.float32)  # what "auto" is on a GPU, also on the CPU

    def call(path, seed):
        """One timed fit_population call; returns (seconds, summaries)."""
        quantile.percentile_f32 = {"bisection": bisection, "eager": eager,
                                   "sort": sort, "none": none}[path]
        try:
            t0 = time.perf_counter()
            _, _, summ = fit_population(models, lcs, flagship_priors(), seed=seed,
                                        return_chains=False, **kw)
            return time.perf_counter() - t0, summ
        finally:
            quantile.percentile_f32 = bisection

    paths = ("bisection", "eager", "sort", "none")
    first = {p: call(p, 0)[0] for p in paths}          # compiles
    walls = {p: [] for p in paths}
    summ = {}
    seed = 1
    for _ in range(args.rounds):
        for p in paths + paths[::-1]:
            t, s = call(p, seed)
            walls[p].append(t)
            seed += 1
    # same seed for both summaries, so their values can be compared
    _, summ["bisection"] = call("bisection", 0)
    _, summ["sort"] = call("sort", 0)
    dsumm = float(np.max(np.abs(summ["bisection"] - summ["sort"])))
    for p in paths:
        st = _stats(walls[p])
        print(f"[end-to-end] {p}: median {st['median']:.4f} s, min {st['min']:.4f} s, "
              f"max {st['max']:.4f} s over {st['n']} warm calls (first {first[p]:.2f} s)",
              flush=True)
    print(f"[end-to-end] max |bisection - sort| of the summaries: {dsumm:.3e}", flush=True)

    # each percentile alone, on this population's float32 walker-state chains
    flat, _, _ = fit_population(models, lcs, flagship_priors(), seed=0,
                                return_chains=True, **kw)
    st = _state_rescaling(np.float32, P_LO, P_UP)
    fl = jnp.asarray(((flat - st["param_offset"]) / st["param_scale"]).astype(np.float32))
    alone = {}
    for name, fn in (("bisection", bisection), ("eager", eager), ("sort", sort)):
        jax.block_until_ready(fn(fl, Q, axis=1))
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(fl, Q, axis=1))
            ts.append(time.perf_counter() - t0)
        alone[name] = _stats(ts)
        print(f"[alone] {name} on {tuple(fl.shape)} float32, axis 1: median "
              f"{alone[name]['median'] * 1e3:.3f} ms, min {alone[name]['min'] * 1e3:.3f} ms "
              f"over {args.reps} warm calls", flush=True)

    print(json.dumps({"device": dev.device_kind, "card": _card(), "S": args.S,
                      "first": first, "end_to_end": {p: _stats(w) for p, w in walls.items()},
                      "alone": alone, "max_summary_diff": dsumm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
