"""The benchmark must be incapable of recording nothing.

The orchestrator runs each section in a subprocess with a wall-clock cap,
stages the headline JSON the moment it lands, and guarantees exactly one
stdout JSON line via atexit + SIGTERM/SIGALRM handlers. These tests exercise
that guarantee on the CPU platform at smoke scale:

- a normal run emits exactly one parseable JSON line with a nonzero headline
  and names the device it ran on;
- a run SIGTERMed mid-flight (what ``timeout`` does) still emits exactly one
  parseable JSON line;
- an impossibly small budget produces the honest truncation JSON, not
  silence.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "bench.py")


def _env(budget="300"):
    env = dict(os.environ)
    env.update(LCF_BENCH_SMOKE="1", LCF_BENCH_ALLOW_CPU="1",
               JAX_PLATFORMS="cpu", LCF_BENCH_BUDGET_S=budget)
    return env


def _parse_single_json_line(stdout):
    lines = [l for l in stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, f"expected exactly one stdout line, got {lines!r}"
    return json.loads(lines[0])


def test_smoke_run_emits_one_json_line():
    r = subprocess.run([sys.executable, BENCH], env=_env(), timeout=280,
                       capture_output=True, text=True)
    out = _parse_single_json_line(r.stdout)
    assert r.returncode == 0, r.stderr[-2000:]
    assert out["metric"] == "log_likelihood_evals_per_sec_per_chip"
    assert out["unit"] == "evals/s"
    assert out["value"] > 0.0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 1e7)
    assert out["detail"]["acceptance_check"] >= 0.0
    # the headline must come from the FULL-scale section, not a silent
    # degradation (regression: a NameError in the roofline arithmetic made
    # headline131k fail while the 32k fallback kept value > 0)
    assert "headline_note" not in out["detail"], out
    assert "roofline" in out["detail"], out
    assert not any(t.startswith("headline131k") for t in out.get("truncated", [])), out
    assert out["detail"]["device"]["platform"] == "cpu"
    assert out["detail"]["device"]["count"] >= 1
    # the compile cache is where JAX_COMPILATION_CACHE_DIR says (the test
    # session sets it; tests/conftest.py)
    assert out["detail"]["compile_cache"] == os.environ["JAX_COMPILATION_CACHE_DIR"]


def test_sigterm_mid_run_still_emits_json():
    """``timeout`` kills bench with SIGTERM; a JSON line must land anyway."""
    proc = subprocess.Popen([sys.executable, BENCH], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    # wait for handler registration (bench logs "armed" right after it;
    # interpreter startup on a loaded box can take seconds, and a SIGTERM
    # before registration kills any Python program silently)
    line = proc.stderr.readline()
    assert "armed" in line, line
    time.sleep(1.0)  # into early-section territory
    proc.send_signal(signal.SIGTERM)
    stdout, _ = proc.communicate(timeout=60)
    out = _parse_single_json_line(stdout)
    assert out["metric"] == "log_likelihood_evals_per_sec_per_chip"
    assert "value" in out and "vs_baseline" in out
    # killed before any measurement: the staged skeleton reports the
    # interruption honestly
    assert any("signal" in t for t in out.get("truncated", [])) or out["value"] > 0


def test_tiny_budget_reports_truncation_not_silence():
    r = subprocess.run([sys.executable, BENCH], env=_env(budget="12"),
                       timeout=120, capture_output=True, text=True)
    out = _parse_single_json_line(r.stdout)
    # nothing could run: value 0 with an error note and a truncated list
    # naming the skipped sections
    assert out["metric"] == "log_likelihood_evals_per_sec_per_chip"
    assert ("error" in out) or out.get("truncated")
