"""Multi-host scaffolding: jax.distributed wiring + process-local transient
sharding, exercised with two real CPU processes over a localhost coordinator
(SURVEY.md §5: cross-host population fitting across hosts with zero inner
collectives)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lightcurve_fitting_tpu.parallel.distributed import local_shard

REPO = os.path.join(os.path.dirname(__file__), "..")

WORKER = """
import os, sys
proc_id, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
import numpy as np
from lightcurve_fitting_tpu.parallel import distributed
from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior

did_init = distributed.initialize(coordinator_address="127.0.0.1:" + port,
                                  num_processes=nproc, process_id=proc_id)
assert did_init and distributed.is_initialized()
assert jax.process_count() == nproc and jax.process_index() == proc_id

TRUTHS = [(12.0, 2.0, 35.0), (18.0, 3.0, 45.0), (9.0, 1.5, 30.0), (15.0, 2.5, 40.0)]

def make_lc(seed, T1, L1, ttr):
    rng = np.random.default_rng(seed)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    t = np.repeat(np.linspace(1.0, 8.0, 4), len(filters))
    f = np.array(filters * 4)
    y_true = ShockCooling2()(t, f, T1, L1, ttr, 0.0)
    dy = 0.05 * y_true
    return LC([t, f, y_true + rng.normal(scale=dy), dy],
              names=["MJD", "filter", "lum", "dlum"])

lcs = [make_lc(i, *tr) for i, tr in enumerate(TRUTHS)]
models = [ShockCooling2(lc) for lc in lcs]
priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0), UniformPrior(5.0, 100.0)]
mine, (flat, acc) = distributed.fit_population_local_shard(
    models, lcs, priors, p_lo=[5.0, 0.5, 20.0], p_up=[25.0, 5.0, 60.0],
    nwalkers=16, nsteps=120, nsteps_burnin=120, seed=1)
np.savez(os.path.join(outdir, "shard_" + str(proc_id) + ".npz"),
         indices=mine, medians=np.median(np.asarray(flat), axis=1), acc=np.asarray(acc))
print("proc", proc_id, "fit transients", list(mine), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_local_shard_partitions_evenly():
    for n, procs in [(4, 2), (5, 2), (1, 2), (7, 3), (3, 8)]:
        shards = [local_shard(n, pid, procs) for pid in range(procs)]
        combined = np.concatenate(shards)
        assert sorted(combined.tolist()) == list(range(n))
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1


def test_two_process_population_fit(tmp_path):
    """Two jax.distributed processes each fit their transient shard; together
    they cover the population and recover the truths."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=os.path.abspath(REPO)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", str(port),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for pid in range(2)]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out.decode())
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out

    TRUTHS = [(12.0, 2.0, 35.0), (18.0, 3.0, 45.0), (9.0, 1.5, 30.0), (15.0, 2.5, 40.0)]
    covered = {}
    for pid in range(2):
        data = np.load(tmp_path / f"shard_{pid}.npz")
        assert np.all(data["acc"] > 0.1)
        for row, idx in enumerate(data["indices"]):
            covered[int(idx)] = data["medians"][row]
    assert sorted(covered) == [0, 1, 2, 3]
    for i, (T1, L1, ttr) in enumerate(TRUTHS):
        assert covered[i][0] == pytest.approx(T1, rel=0.25), i
        assert covered[i][1] == pytest.approx(L1, rel=0.35), i


GLOBAL_MESH_WORKER = """
import os, sys, hashlib
proc_id, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
import numpy as np
from lightcurve_fitting_tpu.parallel import distributed
from lightcurve_fitting_tpu.parallel.mesh import ShardedEnsembleSampler, walker_mesh
from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior
from lightcurve_fitting_tpu.fitting import lightcurve_mcmc

distributed.initialize(coordinator_address="127.0.0.1:" + port,
                       num_processes=nproc, process_id=proc_id)
assert jax.device_count() == 2 * nproc            # global devices across processes
assert jax.local_device_count() == 2

# synthetic flagship-model light curve (identical on both processes)
rng = np.random.default_rng(0)
filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
t = np.repeat(np.linspace(1.0, 8.0, 5), len(filters))
f = np.array(filters * 5)
y_true = ShockCooling2()(t, f, 14.0, 2.5, 40.0, 0.0)
dy = 0.05 * y_true
lc = LC([t, f, y_true + rng.normal(scale=dy), dy],
        names=["MJD", "filter", "lum", "dlum"])
model = ShockCooling2(lc)
priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0), UniformPrior(5.0, 100.0),
          UniformPrior(-1.0, 0.9)]

# ONE GLOBAL MESH over all 4 devices (2 per process): walkers shard across
# both processes; the stretch move's complementary-half all_gather crosses processes
mesh = walker_mesh()   # all global devices
assert len({{d.process_index for d in mesh.devices.flat}}) == nproc
sampler = lightcurve_mcmc(lc, model, priors=priors,
                          p_lo=[5.0, 0.5, 20.0, -0.5], p_up=[25.0, 5.0, 60.0, 0.5],
                          nwalkers=32, nsteps=150, nsteps_burnin=150,
                          seed=4, mesh=mesh, quiet=True)
assert isinstance(sampler, ShardedEnsembleSampler)
flat = sampler.flatchain
med = np.median(flat, axis=0)
digest = hashlib.sha1(np.ascontiguousarray(flat).tobytes()).hexdigest()
np.savez(os.path.join(outdir, "gm_" + str(proc_id) + ".npz"),
         medians=med, digest=np.array(digest), shape=np.array(flat.shape))
print("proc", proc_id, "medians", med, flush=True)
"""


def test_two_process_global_mesh_walker_sharding(tmp_path):
    """The SURVEY §5 cross-host communication row demonstrated live: two
    jax.distributed processes form ONE global mesh and
    ``lightcurve_mcmc(mesh=global)`` shards the walker axis across both —
    the per-half-step all_gather of the complementary half crosses the
    process boundary. Both processes reconstruct the identical full chain
    (gathered through the coordination service) and recover the truth."""
    worker = tmp_path / "worker_gm.py"
    worker.write_text(GLOBAL_MESH_WORKER.format(repo=os.path.abspath(REPO)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", str(port),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for pid in range(2)]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out.decode())
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out

    d0 = np.load(tmp_path / "gm_0.npz")
    d1 = np.load(tmp_path / "gm_1.npz")
    # both processes hold the same complete chain
    assert str(d0["digest"]) == str(d1["digest"])
    assert tuple(d0["shape"]) == (150 * 32, 4)
    np.testing.assert_allclose(d0["medians"], d1["medians"])
    # and it is the right posterior (truth T1=14, L1=2.5)
    assert d0["medians"][0] == pytest.approx(14.0, rel=0.25)
    assert d0["medians"][1] == pytest.approx(2.5, rel=0.35)


LADDER_WORKER = """
import os, sys, hashlib
proc_id, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
import numpy as np
from lightcurve_fitting_tpu.parallel import distributed
from lightcurve_fitting_tpu.parallel.mesh import walker_mesh
from lightcurve_fitting_tpu.lightcurve import LC
from lightcurve_fitting_tpu.filters import filtdict
from lightcurve_fitting_tpu.models import ShockCooling2, UniformPrior
from lightcurve_fitting_tpu.fitting import lightcurve_ptmcmc

distributed.initialize(coordinator_address="127.0.0.1:" + port,
                       num_processes=nproc, process_id=proc_id)

rng = np.random.default_rng(0)
filters = [filtdict[n] for n in ["g", "r", "i"]]
t = np.repeat(np.linspace(1.0, 8.0, 5), 3)
f = np.array(filters * 5)
y_true = ShockCooling2()(t, f, 14.0, 2.5, 40.0, 0.0)
dy = 0.05 * y_true
lc = LC([t, f, y_true + rng.normal(scale=dy), dy],
        names=["MJD", "filter", "lum", "dlum"])
model = ShockCooling2(lc)
priors = [UniformPrior(1.0, 50.0), UniformPrior(0.1, 20.0),
          UniformPrior(5.0, 100.0), UniformPrior(-1.0, 0.9)]

# the tempered ladder's walker axis sharded over ONE global mesh spanning
# both processes (evidence + PT posteriors across processes)
mesh = walker_mesh()
pt = lightcurve_ptmcmc(lc, model, priors,
                       p_lo=[5.0, 0.5, 20.0, -0.5], p_up=[25.0, 5.0, 60.0, 0.5],
                       nwalkers=16, n_rungs=5, nsteps=120, nsteps_burnin=120,
                       seed=3, mesh=mesh, quiet=True)
flat = pt.flatchain
digest = hashlib.sha1(np.ascontiguousarray(flat).tobytes()).hexdigest()
np.savez(os.path.join(outdir, "lad_" + str(proc_id) + ".npz"),
         medians=np.median(flat, axis=0), log_z=pt.log_z,
         digest=np.array(digest))
print("proc", proc_id, "log_z", pt.log_z, flush=True)
"""


def test_two_process_global_mesh_tempered_ladder(tmp_path):
    """Evidence/PT's walker axis sharded across two jax.distributed
    processes: identical cold chains + log Z on both, truths recovered."""
    worker = tmp_path / "worker_lad.py"
    worker.write_text(LADDER_WORKER.format(repo=os.path.abspath(REPO)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", str(port),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for pid in range(2)]
    outputs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out
    d0 = np.load(tmp_path / "lad_0.npz")
    d1 = np.load(tmp_path / "lad_1.npz")
    assert str(d0["digest"]) == str(d1["digest"])
    assert float(d0["log_z"]) == float(d1["log_z"])
    assert d0["medians"][0] == pytest.approx(14.0, rel=0.25)


def test_empty_shard_placeholder_is_shape_compatible():
    """Round-5 review fix: the empty-shard placeholder mirrors
    fit_population's real return shapes — chains carry the true
    nsteps*nwalkers second axis (so gathers can concatenate along axis 0)
    and return_chains=False yields None exactly like a non-empty shard."""
    from lightcurve_fitting_tpu.parallel import distributed
    from lightcurve_fitting_tpu.models import UniformPrior

    priors = [UniformPrior(0.0, 1.0)] * 3
    mine, (flat, acc) = distributed.fit_population_local_shard(
        [None], [None], priors, [0.0] * 3, [1.0] * 3, process_id=1,
        process_count=2, nwalkers=8, nsteps=5)
    assert len(mine) == 0
    assert flat.shape == (0, 40, 3) and acc.shape == (0,)
    # concatenates against a plausible non-empty shard result
    other = np.zeros((1, 40, 3))
    assert np.concatenate([other, flat]).shape == (1, 40, 3)
    mine, (flat2, acc2, summ) = distributed.fit_population_local_shard(
        [None], [None], priors, [0.0] * 3, [1.0] * 3, process_id=1,
        process_count=2, nwalkers=8, nsteps=5, summaries=True,
        return_chains=False)
    assert flat2 is None and summ.shape == (0, 3, 3) and acc2.shape == (0,)


def test_process_info_single_process():
    from lightcurve_fitting_tpu.parallel.distributed import process_info

    idx, count = process_info()
    assert (idx, count) == (0, 1)
