"""Regression tests for the driver entry points in ``__graft_entry__.py``.

The multi-device dry run must select its virtual CPU devices before anything
initializes a backend: a backend touch (even ``jax.device_count()``) made
first would initialize whatever platform ``JAX_PLATFORMS`` names. These
tests pin the ordering: the dry run must complete in a subprocess whose
``JAX_PLATFORMS`` names a platform that does not exist, which any
backend touch before the override turns into an error.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_survives_unreachable_accelerator_plugin():
    env = dict(os.environ)
    # a platform name jax cannot resolve: if any backend-initializing call
    # runs before the CPU override, jax raises "unknown backend" and the
    # subprocess fails
    env["JAX_PLATFORMS"] = "bogus_unreachable_platform"
    env.pop("XLA_FLAGS", None)  # the dryrun must supply its own device count
    env["LCF_DRYRUN_STAGES"] = "1"  # fast subset: the init ordering is what
    # is under test; stage 1 already exercises the sharded product path
    out = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(2)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "stage 1/5 OK" in out.stdout
    assert "platform forced to cpu, 2 virtual devices" in out.stdout


def test_force_cpu_mesh_is_first_backend_touch():
    """Static guard: no backend-initializing jax call may precede
    ``_force_cpu_mesh`` in ``dryrun_multichip``'s source."""
    import __graft_entry__
    import inspect
    src = inspect.getsource(__graft_entry__.dryrun_multichip)
    body = src.split("_force_cpu_mesh(n_devices)")[0]
    for needle in ("jax.devices", "jax.device_count", "device_put", "jnp."):
        assert needle not in body, f"{needle} before _force_cpu_mesh"
