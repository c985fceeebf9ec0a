"""Multi-chip walker sharding for the ensemble sampler.

The Goodman-Weare stretch move is data-parallel over walkers within each
half-ensemble; the only cross-walker dependence is sampling a partner from the
*complementary* half. We therefore shard the walker axis of the (2, half, ndim)
state across a 1-D device mesh and ``all_gather`` the complementary half (a few
KB) over the device interconnect once per half-step — the likelihood, by far the dominant cost,
stays fully local (SURVEY.md §5: the walker axis is this workload's analog of
sequence parallelism).

Population fitting (many transients at once) composes on top: vmap over
transients inside the local shard, or a second mesh axis.
"""


import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .sampler import EnsembleSampler, make_stretch_kernel

__all__ = ["ShardedEnsembleSampler", "walker_mesh", "make_sharded_stretch_step"]


def walker_mesh(n_devices=None, axis_name="walkers", devices=None):
    """A 1-D mesh over the walker axis."""
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def make_sharded_stretch_step(log_prob_fn, nwalkers, ndim, mesh, axis_name="walkers", a=2.0):
    """Stretch-move step with the walker axis sharded over ``mesh``.

    State layout: x (2, half, ndim), logp (2, half), sharded as
    P(None, axis_name, None) / P(None, axis_name). The per-step RNG key is
    replicated; each shard folds in its mesh position so walkers get
    independent proposals while the complementary-half partner indices are
    drawn against the *gathered* (global) half.
    """
    n_dev = mesh.shape[axis_name]
    half = nwalkers // 2
    if half % n_dev:
        raise ValueError(f"nwalkers/2 = {half} must be divisible by mesh size {n_dev}")
    local = half // n_dev

    def gather_other(x_other_local):
        return jax.lax.all_gather(x_other_local, axis_name, axis=0, tiled=True)

    def local_step(carry, key):
        x, logp = carry  # local shards: (2, local, ndim), (2, local)
        key = jr.fold_in(key, jax.lax.axis_index(axis_name))
        step, _ = make_stretch_kernel(log_prob_fn, local, ndim, a, gather_other)
        return step((x, logp), key)

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=((P(None, axis_name, None), P(None, axis_name)), P()),
        out_specs=((P(None, axis_name, None), P(None, axis_name)),
                   (P(None, axis_name, None), P(None, axis_name), P(None, axis_name))),
        check_vma=False,
    )
    return sharded


class ShardedEnsembleSampler(EnsembleSampler):
    """Drop-in :class:`EnsembleSampler` with walkers sharded across a device
    mesh. Identical statistics (the partner pool is the full complementary
    half); chains/acceptance bookkeeping are gathered to host as usual."""

    def __init__(self, nwalkers, ndim, log_prob_fn, mesh=None, axis_name="walkers",
                 a=2.0, seed=None, dtype=jnp.float64, store_dtype=None,
                 param_offset=None, param_scale=None):
        self.mesh = mesh if mesh is not None else walker_mesh(axis_name=axis_name)
        self.axis_name = axis_name
        super().__init__(nwalkers, ndim, log_prob_fn, a=a, seed=seed, dtype=dtype,
                         store_dtype=store_dtype, param_offset=param_offset,
                         param_scale=param_scale)
        # self._log_prob_fn is the post-rescaling form the base class built
        self._step = make_sharded_stretch_step(self._log_prob_fn, nwalkers, ndim,
                                               self.mesh, axis_name, a)
        self._run_jit = {}
        self._state_sharding = NamedSharding(self.mesh, P(None, axis_name, None))
        # the mesh may span processes (multi-controller across hosts): every
        # process runs the same program; host bookkeeping must gather
        # non-addressable global arrays through the coordination service
        self._multiprocess = len({d.process_index
                                  for d in self.mesh.devices.flat}) > 1

    def _prepare_state(self, x):
        """Place walker state on the (possibly multi-process) mesh — every
        process holds the full host value, device_put distributes shards."""
        return jax.device_put(x, self._state_sharding)

    def _prepare_logp(self, logp):
        """The per-walker log-prob shares the state's sharding minus the
        parameter axis (checkpoint resume must re-place it too: a host-local
        array next to globally-sharded state fails in multi-process runs)."""
        spec = P(*self._state_sharding.spec[:-1])
        return jax.device_put(logp, NamedSharding(self.mesh, spec))

    def _to_host(self, a):
        if self._multiprocess:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(a, tiled=True))
        return np.asarray(a)

    def run_mcmc(self, initial_state, nsteps, **kwargs):
        if initial_state is not None:
            initial_state = np.asarray(initial_state, float)
        result = super().run_mcmc(initial_state, nsteps, **kwargs)
        return result

    def _wrap_run_state(self, x):
        """The base _compiled_run scan runs unchanged; this hook pins the
        walker state to the mesh so XLA shards the whole scan (the replicas
        vmap never applies here — the sharded sampler is replicas=1)."""
        return jax.lax.with_sharding_constraint(x, self._state_sharding)
