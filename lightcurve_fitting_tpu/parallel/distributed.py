"""Multi-host execution scaffolding (SURVEY.md §5).

The reference is strictly single-process — ``emcee.EnsembleSampler`` is built
without even a multiprocessing pool (reference fitting.py:130,
bolometric.py:167). This framework's cross-host design is deliberate:

* **Transients shard across processes.** Population fitting is embarrassingly
  parallel over transients, so each host packs and fits only its own
  contiguous shard — zero cross-host collectives in the hot loop (SURVEY.md §5:
  "each host fits distinct transients — no cross-host comms needed except
  gather of summary stats").
* **Walkers shard across the local devices** over the device interconnect (``parallel/mesh.py``),
  inside one process.
* ``jax.distributed`` supplies coordination only: process ids, global device
  visibility, and a barrier at shutdown.

Typical multi-controller launch (one process per host)::

    from lightcurve_fitting_tpu.parallel import distributed
    distributed.initialize()                       # env- or args-driven
    mine, results = distributed.fit_population_local_shard(
        models, lcs, priors, p_lo, p_up, nwalkers=..., nsteps=...)
    # each host now owns results for lcs[i] for i in mine

Exercised by ``tests/test_distributed.py`` with two CPU processes over a
localhost coordinator.
"""

import os

import numpy as np

__all__ = ["initialize", "is_initialized", "process_info", "local_shard",
           "fit_population_local_shard"]

_INITIALIZED = False


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Idempotent ``jax.distributed.initialize`` with environment fallbacks.

    Arguments default to ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` (the standard multi-controller env vars). A
    single-process configuration (``num_processes`` absent or 1) is a no-op,
    so code paths stay identical down to one host.
    """
    global _INITIALIZED
    import jax

    if _INITIALIZED:
        return False
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    if coordinator_address is None:
        # a multi-process launch without a coordinator would leave every host
        # believing it is process 0/1 and fitting the WHOLE population
        raise ValueError("num_processes > 1 requires a coordinator address "
                         "(JAX_COORDINATOR_ADDRESS or coordinator_address=)")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes, process_id=process_id,
                               local_device_ids=local_device_ids)
    _INITIALIZED = True
    return True


def is_initialized():
    return _INITIALIZED


def process_info():
    """(process_index, process_count) — (0, 1) when not distributed."""
    import jax
    return jax.process_index(), jax.process_count()


def local_shard(n_items, process_id=None, process_count=None):
    """Indices of the contiguous, balanced shard owned by this process.

    The first ``n_items % process_count`` processes take one extra item, so
    shard sizes differ by at most one.
    """
    if process_id is None or process_count is None:
        process_id, process_count = process_info()
    base, extra = divmod(n_items, process_count)
    start = process_id * base + min(process_id, extra)
    size = base + (1 if process_id < extra else 0)
    return np.arange(start, start + size)


def fit_population_local_shard(models, lcs, priors, p_lo, p_up, process_id=None,
                               process_count=None, **fit_kwargs):
    """Fit only this process's shard of a transient population.

    Packing is process-local: each host resamples filter banks and pads
    photometry for *its* transients only (host packing can cost more than
    the device math — sharding it matters as much as sharding the math).
    Returns ``(indices, (flatchains, acceptance))`` where ``indices``
    maps shard rows back into the global transient list. With one process this
    is exactly :func:`~lightcurve_fitting_tpu.parallel.population.fit_population`.
    """
    from .population import fit_population

    mine = local_shard(len(lcs), process_id, process_count)
    if len(mine) == 0:
        # the placeholder must be shape- and type-compatible with non-empty
        # shards' results (gathers concatenate along axis 0): chains carry
        # the real nsteps*nwalkers second axis, and return_chains=False
        # yields None exactly like fit_population does
        import inspect
        defaults = {k: v.default for k, v in
                    inspect.signature(fit_population).parameters.items()
                    if v.default is not inspect.Parameter.empty}
        nsteps = fit_kwargs.get("nsteps", defaults["nsteps"])
        nwalkers = fit_kwargs.get("nwalkers", defaults["nwalkers"])
        return_chains = fit_kwargs.get("return_chains",
                                       defaults["return_chains"])
        ndim = len(priors)
        flat = (np.empty((0, nsteps * nwalkers, ndim)) if return_chains
                else None)
        empty = (flat, np.empty((0,)))
        if fit_kwargs.get("summaries"):
            empty = empty + (np.empty((0, ndim, 3)),)
        return mine, empty
    shard_models = [models[i] for i in mine]
    shard_lcs = [lcs[i] for i in mine]
    result = fit_population(shard_models, shard_lcs, priors, p_lo, p_up, **fit_kwargs)
    return mine, result
