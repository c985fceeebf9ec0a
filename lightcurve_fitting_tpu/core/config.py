"""Runtime configuration.

``compute_dtype`` controls the precision of the band-integration hot path
(the (walkers x points x nodes) Planck cube). ``None`` (default) inherits the
input dtype — float64 under ``jax_enable_x64`` for exact host parity. Set to
``jnp.float32`` (or bfloat16) for accelerator production: parameter and time
arithmetic stay in the ambient precision (MJD epochs need float64), while the
transcendental-heavy cube runs at the float32 rate. Relative error of the band
fluxes in float32 is ~1e-7, far below photometric uncertainty.
"""

AUTO = "auto"
compute_dtype = AUTO


def set_compute_dtype(dtype):
    """Set the hot-path compute dtype (None, jnp.float32, jnp.bfloat16, or
    config.AUTO to re-enable backend-based resolution)."""
    global compute_dtype
    compute_dtype = dtype


def get_compute_dtype():
    """Resolve the hot-path dtype: explicit user setting wins; AUTO resolves to
    float32 on accelerators and to None (ambient precision) on CPU. Whether
    float64 would now be the better choice on a GPU, which has native (if
    slower) float64, is an open measurement."""
    global compute_dtype
    if compute_dtype == AUTO:
        import jax
        import jax.numpy as jnp
        compute_dtype = None if jax.default_backend() == "cpu" else jnp.float32
    return compute_dtype


def enable_compilation_cache(path=None, min_compile_time_secs=1.0, default=None):
    """Persist compiled XLA executables across processes.

    Compiling a fit kernel takes seconds to minutes; with JAX's persistent
    compilation cache every later process (CLI invocations, notebook
    restarts, batch jobs) reuses the serialized executable instead of
    recompiling. In-process caches already dedupe repeat calls (e.g. the
    tempered-ladder kernel cache); this extends that across processes.

    Parameters
    ----------
    path : str, optional
        Cache directory, created if missing. When omitted and
        ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
        there and nothing is changed; otherwise ``default``.
    min_compile_time_secs : float, optional
        Only compilations slower than this are persisted (skips trivia).
    default : str, optional
        The directory used when neither ``path`` nor the environment names
        one (``~/.cache/lightcurve_fitting_tpu/xla`` if omitted). Scripts
        that run from a checkout pass a fixed directory inside it: the path
        is part of the cache key, so a directory that moves never hits.

    Returns the cache directory in use.
    """
    import os
    import jax

    if path is None:
        env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        if env_dir:
            return env_dir
        path = default or os.path.join(os.path.expanduser("~"), ".cache",
                                       "lightcurve_fitting_tpu", "xla")
    os.makedirs(path, exist_ok=True)
    redirect = (jax.config.jax_compilation_cache_dir is not None
                and jax.config.jax_compilation_cache_dir != path)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    if redirect:
        # jax lazily builds one cache object bound to the directory it saw
        # first; a later directory change needs an explicit reset or writes
        # keep landing in the old location
        try:
            from jax.experimental.compilation_cache import compilation_cache
            compilation_cache.reset_cache()
        except Exception:
            pass
    return path
