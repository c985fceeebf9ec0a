"""Population fitting: many transients fit concurrently on one device or a mesh.

BASELINE.json config 5 ("100s of transients fit concurrently, walkers sharded
over a device mesh"). Each transient gets its own stretch-move ensemble;
transients are embarrassingly parallel, so the transient axis is vmapped on
device and — when a mesh is given — sharded with ``shard_map`` with **zero**
collectives (each device fits its own transients; SURVEY.md §5: cross-host
population fitting needs no inner communication).

All transients must share a model *class* and prior structure; per-transient
state (redshift, filter quadrature, SiFTO scalings) lives in the packed data.
Photometry is padded to the widest transient with zero-weight masks.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .sampler import make_stretch_kernel
from ..models.base import intrinsic_scatter_units

__all__ = ["pack_population", "fit_population",
           "population_goodness_of_fit", "population_information_criteria",
           "population_compare_elpd"]

# both caches are LRU-bounded: entries close over model/prior instances and
# pin compiled executables, so a survey sweeping model variants or population
# shapes must not accumulate them forever
from .evidence import _LRUCache as _EvLRUCache  # noqa: E402
_COMPILED_CACHE = _EvLRUCache(32)
_POP_GOF_CACHE = _EvLRUCache(16)
_PACK_SHIP_CACHE = _EvLRUCache(4)


def _array_digest(a):
    a = np.ascontiguousarray(np.asarray(a))
    return (a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest()[:16])


# per-instance memoization caches (none currently) that must not alter
# compiled-physics fingerprints
_FINGERPRINT_SKIP = set()


def _vars_digest(obj, skip=()):
    """Hashable digest of every instance attribute (scalars, arrays, dicts,
    sequences; callables/objects reduce to their type name)."""
    def _digest(v):
        if isinstance(v, (int, float, bool, str, type(None))):
            return v
        if isinstance(v, (np.ndarray, jax.Array)):
            return _array_digest(v)
        if isinstance(v, dict):
            return tuple(sorted((str(kk), _digest(vv)) for kk, vv in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(_digest(vv) for vv in v)
        return type(v).__name__  # callables/objects: identity-free marker

    return tuple((k, _digest(vars(obj)[k])) for k in sorted(vars(obj))
                 if k not in skip)


def _model_fingerprint(model):
    """Hashable digest of the instance constants a jitted closure over
    ``model._eval_points`` bakes in (ShockCooling n/A/a/alpha/epsilon_*,
    cutoff_freq, z, ...). The compiled-kernel caches MUST key on this, not
    just the class name: two same-shape fits with n=1.5 vs n=3.0 compile
    different physics. Underscore attributes are included too (skipping only
    known memo caches), and dict attributes digest their scalar/array values
    — constants are fingerprinted wherever the instance stores them."""
    return (type(model).__name__, _vars_digest(model, skip=_FINGERPRINT_SKIP))


def _prior_fingerprint(p):
    """Hashable digest of one prior: type name + EVERY instance attribute
    (compiled-kernel caches bake the prior density into their closures, so a
    user-defined Prior subclass whose density depends on any extra attribute
    must not collide with a same-bounds sibling)."""
    return (type(p).__name__, _vars_digest(p))


def pack_population(models, lcs, use_sigma=False):
    """Pack per-transient photometry + quadrature into dense padded arrays.

    Parameters
    ----------
    models : list of Model instances (same class), one per light curve
    lcs : list of LC tables with the columns the model's output_quantity needs

    Returns
    -------
    dict of stacked arrays: t (S, N), y, dy, mask (S, N), and each quad entry
    stacked over transients; plus 'yscale' (S,).

    Repeat packs of identical content reuse the shipped device buffers via a
    small content-keyed LRU (sha1 of the stacked host arrays): a
    fit -> goodness_of_fit -> IC workflow or a seed sweep over one population
    skips the device_put.
    """
    S = len(lcs)
    N = max(len(lc) for lc in lcs)
    oq = models[0].output_quantity
    t = np.zeros((S, N))
    y = np.zeros((S, N))
    dy = np.ones((S, N))
    mask = np.zeros((S, N), bool)
    quads = []
    for m, lc in zip(models, lcs):
        n = len(lc)
        t_i = np.asarray(lc["MJD"], float)
        t[len(quads), :n] = t_i
        # pad times with the LAST REAL TIME, not zero: padded rows are masked
        # out of the likelihood, but hot_phase centers on floor(min t) — a
        # zero pad under MJD-scale data would silently destroy the f32
        # centering (t_ref = 0 leaves ~5.7e4-day magnitudes, f32 ulp ~11 min)
        t[len(quads), n:] = t_i[-1] if n else 0.0
        y[len(quads), :n] = np.asarray(lc[oq], float)
        dy[len(quads), :n] = np.asarray(lc["d" + oq], float)
        mask[len(quads), :n] = True
        quad = m.prepare_quad(np.asarray(lc["filter"]))
        # pad each per-point quad array to N points by repeating the last row
        padded = {}
        for k, v in quad.items():
            v = np.asarray(v)
            if v.shape[:1] == (n,) and n < N:
                pad = np.repeat(v[-1:], N - n, axis=0)
                v = np.concatenate([v, pad], axis=0)
            padded[k] = v
        quads.append(padded)
    # bb_coeffs width is the table's adaptive Chebyshev degree, which can
    # differ between transients' filter sets: pad with trailing zeros to the
    # population max (zero coefficients are exact no-ops in Clenshaw)
    if "bb_coeffs" in quads[0]:
        D = max(q["bb_coeffs"].shape[-1] for q in quads)
        for q in quads:
            d = q["bb_coeffs"].shape[-1]
            if d < D:
                q["bb_coeffs"] = np.pad(q["bb_coeffs"], [(0, 0), (0, D - d)])
    # ship blackbody quadrature/table entries pre-cast to the device compute
    # dtype: chebyshev_bandflux / bandflux_pointwise cast them on device
    # anyway (identical rounding), and the float64 bb_coeffs stack was the
    # bulk of the per-call transfer (25 MB at S=512). Entries other models
    # consume without a device-side cast (e.g. SiFTO splines) keep their dtype.
    from ..core import config
    _dt = config.get_compute_dtype()
    _castable = {"bb_coeffs", "bb_s_a", "bb_s_b", "nodes", "weights", "k_ext"}
    stacked_host = {}
    for k in quads[0]:
        out = np.stack([q[k] for q in quads])
        if _dt is not None and k in _castable and out.dtype.kind == "f":
            out = out.astype(_dt)
        stacked_host[k] = out
    yscale = np.array([np.median(np.abs(yy[mm])) if mm.any() else 1.0
                       for yy, mm in zip(y, mask)])

    # Content-keyed shipment cache: a fit -> goodness-of-fit -> IC workflow
    # (and any seed/step sweep over the same population) packs identical
    # data several times; the device_put of the stacked payload (~15 MB at
    # S=512) is then skipped. Host stacking
    # above always runs (it IS the key); only the transfer is skipped.
    # sha1 digests make hits content-exact — an in-place edit of a light
    # curve re-ships. Entries pin device memory (~15-30 MB each at survey
    # scale), hence the small LRU. No kernel donates its data arguments,
    # so cached buffers are never invalidated by a call.
    key = (jax.default_backend(),
           tuple(d.id for d in jax.devices()),
           str(getattr(jax.config, "jax_default_device", None)),
           bool(jax.config.jax_enable_x64),
           _array_digest(t), _array_digest(y), _array_digest(dy),
           _array_digest(mask), _array_digest(yscale),
           tuple(sorted((k, _array_digest(v)) for k, v in stacked_host.items())))
    hit = _PACK_SHIP_CACHE.get(key)
    if hit is not None:
        return {**hit, "quad": dict(hit["quad"])}
    out = {"t": jnp.asarray(t), "y": jnp.asarray(y), "dy": jnp.asarray(dy),
           "mask": jnp.asarray(mask),
           "quad": {k: jnp.asarray(v) for k, v in stacked_host.items()},
           "yscale": jnp.asarray(yscale)}
    _PACK_SHIP_CACHE[key] = out
    # shallow copies keep cached entries immutable to callers that add keys
    return {**out, "quad": dict(out["quad"])}


def _map_seeded_guesses(make_logpost, packed, priors, p_lo, p_up, S, nwalkers,
                        ndim, n_starts, n_iter, rng, cache_key=None):
    """Walker starting positions around each transient's MAP: one compiled
    Adam scan covers all S x n_starts optimizations (two vmap levels over the
    bounds-bijected posterior), then walkers jitter in a thin band around the
    per-transient best point, folded inside the prior support. Transients
    where every start ends non-finite (posterior -inf across the window)
    fall back to window-uniform starts — the behavior init="window" gives."""
    import optax
    from .hmc import BoundsTransform

    bounds = BoundsTransform([getattr(p, "p_min", -np.inf) for p in priors],
                             [getattr(p, "p_max", np.inf) for p in priors])
    x0 = rng.uniform(size=(S, n_starts, ndim)) * (p_up - p_lo) + p_lo
    u0 = jnp.asarray(bounds.to_unbounded(x0))

    optimize = _COMPILED_CACHE.get(cache_key) if cache_key else None
    if optimize is None:
        schedule = optax.cosine_decay_schedule(0.05, n_iter, alpha=0.01)
        opt = optax.adam(schedule)

        def neg_one(u, t_s, y_s, dy_s, mask_s, yscale_s, quad_s):
            logpost = make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s)
            return -logpost(bounds.to_bounded(u))

        # value_and_grad over one start; vmap starts; vmap transients
        vg = jax.vmap(jax.value_and_grad(neg_one), in_axes=(0,) + (None,) * 6)
        vg = jax.vmap(vg, in_axes=(0, 0, 0, 0, 0, 0, 0))

        def optimize_fn(u, t, y, dy, mask, yscale, quad):
            def step(carry, _):
                u, state = carry
                _, g = vg(u, t, y, dy, mask, yscale, quad)
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                updates, state = opt.update(g, state, u)
                return (optax.apply_updates(u, updates), state), None

            (u, _), _ = jax.lax.scan(step, (u, opt.init(u)), None, length=n_iter)
            neg_final, _ = vg(u, t, y, dy, mask, yscale, quad)
            return u, neg_final

        optimize = jax.jit(optimize_fn)
        if cache_key:
            _COMPILED_CACHE[cache_key] = optimize

    u_fin, neg_fin = optimize(u0, packed["t"], packed["y"], packed["dy"],
                              packed["mask"], packed["yscale"], packed["quad"])
    neg_fin = np.asarray(neg_fin)
    best = np.argmin(np.where(np.isfinite(neg_fin), neg_fin, np.inf), axis=1)
    x_fin = np.asarray(bounds.to_bounded(u_fin))          # (S, n_starts, ndim)
    x_map = x_fin[np.arange(S), best]                      # (S, ndim)

    # thin-band jitter around each MAP, folded inside the prior support so
    # bound-pinned dimensions keep nonzero spread for the stretch move
    band = 1e-3 * (p_up - p_lo)
    g = x_map[:, None, :] + band * rng.uniform(-1.0, 1.0, (S, nwalkers, ndim))
    s_lo = np.array([getattr(p, "p_min", -np.inf) for p in priors])
    s_up = np.array([getattr(p, "p_max", np.inf) for p in priors])
    g = np.where(g <= s_lo, 2 * s_lo - g + band * 1e-3, g)
    g = np.where(g >= s_up, 2 * s_up - g - band * 1e-3, g)
    g = np.clip(g, s_lo + 1e-9 * np.abs(band), s_up - 1e-9 * np.abs(band))
    dead = ~np.isfinite(neg_fin[np.arange(S), best])
    if dead.any():
        import warnings
        warnings.warn(f"MAP seeding found no finite posterior for "
                      f"{int(dead.sum())} transient(s); falling back to "
                      "window-uniform starts for those")
        fallback = rng.uniform(size=(S, nwalkers, ndim)) * (p_up - p_lo) + p_lo
        g = np.where(dead[:, None, None], fallback, g)
    return g


def fit_population(models, lcs, priors, p_lo, p_up, nwalkers=64, nsteps=500,
                   nsteps_burnin=500, use_sigma=False, sigma_type="relative",
                   seed=0, mesh=None, axis_name="transients", a=2.0,
                   init="window", n_map_starts=16, n_map_iter=400,
                   state_dtype="auto", checkpoint_every=None,
                   checkpoint_file=None, resume_from=None,
                   return_chains=True, summaries=False):
    """Fit every light curve with its own ensemble, all in one device call.

    ``init="map"`` first runs a batched multi-start Adam ascent of every
    transient's posterior at once (S x n_map_starts optimizations in one
    compiled scan) and seeds the walkers around each transient's MAP — on
    thin-ridge posteriors wide-start ensembles are still contracting after
    thousands of steps (VALIDATION.md), and at population scale that
    pathology hits every transient whose posterior is tight; MAP seeding
    makes a ~100-step burn-in sufficient.

    ``state_dtype="auto"``: on accelerators the walker state (and returned
    chains) run float32 over the affine-rescaled [p_lo, p_up] window — the
    shared-window analog of ``lightcurve_mcmc(state_dtype="auto")``
    (statistics identical: the stretch move is affine-equivariant and the
    likelihood receives float64 parameters; an MJD-scale t_0 would quantize
    at minutes in absolute f32). Returned flatchains are absolute float64.

    ``checkpoint_every=N`` with ``checkpoint_file``: the whole population's
    walker state + partial production chains save every N steps (atomic);
    ``resume_from`` restores and continues — per-step RNG keys fold the
    global step index from each transient's base key, so the resumed chains
    equal the uninterrupted run's exactly.

    ``summaries=True``: additionally return per-transient per-parameter
    (16, 50, 84)th percentiles, shape (S, ndim, 3), computed **on device**
    in un-checkpointed runs. With ``return_chains=False`` (requires
    ``summaries=True``) the chains never reach the host: at 64 transients x
    64 walkers x 1000 steps that saves a 62 MB float32 chain transfer plus
    the 33 MB acceptance array. Percentiles commute with the affine state
    rescaling, so they are computed in the float32 q-representation and
    mapped to absolute parameters host-side. Checkpointed/resumed runs ship
    chains to the host anyway (checkpoints contain them); there the
    summaries are computed host-side, same values.

    Returns (flatchains (S, nsteps*nwalkers, ndim) or None, acceptance (S,))
    plus the (S, ndim, 3) summary array when ``summaries=True``.
    With ``mesh``, the transient axis is sharded across it; transient counts
    that don't divide the mesh are padded internally by repeating the last
    transient (its duplicate chains are computed and discarded — waste is
    bounded by mesh_size - 1 transients).
    """
    if not return_chains and not summaries:
        raise ValueError("return_chains=False requires summaries=True "
                         "(nothing would be returned)")
    ndim = len(priors)
    half = nwalkers // 2
    S = len(lcs)
    S_out = S
    model = models[0]
    packed = pack_population(models, lcs, use_sigma)
    if mesh is not None:
        pad = (-S) % mesh.shape[axis_name]
        if pad:
            def _pad(a):
                return jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)],
                                       axis=0)
            packed = {k: jax.tree.map(_pad, v) if k == "quad" else _pad(v)
                      for k, v in packed.items()}
            S = S + pad

    rng = np.random.default_rng(seed)
    p_lo = np.asarray(p_lo, float)
    p_up = np.asarray(p_up, float)

    # shared-window affine rescaling for float32 walker state on accelerators
    # (one policy, owned by fitting._state_rescaling; MAP seeding below stays
    # in absolute space)
    from ..fitting import _state_rescaling
    _state_kw = _state_rescaling(state_dtype, p_lo, p_up)
    use_f32_state = bool(_state_kw)
    if use_f32_state:
        q_off, q_sc = _state_kw["param_offset"], _state_kw["param_scale"]
        o_j, s_j = jnp.asarray(q_off), jnp.asarray(q_sc)
    else:
        q_off = q_sc = o_j = s_j = None

    from ..core import config
    dt = config.get_compute_dtype()

    def make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s):
        """Per-transient log-posterior closure over one slice of the packed
        arrays (shared by the ensemble kernel and the MAP seeding stage)."""
        inv = 1.0 / yscale_s
        yn = y_s * inv
        dyn = dy_s * inv
        sigma_units = intrinsic_scatter_units(dyn, sigma_type, mask=mask_s,
                                              dt=dt)
        # constant Gaussian normalization: computed once outside the scan
        log_norm = -0.5 * jnp.sum(jnp.where(mask_s, jnp.log(2 * jnp.pi * dyn ** 2.0), 0.0))
        # residual arithmetic in the hot-path dtype (O(1) after normalization)
        yn_h = yn if dt is None else yn.astype(dt)
        dyn_h = dyn if dt is None else dyn.astype(dt)
        inv_dyn = jnp.where(mask_s, 1.0 / dyn_h, 0.0)
        inv_h = inv if dt is None else inv.astype(dt)

        def logpost(p):
            log_prior = 0.0
            for i, prior in enumerate(priors):
                log_prior = log_prior + prior(p[i])
            n_model = ndim - (1 if use_sigma else 0)
            y_fit = model._eval_points(t_s, quad_s, *[p[i] for i in range(n_model)])
            y_fit = (y_fit if dt is None else y_fit.astype(dt)) * inv_h
            if use_sigma:
                sig = p[-1] if dt is None else p[-1].astype(dt)
                sigma2 = dyn_h ** 2.0 + (sig * sigma_units) ** 2.0
                terms = jnp.log(2 * jnp.pi * sigma2) + (yn_h - y_fit) ** 2.0 / sigma2
                ll = -0.5 * jnp.sum(jnp.where(mask_s, terms, 0.0))
            else:
                r = (yn_h - y_fit) * inv_dyn
                ll = -0.5 * jnp.sum(r * r) + log_norm
            ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
            return jnp.where(jnp.isfinite(log_prior), log_prior + ll, -jnp.inf)

        return logpost

    prior_sig = tuple(_prior_fingerprint(p) for p in priors)
    model_sig = _model_fingerprint(model)

    def make_guesses():
        # only for fresh runs: a resume restores walkers from the checkpoint,
        # and init="map"'s batched multi-start Adam is expensive to waste
        if init == "map":
            map_key = ("mapseed", model_sig, prior_sig,
                       packed["t"].shape, n_map_starts, n_map_iter, use_sigma,
                       sigma_type, dt)  # dt: the compute dtype is baked in
            return _map_seeded_guesses(make_logpost, packed, priors, p_lo, p_up,
                                       S, nwalkers, ndim, n_map_starts,
                                       n_map_iter, rng, cache_key=map_key)
        if init == "window":
            return rng.uniform(size=(S, nwalkers, ndim)) * (p_up - p_lo) + p_lo
        raise ValueError('init must be "window" or "map"')

    def _wrap(logpost_abs):
        if o_j is None:
            return logpost_abs
        return lambda q: logpost_abs(o_j + s_j * q)

    def init_one(t_s, y_s, dy_s, mask_s, yscale_s, quad_s, guess_s):
        logpost = _wrap(make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s))
        x = guess_s.reshape(2, half, ndim)
        logp = jax.vmap(logpost)(guess_s).reshape(2, half)
        return x, logp

    def make_seg(collect):
        """One scan segment per transient; per-step keys fold the GLOBAL step
        index from the transient's base key, so chains are identical however
        the run is segmented (exact checkpoint/resume, like the plain
        ensemble and the tempered ladder)."""
        def seg_one(t_s, y_s, dy_s, mask_s, yscale_s, quad_s, x_s, logp_s,
                    key_s, idx):
            logpost = _wrap(make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s))
            step, _ = make_stretch_kernel(logpost, half, ndim, a)
            keys = jax.vmap(lambda i: jr.fold_in(key_s, i))(idx)
            (x, logp), (xs, lps, acc) = jax.lax.scan(step, (x_s, logp_s), keys)
            if collect:
                # rescaled (q-space, O(1)) state ships float32 chains: the
                # summaries are unaffected and the host transfer halves.
                # ABSOLUTE f64 state must NOT
                # downcast — f32 would quantize an MJD-scale t_0 at ~6 min
                # (the hazard pack_population's time-padding comment guards)
                xs_out = xs.astype(jnp.float32) if use_f32_state else xs
                return x, logp, xs_out, acc
            return x, logp
        return seg_one

    data_args = (packed["t"], packed["y"], packed["dy"], packed["mask"],
                 packed["yscale"], packed["quad"])
    base_cache = (model_sig, prior_sig,
                  packed["t"].shape,
                  packed["quad"]["nodes"].shape if "nodes" in packed["quad"] else None,
                  nwalkers, use_sigma, sigma_type, a, dt, use_f32_state,
                  None if q_off is None else (tuple(q_off), tuple(q_sc)),
                  None if mesh is None else (tuple(mesh.shape.items()), axis_name,
                                             tuple(d.id for d in mesh.devices.flat)))

    spec = P(axis_name) if mesh is not None else None
    quad_spec = (jax.tree.map(lambda _: spec, packed["quad"])
                 if mesh is not None else None)

    def compiled(tag, fn, in_axes, in_specs, out_specs):
        key = base_cache + (tag,)
        f = _COMPILED_CACHE.get(key)
        if f is None:
            v = jax.vmap(fn, in_axes=in_axes)
            if mesh is not None:
                v = shard_map(v, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False)
            f = jax.jit(v)
            _COMPILED_CACHE[key] = f
        return f

    data_axes = (0, 0, 0, 0, 0, 0)
    data_specs = (spec,) * 5 + (quad_spec,)

    init_fn = compiled("init", init_one, data_axes + (0,),
                       data_specs + (spec,), (spec, spec))
    seg_burn = compiled("seg_burn", make_seg(False), data_axes + (0, 0, 0, None),
                        data_specs + (spec, spec, spec, P()),
                        (spec, spec))
    seg_prod = compiled("seg_prod", make_seg(True), data_axes + (0, 0, 0, None),
                        data_specs + (spec, spec, spec, P()),
                        (spec, spec, spec, spec))

    tkeys = jr.split(jr.PRNGKey(seed), S)
    total = nsteps_burnin + nsteps
    blocks = {"xs": [], "acc": []}
    if checkpoint_every is not None and not checkpoint_file:
        raise ValueError("checkpoint_every requires checkpoint_file")

    state_repr = str(np.dtype(np.float32 if use_f32_state else np.float64))

    # data identity: a checkpoint must only resume against the SAME packed
    # photometry — shapes, seed, and state repr all match across different
    # shards of a distributed population (fit_population_local_shard forwards
    # identical kwargs to every process), so without this a shared
    # checkpoint_file would silently restore another shard's walkers.
    # Computed LAZILY: np.asarray(packed[...]) forces a device->host readback
    # — a pure waste on the (default) un-checkpointed fast path, which never
    # uses the digest.
    _digest_cache = []

    def data_digest():
        if not _digest_cache:
            _digest_cache.append(hashlib.sha1(
                np.ascontiguousarray(np.asarray(packed["t"])).tobytes()
                + np.ascontiguousarray(np.asarray(packed["y"])).tobytes()
            ).hexdigest())
        return _digest_cache[0]
    if resume_from is not None:
        ck = np.load(resume_from)
        if ck["x"].shape != (S, 2, half, ndim):
            raise ValueError(f"checkpoint shape {ck['x'].shape} does not match "
                             f"this run {(S, 2, half, ndim)}")
        if int(ck["seed"]) != int(seed):
            raise ValueError(f"checkpoint seed {int(ck['seed'])} != {seed}")
        if int(ck["nsteps_burnin"]) != int(nsteps_burnin):
            raise ValueError(f"checkpoint nsteps_burnin {int(ck['nsteps_burnin'])} "
                             f"!= {nsteps_burnin}")
        if str(ck["state_repr"][()]) != state_repr:
            raise ValueError(f"checkpoint state representation "
                             f"{ck['state_repr'][()]} != {state_repr}: resume "
                             "with the original state_dtype/backend")
        if "data_digest" in ck and str(ck["data_digest"][()]) != data_digest():
            raise ValueError("checkpoint was written for different photometry "
                             "(data digest mismatch) — e.g. another shard of a "
                             "distributed population sharing the same "
                             "checkpoint_file; give each shard its own file")
        steps_done = int(ck["steps_done"])
        if steps_done > total:
            raise ValueError(f"checkpoint already contains {steps_done} steps "
                             f"(> nsteps_burnin + nsteps = {total}); resume "
                             "with at least the original nsteps")
        x, logp = jnp.asarray(ck["x"]), jnp.asarray(ck["logp"])
        if ck["prod_xs"].size:
            blocks["xs"].append(ck["prod_xs"])
            blocks["acc"].append(ck["prod_acc"])
    else:
        guesses = np.asarray(make_guesses(), float)
        if q_off is not None:
            guesses = (guesses - q_off) / q_sc
        guess_dev = jnp.asarray(guesses,
                                dtype=jnp.float32 if use_f32_state else None)
        x, logp = init_fn(*data_args, guess_dev)
        steps_done = 0

    def save_checkpoint():
        from ..utils.checkpoint_io import atomic_savez
        atomic_savez(checkpoint_file,
                     x=np.asarray(x), logp=np.asarray(logp),
                     steps_done=steps_done, seed=seed,
                     nsteps_burnin=nsteps_burnin, state_repr=state_repr,
                     data_digest=data_digest(),
                     prod_xs=(np.concatenate(blocks["xs"], axis=1)
                              if blocks["xs"]
                              else np.empty((S, 0, 2, half, ndim), np.float32)),
                     prod_acc=(np.concatenate(blocks["acc"], axis=1)
                               if blocks["acc"]
                               else np.empty((S, 0, 2, half))))

    # un-checkpointed runs execute production as ONE segment, so chains and
    # acceptance can stay device-resident: the acceptance mean reduces to
    # (S,) on device, and summaries (if requested) reduce the chains to
    # (S, ndim, 3) on device, so the chain/acceptance transfer is skipped
    fast = checkpoint_every is None and resume_from is None
    xs_dev = acc_dev = None
    while steps_done < total:
        in_burn = steps_done < nsteps_burnin
        phase_end = nsteps_burnin if in_burn else total
        seg = phase_end - steps_done
        if checkpoint_every is not None:
            seg = min(seg, checkpoint_every)
        idx = jnp.arange(steps_done, steps_done + seg)
        if in_burn:
            x, logp = seg_burn(*data_args, x, logp, tkeys, idx)
        else:
            x, logp, xs, acc = seg_prod(*data_args, x, logp, tkeys, idx)
            if fast:
                xs_dev, acc_dev = xs, acc
            else:
                blocks["xs"].append(np.asarray(xs))
                blocks["acc"].append(np.asarray(acc))
        steps_done += seg
        if checkpoint_every is not None:
            save_checkpoint()

    def _affine_abs(arr_np):
        if q_off is None:
            return np.asarray(arr_np, np.float64)
        return np.asarray(arr_np, np.float64) * q_sc + q_off

    if fast:
        if xs_dev is None:
            # burn-in-only runs (nsteps=0): empty chains, graceful like before
            flat = np.empty((S_out, 0, ndim)) if return_chains else None
            out = (flat, np.zeros(S_out))
            return out + (np.full((S_out, ndim, 3), np.nan),) if summaries else out
        acc_out = np.asarray(jnp.mean(acc_dev.astype(packed["t"].dtype),
                                      axis=(1, 2, 3)), np.float64)[:S_out]
        summ = None
        if summaries:
            fl = xs_dev.reshape(S, -1, ndim)
            # percentiles in the (possibly rescaled-f32) state representation;
            # the affine map to absolute parameters commutes with linear
            # percentile interpolation and is applied host-side in float64.
            # f32 chains take the sort-free counting-bisection path: at
            # this (S, nsteps*nwalkers, ndim) shape it beats XLA's sort,
            # also end to end (ops/quantile.py, tools/population_summary_ab.py)
            from ..ops.quantile import percentile_f32
            qs = jnp.moveaxis(percentile_f32(fl, [16.0, 50.0, 84.0], axis=1),
                              0, -1)                           # (S, ndim, 3)
            summ = np.asarray(qs, np.float64)[:S_out]
            if q_off is not None:
                summ = summ * q_sc[None, :, None] + q_off[None, :, None]
        flat = None
        if return_chains:
            prod = np.asarray(xs_dev)                 # the big transfer
            flat = _affine_abs(prod.reshape(S, nsteps * nwalkers, ndim))[:S_out]
        return (flat, acc_out, summ) if summaries else (flat, acc_out)

    if not blocks["xs"]:
        flat = np.empty((S_out, 0, ndim)) if return_chains else None
        out = (flat, np.zeros(S_out))
        return out + (np.full((S_out, ndim, 3), np.nan),) if summaries else out
    prod = np.concatenate(blocks["xs"], axis=1)       # (S, nsteps, 2, half, ndim)
    acc = np.concatenate(blocks["acc"], axis=1)       # (S, nsteps, 2, half)
    flat = _affine_abs(prod.reshape(S, nsteps * nwalkers, ndim))
    acc_out = acc.reshape(S, -1).mean(axis=1)[:S_out]
    # slice away internally-padded transients (non-divisible mesh runs)
    flat = flat[:S_out]
    if summaries:
        # checkpointed/resumed runs already paid the host transfer (the
        # checkpoint holds the chains); same percentiles, computed host-side
        summ = np.moveaxis(np.percentile(flat, [16.0, 50.0, 84.0], axis=1),
                           0, -1)
        return (flat if return_chains else None), acc_out, summ
    return flat, acc_out


def population_goodness_of_fit(models, lcs, flatchains, use_sigma=False,
                               sigma_type="relative", n_draws=256, seed=0,
                               quiet=False):
    """Per-transient posterior-predictive goodness of fit for a population.

    The survey companion to :func:`fitting.goodness_of_fit`: after
    ``fit_population``, flag the transients whose best fit cannot reproduce
    their photometry. All S transients evaluate in ONE compiled device call
    on the same padded arrays the fit used (looping the single-LC
    diagnostic would retrace per distinct photometry length — a compile
    each; here ragged lengths are masked instead).

    ``flatchains``: (S, M, ndim) posterior samples from ``fit_population``.
    Returns a dict of (S,) arrays: ``chi2`` (best evaluated draw per
    transient), ``dof``, ``chi2_nu``, ``p_value`` (posterior-predictive,
    analytic chi-square-N inner probability), ``n_points``, and
    ``n_invalid_draws`` (draws outside the model's validity window,
    excluded). The chi-square convention matches the single-LC diagnostic
    (variance model of reference models.py:93-136).
    """
    from scipy.stats import chi2 as _chi2_dist

    flatchains = np.asarray(flatchains, float)
    S, M, ndim = flatchains.shape
    if S != len(lcs):
        raise ValueError(f"flatchains has {S} transients, got {len(lcs)} lcs")
    n_model = ndim - (1 if use_sigma else 0)
    model = models[0]
    packed = pack_population(models, lcs, use_sigma)

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), M)
    draws = np.stack([fc[rng.choice(M, n_draws, replace=False)]
                      for fc in flatchains])               # (S, n_draws, ndim)

    key = (_model_fingerprint(model), use_sigma, sigma_type, n_model)
    fn = _POP_GOF_CACHE.get(key)
    if fn is None:
        def chi2_one_transient(draws_s, t_s, y_s, dy_s, mask_s, yscale_s,
                               quad_s):
            # masked form of the variance model in
            # fitting._posterior_discrepancy — keep the two in sync (the
            # suite enforces parity: tests/test_population.py::
            # test_population_goodness_of_fit_matches_single, both
            # sigma_type conventions)
            inv = 1.0 / yscale_s
            yn = y_s * inv
            dyn = dy_s * inv
            sigma_units = intrinsic_scatter_units(dyn, sigma_type, mask=mask_s)

            def one(p):
                y_fit = model._eval_points(t_s, quad_s,
                                           *[p[i] for i in range(n_model)])
                y_fit = y_fit * inv
                sigma2 = dyn ** 2.0
                if use_sigma:
                    sigma2 = sigma2 + (p[-1] * sigma_units) ** 2.0
                r2 = (yn - y_fit) ** 2.0 / sigma2
                return jnp.sum(jnp.where(mask_s, r2, 0.0))

            return jax.vmap(one)(draws_s)

        fn = jax.jit(jax.vmap(chi2_one_transient))
        _POP_GOF_CACHE[key] = fn

    chi2_all = np.asarray(fn(jnp.asarray(draws), packed["t"], packed["y"],
                             packed["dy"], packed["mask"], packed["yscale"],
                             packed["quad"]))               # (S, n_draws)
    npts = np.asarray(packed["mask"].sum(axis=1))
    dof = npts - ndim

    chi2_best = np.full(S, np.nan)
    p_value = np.full(S, np.nan)
    n_bad = np.zeros(S, int)
    for s in range(S):
        finite = np.isfinite(chi2_all[s])
        n_bad[s] = int(np.sum(~finite))
        vals = chi2_all[s][finite]
        if len(vals):
            chi2_best[s] = float(np.min(vals))
            p_value[s] = float(np.mean(_chi2_dist.sf(vals, npts[s])))

    with np.errstate(invalid="ignore", divide="ignore"):
        chi2_nu = chi2_best / np.where(dof > 0, dof, np.nan)
    out = {"chi2": chi2_best, "dof": dof, "chi2_nu": chi2_nu,
           "p_value": p_value, "n_points": npts, "n_invalid_draws": n_bad}
    if not quiet:
        flagged = int(np.sum(p_value < 0.01))
        print(f"population goodness of fit: chi2_nu median "
              f"{np.nanmedian(chi2_nu):.2f} over {S} transients; "
              f"{flagged} with posterior-predictive p < 0.01")
    return out


def population_information_criteria(models, lcs, flatchains, use_sigma=False,
                                    sigma_type="relative", n_draws=512,
                                    seed=0, quiet=False):
    """Per-transient WAIC / PSIS-LOO for a fitted population.

    The survey companion to :func:`fitting.information_criteria`: one
    padded device call produces every transient's (draws x points)
    pointwise log-likelihood matrix (masked ragged lengths — no per-shape
    recompiles), then the host PSIS/WAIC
    statistics (``parallel/ic.py``) run per transient on its REAL points
    only. Use it to compare model families across a survey: score each
    family once, then feed matching transients' ``pointwise`` entries to
    :func:`parallel.ic.compare_elpd` for paired-SE rankings.

    ``flatchains``: (S, M, ndim) posterior samples from ``fit_population``.
    Returns a dict with (S,) arrays ``elpd_loo``, ``se_elpd_loo``,
    ``p_loo``, ``elpd_waic``, ``se_elpd_waic``, ``p_waic``, ``n_points``,
    ``n_high_pareto_k`` (points with k > 0.7), ``n_invalid_draws``, plus
    lists ``pareto_k`` and ``pointwise`` (per-transient arrays over real
    points). Log densities are absolute (the -log(yscale) normalization
    Jacobian is restored per transient).
    """
    from .ic import waic as _waic, psis_loo as _psis_loo

    flatchains = np.asarray(flatchains, float)
    S, M, ndim = flatchains.shape
    if S != len(lcs):
        raise ValueError(f"flatchains has {S} transients, got {len(lcs)} lcs")
    n_model = ndim - (1 if use_sigma else 0)
    model = models[0]
    packed = pack_population(models, lcs, use_sigma)

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), M)
    draws = np.stack([fc[rng.choice(M, n_draws, replace=False)]
                      for fc in flatchains])               # (S, n_draws, ndim)

    key = (_model_fingerprint(model), use_sigma, sigma_type, n_model, "ll")
    fn = _POP_GOF_CACHE.get(key)
    if fn is None:
        def ll_one_transient(draws_s, t_s, y_s, dy_s, mask_s, yscale_s,
                             quad_s):
            # masked form of the pointwise-ll branch of
            # fitting._posterior_discrepancy — parity is test-enforced
            inv = 1.0 / yscale_s
            yn = y_s * inv
            dyn = dy_s * inv
            sigma_units = intrinsic_scatter_units(dyn, sigma_type, mask=mask_s)

            def one(p):
                y_fit = model._eval_points(t_s, quad_s,
                                           *[p[i] for i in range(n_model)])
                y_fit = y_fit * inv
                sigma2 = dyn ** 2.0
                if use_sigma:
                    sigma2 = sigma2 + (p[-1] * sigma_units) ** 2.0
                ll = -0.5 * (jnp.log(2.0 * jnp.pi * sigma2)
                             + (yn - y_fit) ** 2.0 / sigma2)
                return jnp.where(mask_s, ll, 0.0)

            return jax.vmap(one)(draws_s)

        fn = jax.jit(jax.vmap(ll_one_transient))
        _POP_GOF_CACHE[key] = fn

    ll_all = np.asarray(fn(jnp.asarray(draws), packed["t"], packed["y"],
                           packed["dy"], packed["mask"], packed["yscale"],
                           packed["quad"]))                # (S, n_draws, N)
    mask = np.asarray(packed["mask"])
    log_yscale = np.log(np.asarray(packed["yscale"]))

    out = {k: np.full(S, np.nan) for k in
           ("elpd_loo", "se_elpd_loo", "p_loo", "elpd_waic", "se_elpd_waic",
            "p_waic")}
    out["n_points"] = mask.sum(axis=1)
    out["n_high_pareto_k"] = np.zeros(S, int)
    out["n_invalid_draws"] = np.zeros(S, int)
    out["pareto_k"] = [None] * S
    out["pointwise"] = [None] * S
    for s in range(S):
        ll = ll_all[s][:, mask[s]] - log_yscale[s]       # real points only
        good = np.all(np.isfinite(ll), axis=1)
        out["n_invalid_draws"][s] = int(np.sum(~good))
        ll = ll[good]
        if len(ll) < 8:
            continue                        # chain missed the validity window
        loo = _psis_loo(ll)
        wa = _waic(ll)
        out["elpd_loo"][s] = loo["elpd_loo"]
        out["se_elpd_loo"][s] = loo["se_elpd_loo"]
        out["p_loo"][s] = loo["p_loo"]
        out["elpd_waic"][s] = wa["elpd_waic"]
        out["se_elpd_waic"][s] = wa["se_elpd_waic"]
        out["p_waic"][s] = wa["p_waic"]
        out["n_high_pareto_k"][s] = int(np.sum(loo["pareto_k"] > 0.7))
        out["pareto_k"][s] = loo["pareto_k"]
        out["pointwise"][s] = loo["pointwise"]
    if not quiet:
        n_flag = int(np.sum(out["n_high_pareto_k"] > 0))
        print(f"population information criteria: elpd_loo median "
              f"{np.nanmedian(out['elpd_loo']):.1f} over {S} transients; "
              f"{n_flag} with any pareto_k > 0.7")
    return out


def population_compare_elpd(ics, labels, quiet=False):
    """Survey-level model comparison: per-transient paired elpd rankings and
    Yao+18 stacking weights across K model families.

    ``ics``: one :func:`population_information_criteria` result per family,
    all scored on the SAME transients/photometry. Per transient the paired
    difference machinery of :func:`parallel.ic.compare_elpd` runs on the
    matching ``pointwise`` arrays; per-transient stacking weights say which
    families' predictive distributions that transient actually needs.

    Returns a dict of arrays over (K families, S transients):
    ``elpd_loo`` (K, S), ``d_elpd``/``se_d_elpd`` (K, S, vs the
    per-transient best), ``stacking_weight`` (K, S), ``best`` (S,) family
    indices, plus survey totals ``total_elpd`` (K,), ``total_d_elpd`` and
    ``total_se_d_elpd`` (K, paired over all points of all transients) and
    ``n_best`` (K,).
    """
    from .ic import stacking_weights

    K = len(ics)
    if K != len(labels) or len(set(map(str, labels))) != K:
        raise ValueError("labels must be one per model family and unique")
    S = len(ics[0]["pointwise"])
    for ic in ics:
        if len(ic["pointwise"]) != S:
            raise ValueError("families were scored on different numbers of "
                             "transients")
    # population_information_criteria leaves pointwise[s] = None for a
    # transient with too few finite draws; a one-sided comparison is
    # meaningless, so such transients are excluded (and reported) rather
    # than crashing the whole survey comparison
    skipped = [s for s in range(S)
               if any(ic["pointwise"][s] is None for ic in ics)]
    if skipped and not quiet:
        print(f"excluding {len(skipped)} transient(s) with no finite scores "
              f"in at least one family: {skipped}")
    kept = [s for s in range(S) if s not in set(skipped)]
    if not kept:
        raise ValueError("no transient has finite scores in every family")
    ics = [{"pointwise": [ic["pointwise"][s] for s in kept]} for ic in ics]
    S = len(kept)
    elpd = np.empty((K, S))
    d_elpd = np.empty((K, S))
    se_d = np.empty((K, S))
    w = np.empty((K, S))
    for s in range(S):
        pw = [np.asarray(ic["pointwise"][s], float) for ic in ics]
        n = {len(p) for p in pw}
        if len(n) != 1:
            raise ValueError(f"transient {s} was scored on different numbers "
                             f"of points across families ({sorted(n)})")
        N = n.pop()
        elpd[:, s] = [p.sum() for p in pw]
        best = int(np.argmax(elpd[:, s]))
        for k in range(K):
            diff = pw[k] - pw[best]
            d_elpd[k, s] = elpd[k, s] - elpd[best, s]
            se_d[k, s] = (float(np.sqrt(N * np.var(diff, ddof=1)))
                          if k != best and N > 1 else 0.0)
        w[:, s] = stacking_weights(pw)
    best_idx = np.argmax(elpd, axis=0)

    # survey totals: paired over the concatenation of every transient's points
    all_pw = [np.concatenate([np.asarray(ic["pointwise"][s], float)
                              for s in range(S)]) for ic in ics]
    total = np.array([p.sum() for p in all_pw])
    tbest = int(np.argmax(total))
    N_all = len(all_pw[0])
    total_se = np.array([float(np.sqrt(N_all * np.var(all_pw[k] - all_pw[tbest],
                                                      ddof=1)))
                         if k != tbest and N_all > 1 else 0.0
                         for k in range(K)])
    out = {"labels": list(labels), "elpd_loo": elpd, "d_elpd": d_elpd,
           "se_d_elpd": se_d, "stacking_weight": w, "best": best_idx,
           "total_elpd": total, "total_d_elpd": total - total[tbest],
           "total_se_d_elpd": total_se,
           "n_best": np.bincount(best_idx, minlength=K),
           # original-survey indexing of the compared columns + exclusions
           "transients": np.asarray(kept), "skipped": np.asarray(skipped)}
    if not quiet:
        order = np.argsort(-total)
        print(f"survey model comparison over {S} transients (best first):")
        for k in order:
            print(f"  {labels[k]}: total elpd_loo = {total[k]:.1f} "
                  f"(d = {total[k] - total[tbest]:.1f} +/- {total_se[k]:.1f}), "
                  f"best on {out['n_best'][k]}/{S} transients, "
                  f"mean stacking weight {w[k].mean():.3f}")
    return out
