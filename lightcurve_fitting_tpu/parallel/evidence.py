"""Bayesian evidence (marginal likelihood) by stepping-stone sampling.

The reference offers no model-comparison machinery at all; posterior fits of
ShockCooling vs ShockCooling2 vs ShockCooling4 can only be compared by eye.
The stepping-stone estimator (Xie et al. 2011) computes

    log Z = sum_k log E_{p_k}[ L^(b_{k+1} - b_k) ],
    p_k(theta) ∝ pi(theta) L(theta)^(b_k)

from samples of a ladder of K power posteriors. On device the whole ladder is
*one* compiled kernel: the K tempered ensembles differ only by the scalar
``beta`` in their acceptance ratio, so they batch into a single vmapped
stretch-move scan — the same amortization trick as
``EnsembleSampler(replicas=...)``, making evidence roughly as cheap as one
posterior fit per rung count instead of K sequential fits.

The ladder uses the standard quantiles of Beta(0.3, 1) (beta_k = (k/K)^(1/0.3)),
which concentrates rungs near beta = 0 where the integrand varies fastest.
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

from .sampler import propose_stretch

__all__ = ["stepping_stone_evidence", "make_beta_ladder"]  # _run_tempered_ladder backs both evidence and PT


def make_beta_ladder(n_rungs, alpha=0.3):
    """K+1 inverse temperatures 0 = b_0 < ... < b_K = 1, Beta(alpha, 1)
    quantiles (Xie et al. 2011's recommended schedule)."""
    return (np.arange(n_rungs + 1) / n_rungs) ** (1.0 / alpha)


def _make_tempered_step(log_prior_fn, log_like_fn, half, ndim, betas, a=2.0,
                        gather_other=None):
    """One stretch-move step of all K tempered ensembles at once.

    carry: x (K, 2, half, ndim), logpri (K, 2, half), logl (K, 2, half).
    The log-likelihood is tracked separately from the prior so (a) each rung's
    acceptance uses logpri + beta_k * logl and (b) the production pass can
    record logl samples for the stepping-stone average without re-evaluating.

    ``half`` is the LOCAL half-ensemble size when the walker axis is sharded
    over a mesh; ``gather_other`` then all-gathers the complementary half so
    the partner pool stays global (identity when single-device). The swap
    phase is rung-wise elementwise — it needs no communication at all.
    """
    batched_pri = jax.vmap(log_prior_fn)
    batched_ll = jax.vmap(log_like_fn)
    K = len(np.asarray(betas))   # static: betas is host numpy at build time
    betas = jnp.asarray(betas)
    if gather_other is None:
        gather_other = lambda x: x

    def half_update(key, beta, x_move, x_other, logpri_move, logl_move):
        kz, kj, ku = jr.split(key, 3)
        y, z = propose_stretch(kz, kj, x_move, gather_other(x_other), a)
        logpri_y = batched_pri(y)
        logl_y = batched_ll(y)
        logl_y = jnp.where(jnp.isnan(logl_y), -jnp.inf, logl_y)
        # beta = 0 rungs sample the bare prior: 0 * (-inf) would poison them
        blogl_y = jnp.where(beta > 0.0, beta * logl_y, 0.0)
        blogl_move = jnp.where(beta > 0.0, beta * logl_move, 0.0)
        log_ratio = (ndim - 1.0) * jnp.log(z) \
            + logpri_y + blogl_y - logpri_move - blogl_move
        accept = jnp.log(jr.uniform(ku, (half,), dtype=x_move.dtype)) < log_ratio
        x_new = jnp.where(accept[:, None], y, x_move)
        return (x_new, jnp.where(accept, logpri_y, logpri_move),
                jnp.where(accept, logl_y, logl_move), accept)

    def step_one(beta, x, logpri, logl, key):
        k1, k2 = jr.split(key)
        x0, p0, l0, a0 = half_update(k1, beta, x[0], x[1], logpri[0], logl[0])
        x1, p1, l1, a1 = half_update(k2, beta, x[1], x0, logpri[1], logl[1])
        return (jnp.stack([x0, x1]), jnp.stack([p0, p1]), jnp.stack([l0, l1]),
                jnp.stack([a0, a1]))

    v_step = jax.vmap(step_one, in_axes=(0, 0, 0, 0, 0))

    # replica-exchange partners: even parity pairs (0,1),(2,3)...; odd parity
    # (1,2),(3,4)...; unpaired edge rows partner themselves (no-op)
    idx = np.arange(K)
    pe = idx ^ 1
    pe = np.where(pe >= K, idx, pe)
    po = np.where(idx == 0, 0, ((idx - 1) ^ 1) + 1)
    po = np.where(po >= K, idx, po)
    idx_j = jnp.asarray(idx)
    pe_j, po_j = jnp.asarray(pe), jnp.asarray(po)

    def do_swap(x, logpri, logl, key, parity):
        """Replica-exchange between adjacent rungs, one walker at a time:
        accept with exp((b_j - b_i)(ll_i - ll_j)) (detailed balance for the
        pair). Both members of a pair share one uniform draw so the decision
        is consistent; the temperature stays with the row, the state moves."""
        partner = jnp.where(parity, po_j, pe_j)
        x_p = x[partner]
        pri_p = logpri[partner]
        ll_p = logl[partner]
        log_acc = (betas[partner] - betas)[:, None, None] * (logl - ll_p)
        u = jr.uniform(key, logl.shape, dtype=x.dtype)
        u_pair = u[jnp.minimum(idx_j, partner)]
        acc = (jnp.log(u_pair) < log_acc) & (partner != idx_j)[:, None, None]
        # never swap a logl=-inf state (possible only from a NaN-likelihood
        # start point): (beta_j-beta_i)*(-inf) can yield log_acc=+inf and
        # push a zero-density state into a beta>0 rung, violating invariance
        acc = acc & jnp.isfinite(logl) & jnp.isfinite(ll_p)
        x = jnp.where(acc[..., None], x_p, x)
        logpri = jnp.where(acc, pri_p, logpri)
        logl = jnp.where(acc, ll_p, logl)
        return x, logpri, logl, acc

    def step(carry, xs):
        keys, swap_key, parity = xs
        x, logpri, logl = carry
        x, logpri, logl, accept = v_step(betas, x, logpri, logl, keys)
        x, logpri, logl, swapped = do_swap(x, logpri, logl, swap_key, parity)
        # cold-rung states ride along for parallel-tempering posterior use
        return (x, logpri, logl), (logl, accept, swapped, x[-1])

    return step, batched_pri, batched_ll


def _run_tempered_ladder(log_prior_fn, log_like_fn, p0, betas_all, nsteps,
                         nsteps_burnin, a=2.0, seed=0, mesh=None,
                         axis_name="walkers", checkpoint_every=None,
                         checkpoint_file=None, resume_from=None,
                         state_dtype=None, host_arrays=True, need_cold=True,
                         fns_key=None):
    """Burn in and sample every rung of ``betas_all`` (typically including
    beta = 1) with replica-exchange swaps after each stretch step.

    With ``mesh``, the walker axis shards across the devices (the likelihood
    stays fully local; one small ``all_gather`` of the complementary half per
    half-step; swaps are communication-free), so evidence and parallel
    tempering scale over a device mesh exactly like the plain ensemble.

    Checkpoint/resume: per-step RNG keys are derived from the step *index*
    (``fold_in(base, i)``), so the chain is identical however the run is
    segmented — a killed run resumed from its ``checkpoint_file`` reproduces
    the uninterrupted chain exactly. ``checkpoint_every=N`` saves the full
    ladder state (x, logpri, logl, step counter, partial production outputs)
    to ``checkpoint_file`` (npz) every N steps; ``resume_from`` restores it.

    Returns (logl_samples (nsteps, K, nwalkers), acceptance (K,),
    swap_rate (K,), cold_chain (nsteps, nwalkers, ndim)) — the cold chain is
    the LAST rung's states, the parallel-tempering posterior when
    betas_all[-1] == 1.

    ``host_arrays=False``: in un-checkpointed single-process runs (production
    is then one scan segment), ``logl_samples`` is returned as a
    device-resident jax array and acceptance/swap rates reduce to (K,) on
    device — the caller's stepping-stone reduction can then run on device
    and the O(nsteps x K x nwalkers) logl/acceptance arrays never cross the
    host link (like the population/bolometric chains). ``need_cold=False``
    additionally skips the cold-chain transfer (returns None).

    ``fns_key``: hashable fingerprint of (log_prior_fn, log_like_fn)'s
    semantics (model physics + priors + photometry digest + rescaling, see
    ``fitting._tempered_setup``). When given, the compiled ladder kernels
    are cached across calls — without it every `lightcurve_evidence`/
    `lightcurve_ptmcmc` call re-jits the whole ladder, and that
    recompilation can cost more than the sampling. Same pattern (and same under-keying hazard) as the
    population/batched compiled caches: the key MUST capture everything the
    closures bake in."""
    p0 = np.asarray(p0, float)
    nwalkers, ndim = p0.shape
    if nwalkers % 2:
        raise ValueError("nwalkers must be even")
    half = nwalkers // 2
    K = len(betas_all)
    if mesh is not None and axis_name not in mesh.axis_names:
        # honor the user mesh's own axis name (a reused epoch/transient mesh
        # would otherwise KeyError on the default 'walkers')
        axis_name = mesh.axis_names[0]
    if checkpoint_every is not None and not checkpoint_file:
        raise ValueError("checkpoint_every requires checkpoint_file")

    def build_kernels():
        if mesh is None:
            step, batched_pri, batched_ll = _make_tempered_step(
                log_prior_fn, log_like_fn, half, ndim, betas_all, a=a)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from jax import shard_map
            n_dev = mesh.shape[axis_name]
            if half % n_dev:
                raise ValueError(f"nwalkers/2 = {half} must divide over "
                                 f"{n_dev} devices")
            local = half // n_dev
            _, batched_pri, batched_ll = _make_tempered_step(
                log_prior_fn, log_like_fn, half, ndim, betas_all, a=a)

            def local_step(carry, xs):
                keys, swap_key, parity = xs
                keys = jax.vmap(jr.fold_in, in_axes=(0, None))(
                    keys, jax.lax.axis_index(axis_name))
                swap_key = jr.fold_in(swap_key, jax.lax.axis_index(axis_name))
                inner, _, _ = _make_tempered_step(
                    log_prior_fn, log_like_fn, local, ndim, betas_all, a=a,
                    gather_other=lambda x: jax.lax.all_gather(
                        x, axis_name, axis=0, tiled=True))
                return inner(carry, (keys, swap_key, parity))

            w = axis_name
            carry_spec = (P(None, None, w, None), P(None, None, w), P(None, None, w))
            step = shard_map(
                local_step, mesh=mesh,
                in_specs=(carry_spec, (P(), P(), P())),
                out_specs=(carry_spec,
                           (P(None, None, w), P(None, None, w), P(None, None, w),
                            P(None, w, None))),
                check_vma=False,
            )

        def constrain(x):
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(mesh, P(None, None, axis_name, None)))
            return x

        @jax.jit
        def init_carry(x):
            x = constrain(x)
            logpri = jax.vmap(batched_pri)(x.reshape(K, nwalkers, ndim)).reshape(K, 2, half)
            logl = jax.vmap(batched_ll)(x.reshape(K, nwalkers, ndim)).reshape(K, 2, half)
            logl = jnp.where(jnp.isnan(logl), -jnp.inf, logl)
            return x, logpri, logl

        @jax.jit
        def run_burn(carry, xs):
            carry = (constrain(carry[0]),) + carry[1:]
            carry, _ = jax.lax.scan(lambda c, k: (step(c, k)[0], None), carry, xs)
            return carry

        @jax.jit
        def run_prod(carry, xs):
            carry = (constrain(carry[0]),) + carry[1:]
            return jax.lax.scan(step, carry, xs)

        return init_carry, run_burn, run_prod

    # compiled-kernel cache across calls (the population/batched pattern):
    # without it every driver call re-jits the ladder, and compilation can
    # dominate the whole run. Only keyed callers cache.
    if fns_key is not None:
        ck_key = (fns_key, K, half, ndim, a,
                  np.asarray(betas_all, float).tobytes(),
                  # device identity, not just shape: the kernels close over
                  # the mesh object, so a same-shaped mesh on other devices
                  # must not reuse them
                  None if mesh is None else (tuple(mesh.shape.items()),
                                             axis_name,
                                             tuple(d.id for d in mesh.devices.flat)))
        kernels = _LADDER_CACHE.get(ck_key)
        if kernels is None:
            kernels = build_kernels()
            _LADDER_CACHE[ck_key] = kernels
    else:
        kernels = build_kernels()
    init_carry, run_burn, run_prod = kernels

    # the mesh may span jax.distributed processes (cross-host walker sharding, like
    # ShardedEnsembleSampler): host-side state must be placed via device_put
    # and read back through the coordination service
    multiprocess = (mesh is not None
                    and len({d.process_index for d in mesh.devices.flat}) > 1)

    def place(x_host, spec_tail=(None,)):
        """Host array -> device, distributed onto the mesh when one is set
        (required for meshes spanning processes; harmless single-process).
        ``spec_tail``: partition dims after the leading (K, 2, walkers)."""
        x_dev = jnp.asarray(x_host)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            return jax.device_put(
                x_dev, NamedSharding(mesh, P(None, None, axis_name,
                                             *spec_tail)))
        return x_dev

    def to_host(a):
        if multiprocess:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(a, tiled=True))
        return np.asarray(a)

    base = jr.PRNGKey(seed)

    def make_xs(start, n):
        """Per-step inputs for global step indices [start, start+n): K rung
        keys + 1 swap key all folded from the step index, so any segmentation
        of the run draws the identical stream."""
        idx = jnp.arange(start, start + n)

        def keys_for(i):
            ks = jr.split(jr.fold_in(base, i), K + 1)
            return ks[:K], ks[K]

        step_keys, swap_keys = jax.vmap(keys_for)(idx)
        parities = idx % 2 == 1
        return step_keys, swap_keys, parities

    # host-side segment loop over the (burn-in + production) step range;
    # production outputs accumulate in blocks
    total = nsteps_burnin + nsteps
    blocks = {"logl": [], "acc": [], "swap": [], "cold": []}
    # semantic fingerprint of the target (model physics + priors + data +
    # rescaling): same-shaped ladders for DIFFERENT models would otherwise
    # pass every structural resume check below
    fns_digest = (hashlib.sha1(repr(fns_key).encode()).hexdigest()
                  if fns_key is not None else "")
    if resume_from is not None:
        ck = np.load(resume_from)
        saved_digest = str(ck["fns_digest"][()]) if "fns_digest" in ck else ""
        if fns_digest and saved_digest and saved_digest != fns_digest:
            raise ValueError("checkpoint was written by a run with a different "
                             "model/priors/photometry (fns fingerprint "
                             "mismatch); resume each model from its own "
                             "checkpoint file")
        if ck["x"].shape != (K, 2, half, ndim):
            raise ValueError(f"checkpoint ladder shape {ck['x'].shape} does not "
                             f"match this run {(K, 2, half, ndim)}")
        if int(ck["seed"]) != int(seed):
            raise ValueError(f"checkpoint seed {int(ck['seed'])} != run seed {seed} "
                             "(the resumed chain would not continue the same stream)")
        if int(ck["nsteps_burnin"]) != int(nsteps_burnin):
            raise ValueError(f"checkpoint nsteps_burnin {int(ck['nsteps_burnin'])} != "
                             f"{nsteps_burnin}: the burn-in/production boundary would "
                             "shift and the saved production outputs would be wrong")
        run_sd = np.dtype(state_dtype) if state_dtype is not None else np.float64
        if "state_dtype" in ck and str(ck["state_dtype"][()]) != str(run_sd):
            # e.g. a GPU run (auto -> rescaled float32 coordinates) resumed on
            # CPU (auto -> absolute float64): the saved walkers live in a
            # DIFFERENT coordinate system than this run's fns expect
            raise ValueError(f"checkpoint state_dtype {ck['state_dtype'][()]} != "
                             f"{run_sd}: the saved walkers are in a different "
                             "state representation; resume with the original "
                             "state_dtype setting")
        if not np.allclose(np.asarray(ck["betas"]), np.asarray(betas_all)):
            raise ValueError("checkpoint beta ladder does not match this run's "
                             "(different n_rungs/alpha?); resume with the "
                             "original ladder settings")
        carry = (place(ck["x"]), place(ck["logpri"], spec_tail=()),
                 place(ck["logl"], spec_tail=()))
        steps_done = int(ck["steps_done"])
        if steps_done > total:
            raise ValueError(f"checkpoint already contains {steps_done} steps "
                             f"(> nsteps_burnin + nsteps = {total}); resume "
                             "with at least the original nsteps")
        if ck["prod_logl"].size:
            blocks["logl"].append(ck["prod_logl"])
            blocks["acc"].append(ck["prod_acc"])
            blocks["swap"].append(ck["prod_swap"])
            blocks["cold"].append(ck["prod_cold"])
    else:
        # state_dtype=float32 runs the ladder's walker state (and proposal
        # draws) in f32 — the caller wraps the fns in an affine rescaling so
        # O(1) values make that safe (see fitting._tempered_setup)
        x0 = place(np.asarray(np.broadcast_to(p0.reshape(1, 2, half, ndim),
                                              (K, 2, half, ndim)),
                              dtype=state_dtype or np.float64))
        carry = init_carry(x0)
        steps_done = 0

    def save_checkpoint():
        prod_logl = (np.concatenate(blocks["logl"]) if blocks["logl"]
                     else np.empty((0, K, 2, half)))
        from ..utils.checkpoint_io import atomic_savez
        atomic_savez(checkpoint_file,
                 x=to_host(carry[0]), logpri=to_host(carry[1]),
                 logl=to_host(carry[2]), steps_done=steps_done, seed=seed,
                 betas=np.asarray(betas_all), fns_digest=fns_digest,
                 state_dtype=str(np.dtype(state_dtype)
                                 if state_dtype is not None else np.float64),
                 nsteps=nsteps, nsteps_burnin=nsteps_burnin,
                 prod_logl=prod_logl,
                 prod_acc=(np.concatenate(blocks["acc"]) if blocks["acc"]
                           else np.empty((0, K, 2, half))),
                 prod_swap=(np.concatenate(blocks["swap"]) if blocks["swap"]
                            else np.empty((0, K, 2, half))),
                 prod_cold=(np.concatenate(blocks["cold"]) if blocks["cold"]
                            else np.empty((0, 2, half, ndim))))

    # device-resident production outputs: un-checkpointed single-process runs
    # execute production as one scan segment, so nothing forces the big
    # logl/acc/swap arrays through the host link
    fast = (not host_arrays and checkpoint_every is None
            and resume_from is None and not multiprocess)
    dev_out = None
    while steps_done < total:
        in_burn = steps_done < nsteps_burnin
        phase_end = nsteps_burnin if in_burn else total
        seg = phase_end - steps_done
        if checkpoint_every is not None:
            seg = min(seg, checkpoint_every)
        xs = make_xs(steps_done, seg)
        if in_burn:
            carry = run_burn(carry, xs)
        else:
            carry, (ls, acc, sw, cold) = run_prod(carry, xs)
            if fast:
                dev_out = (ls, acc, sw, cold)
            else:
                blocks["logl"].append(to_host(ls))
                blocks["acc"].append(to_host(acc))
                blocks["swap"].append(to_host(sw))
                blocks["cold"].append(to_host(cold))
        steps_done += seg
        if checkpoint_every is not None:
            # save after EVERY segment: segment boundaries are clipped to the
            # burn-in/production phase edge, so steps_done drifts off the
            # checkpoint_every cadence whenever nsteps_burnin is not a
            # multiple of it — a modulo condition would then silently stop
            # saving for the rest of the run
            save_checkpoint()

    if fast:
        ls, acc, sw, cold = dev_out
        amb = jnp.float64 if jax.config.x64_enabled else jnp.float32
        logl_samples = ls.reshape(nsteps, K, nwalkers)   # stays on device
        acceptance = np.asarray(jnp.mean(
            acc.astype(amb).reshape(nsteps, K, nwalkers), axis=(0, 2)))
        swap_rate = np.asarray(jnp.mean(
            sw.astype(amb).reshape(nsteps, K, nwalkers), axis=(0, 2)))
        cold_chain = (np.asarray(cold).reshape(nsteps, nwalkers, ndim)
                      if need_cold else None)
        return logl_samples, acceptance, swap_rate, cold_chain

    logl_samples = np.concatenate(blocks["logl"]).reshape(nsteps, K, nwalkers)
    acceptance = np.concatenate(blocks["acc"]).reshape(nsteps, K, nwalkers).mean((0, 2))
    swap_rate = np.concatenate(blocks["swap"]).reshape(nsteps, K, nwalkers).mean((0, 2))
    cold_chain = (np.concatenate(blocks["cold"]).reshape(nsteps, nwalkers, ndim)
                  if need_cold else None)
    return logl_samples, acceptance, swap_rate, cold_chain


class _LRUCache(dict):
    """Bounded compiled-kernel cache: a sweep over many distinct transients
    gets a new photometry digest per call, and each entry pins compiled
    executables plus the likelihood closure's device arrays — unbounded
    growth would leak host and HBM memory. LRU beyond ``maxsize``."""

    def __init__(self, maxsize):
        super().__init__()
        self.maxsize = maxsize

    def get(self, key, default=None):
        if key in self:
            val = super().pop(key)
            super().__setitem__(key, val)      # mark most-recently-used
            return val
        return default

    def __setitem__(self, key, val):
        if key in self:
            super().pop(key)
        elif len(self) >= self.maxsize:
            super().pop(next(iter(self)))      # evict least-recently-used
        super().__setitem__(key, val)


_LADDER_CACHE = _LRUCache(8)
_TERMS_CACHE = _LRUCache(16)


def _rung_block_terms(logl_samples, dbetas, boundaries):
    """Stepping-stone block terms t[b, k] = log mean exp(dbeta_k * logl_k)
    over production block b, as one jitted device reduction.

    Every call path goes through this one compiled function — device-resident
    logl in the un-checkpointed fast path, re-uploaded host logl after a
    checkpointed/resumed run — so a resumed run reproduces the uninterrupted
    run's log Z **bitwise** (the arithmetic venue never changes), while the
    fast path never ships the (nsteps, K, nwalkers) logl array to the host.
    """
    ll = jnp.asarray(logl_samples)
    K = len(dbetas)
    key = (ll.shape, str(ll.dtype), tuple(boundaries), dbetas.tobytes())
    fn = _TERMS_CACHE.get(key)
    if fn is None:
        db = jnp.asarray(dbetas)
        amb = jnp.float64 if jax.config.x64_enabled else jnp.float32

        def f(ll_):
            w = db[None, :, None].astype(amb) * ll_[:, :K, :].astype(amb)
            outs = []
            for b0, b1 in boundaries:      # static python loop: <= 4 blocks
                wb = w[b0:b1]
                m = jnp.max(wb, axis=(0, 2))
                outs.append(m + jnp.log(jnp.mean(jnp.exp(wb - m[None, :, None]),
                                                 axis=(0, 2))))
            return jnp.stack(outs)

        fn = jax.jit(f)
        _TERMS_CACHE[key] = fn
    return np.asarray(fn(ll), np.float64)


def stepping_stone_evidence(log_prior_fn, log_like_fn, p0, n_rungs=32,
                            nsteps=500, nsteps_burnin=500, alpha=0.3, a=2.0,
                            seed=0, return_cold_chain=False, mesh=None,
                            axis_name="walkers", checkpoint_every=None,
                            checkpoint_file=None, resume_from=None,
                            state_dtype=None, fns_key=None):
    """log Z and its uncertainty from one compiled tempered-ladder run.

    p0: (nwalkers, ndim) starting positions, drawn from (or near) the prior;
    every rung starts from the same cloud. Returns (log_z, log_z_err, info)
    where info carries the ladder, per-rung contributions, per-rung stretch
    acceptance and swap rates — and, with ``return_cold_chain``, the beta = 1
    rung's production states: the parallel-tempering posterior sample, whose
    replica-exchange moves hop between modes the plain stretch move cannot
    cross. The error is a 4-block split of the production chain (block
    estimates of each rung's term, combined in quadrature), which captures
    both MC noise and slow mixing.
    """
    betas_all = make_beta_ladder(n_rungs, alpha)   # includes beta = 1 (cold)
    dbetas = np.diff(betas_all)
    K = n_rungs                                     # stepping-stone rungs 0..K-1
    logl_samples, acceptance, swap_rate, cold_chain = _run_tempered_ladder(
        log_prior_fn, log_like_fn, p0, betas_all, nsteps, nsteps_burnin,
        a=a, seed=seed, mesh=mesh, axis_name=axis_name,
        checkpoint_every=checkpoint_every, checkpoint_file=checkpoint_file,
        resume_from=resume_from, state_dtype=state_dtype,
        host_arrays=False, need_cold=return_cold_chain, fns_key=fns_key)
    nsteps_out = logl_samples.shape[0]

    # block terms on device (_rung_block_terms: the big logl array only
    # crosses the host link in checkpointed/resumed runs, which already paid
    # it); the full-chain terms combine exactly from the block partials:
    # log mean_N exp(w) = log( sum_b n_b exp(t_b) / N )
    n_blocks = min(4, nsteps_out)
    boundaries = tuple((int(ix[0]), int(ix[-1]) + 1)
                       for ix in np.array_split(np.arange(nsteps_out), n_blocks))
    block_terms = _rung_block_terms(logl_samples, dbetas, boundaries)
    sizes = np.array([b1 - b0 for b0, b1 in boundaries], float)
    m = np.max(block_terms, axis=0)
    terms = m + np.log(np.einsum("b,bk->k", sizes, np.exp(block_terms - m))
                       / sizes.sum())
    log_z = float(terms.sum())

    if n_blocks >= 2:
        log_z_err = float(np.sqrt(np.sum(block_terms.var(axis=0, ddof=1)
                                         / block_terms.shape[0])))
    else:
        log_z_err = float("inf")  # a 1-step chain has no internal error estimate

    info = {"betas": betas_all, "rung_terms": terms, "acceptance": acceptance,
            "swap_rate": swap_rate, "n_rungs": n_rungs, "nsteps": nsteps}
    if return_cold_chain:
        info["cold_chain"] = cold_chain
        info["cold_logl"] = np.asarray(logl_samples[:, -1, :])
    return log_z, log_z_err, info
