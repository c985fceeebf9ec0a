"""Affine-invariant ensemble MCMC (Goodman & Weare 2010 stretch move), the
jitted replacement for ``emcee.EnsembleSampler`` as used by the reference
(fitting.py:130-145, bolometric.py:167-174).

Design
------
The reference evaluates one Python log-posterior per walker per step
(2e5 serial calls at the default fit settings). Here the whole chain is a
single ``lax.scan`` over steps; within a step the two Goodman-Weare
half-ensembles are updated in sequence (red-black, exactly emcee's
``StretchMove``), and each half-update evaluates the log-posterior for all
walkers in the half with one ``vmap`` — one fused batched kernel per
half-step on an accelerator.

Walker state is kept as ``(2, half, ndim)`` so the walker axis can be sharded
across a device mesh: each half-update needs only its own shard plus an
``all_gather`` of the *complementary* half (tiny: half x ndim floats) — see
``lightcurve_fitting_tpu.parallel.mesh``.

Statistical parity with emcee: the proposal z ~ g(z) ∝ 1/sqrt(z) on [1/a, a]
via z = ((a-1)u + 1)^2 / a, acceptance log u < (ndim-1) log z + logp(Y) - logp(X),
both halves updated per step (emcee moves each walker once per iteration).
Chains agree with emcee in distribution, not path (different RNG).
"""


import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

__all__ = ["EnsembleSampler", "make_stretch_kernel", "propose_stretch"]

# auto-downcast chain storage to float32 past this projected history size
_AUTO_STORE_BYTES = 1e9


def propose_stretch(kz, kj, x_move, x_other_global, a=2.0):
    """The Goodman-Weare stretch proposal, shared by every ensemble kernel
    (plain, sharded, tempered): draw z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] with
    key ``kz`` and a partner from the complementary pool with ``kj``,
    return (y, z)."""
    half = x_move.shape[0]
    u = jr.uniform(kz, (half,), dtype=x_move.dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    x_j = pick_partners(kj, half, x_other_global)
    return x_j + z[:, None] * (x_move - x_j), z


def pick_partners(key, n, x_other_global):
    """``n`` stretch-move partners drawn uniformly from the complementary
    pool: exact rows of ``x_other_global`` (a row gather, so no rounding can
    turn a partner into a point near a walker)."""
    j = jr.randint(key, (n,), 0, x_other_global.shape[0])
    return x_other_global[j]


def make_stretch_kernel(log_prob_fn, half, ndim, a=2.0, gather_other=None):
    """Build the per-step stretch-move kernel.

    Parameters
    ----------
    log_prob_fn : callable
        Scalar log-probability ``fn(p[ndim]) -> float`` (pure jax).
    half : int
        Walkers per half-ensemble (local shard size when sharded).
    ndim : int
    a : float
        Stretch scale (emcee default 2).
    gather_other : callable, optional
        Maps the complementary half-ensemble to the *global* complementary
        ensemble. Identity for single-device; ``lax.all_gather`` + reshape when
        the walker axis is sharded.

    Returns
    -------
    step(carry, key) suitable for ``lax.scan``; carry = (x[2, half, ndim],
    logp[2, half]); per-step output = (x, logp, n_accept[2, half] bool).
    """
    batched_logp = jax.vmap(log_prob_fn)
    if gather_other is None:
        gather_other = lambda x: x

    def half_update(key, x_move, x_other_global, logp_move):
        kz, kj, ku = jr.split(key, 3)
        y, z = propose_stretch(kz, kj, x_move, x_other_global, a)
        logp_y = batched_logp(y)
        logp_y = jnp.where(jnp.isnan(logp_y), -jnp.inf, logp_y)
        log_ratio = (ndim - 1.0) * jnp.log(z) + logp_y - logp_move
        accept = jnp.log(jr.uniform(ku, (half,), dtype=x_move.dtype)) < log_ratio
        x_new = jnp.where(accept[:, None], y, x_move)
        logp_new = jnp.where(accept, logp_y, logp_move)
        return x_new, logp_new, accept

    def step(carry, key):
        x, logp = carry
        k1, k2 = jr.split(key)
        x0, lp0, a0 = half_update(k1, x[0], gather_other(x[1]), logp[0])
        x1, lp1, a1 = half_update(k2, x[1], gather_other(x0), logp[1])
        x = jnp.stack([x0, x1])
        logp = jnp.stack([lp0, lp1])
        return (x, logp), (x, logp, jnp.stack([a0, a1]))

    return step, batched_logp


class EnsembleSampler:
    """emcee-compatible ensemble sampler running as one jitted scan.

    Mirrors the emcee API surface the reference uses: ``run_mcmc`` (returning a
    3-tuple whose first element is the walker positions), ``reset``, ``chain``
    (nwalkers, nsteps, ndim), ``flatchain``, ``flatlnprobability``, and
    ``acceptance_fraction``.
    """

    def __init__(self, nwalkers, ndim, log_prob_fn, a=2.0, seed=None, dtype=jnp.float64,
                 store_dtype=None, replicas=1, param_offset=None, param_scale=None):
        """``store_dtype`` (e.g. np.float32) downcasts the *stored* chain
        history — halves host-transfer and memory for long production runs
        (walker state and proposals stay in ``dtype``). The default ``None``
        is auto: runs whose projected history exceeds ~1 GB downcast to
        float32 with a printed note; pass ``np.float64`` to always keep
        full-precision storage.

        ``replicas`` runs that many *independent* ensembles of ``nwalkers``
        walkers inside one vmapped scan. A small ensemble leaves an
        accelerator mostly idle for its fixed per-scan-iteration cost, so
        batching R replicas recovers the large-batch throughput at
        reference-default walker counts; chains are pooled in ``flatchain``
        (independent ensembles sample the same posterior).
        The effective walker count is ``nwalkers * replicas``.

        ``param_offset``/``param_scale`` (ndim,): walkers internally hold the
        affine-rescaled state ``q = (p - offset) / scale``; ``log_prob_fn``
        still receives absolute parameters (reconstructed in float64) and
        every public surface (initial_state, chains, returned positions)
        stays absolute. The stretch move is affine-equivariant, so the
        statistics are identical — the point is that O(1) scaled values make
        ``dtype=float32`` walker state safe (an absolute f32 explosion epoch
        MJD ~5.7e4 quantizes at ~6 min, swamping a 15 s posterior width)."""
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self._store_dtype = store_dtype
        if (param_offset is None) != (param_scale is None):
            raise ValueError("param_offset and param_scale must be given together")
        self._offset = None if param_offset is None else np.asarray(param_offset, float)
        self._scale = None if param_scale is None else np.asarray(param_scale, float)
        if self._scale is not None:
            if self._scale.shape != (int(ndim),) or not np.all(self._scale > 0):
                raise ValueError("param_scale must be (ndim,) positive")
            o = jnp.asarray(self._offset)
            s = jnp.asarray(self._scale)
            user_fn = log_prob_fn
            log_prob_fn = lambda q: user_fn(o + s * q)  # noqa: E731
        if nwalkers < 2 * ndim + 2:
            # same spirit as emcee's guardrail; keep it a warning not an error
            import warnings
            warnings.warn(f"nwalkers={nwalkers} is small for ndim={ndim}; "
                          "the stretch move needs nwalkers >> ndim")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.a = float(a)
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        self._half = self.nwalkers // 2
        self._dtype = dtype
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        # per-step keys are folded from (base key, global step index): the
        # chain is identical however a run is segmented (progress segments,
        # checkpoint_every restarts, kill-and-resume)
        self._base_key = jr.PRNGKey(seed)
        self._draw_count = 0
        self._log_prob_fn = log_prob_fn  # post-rescaling; subclasses rebuild kernels from this
        self._step, self.batched_logp = make_stretch_kernel(log_prob_fn, self._half, self.ndim, a)
        self._run_jit = {}
        self.reset()

    @property
    def total_walkers(self):
        """Walkers across all replicas (= nwalkers when replicas == 1)."""
        return self.nwalkers * self.replicas

    # ------------------------------------------------------------------ state
    def reset(self):
        self._chain = np.empty((0, self.total_walkers, self.ndim))  # (nsteps, walkers, ndim)
        self._logp = np.empty((0, self.total_walkers))
        self._accepted = np.zeros(self.total_walkers)
        self._nsteps_total = 0

    def _compiled_run(self, nsteps, thin_by):
        key = (nsteps, thin_by)
        if key not in self._run_jit:
            step = jax.vmap(self._step) if self.replicas > 1 else self._step
            store = None if self._store_dtype is None else jnp.dtype(self._store_dtype)

            def run(x, logp, keys):
                x = self._wrap_run_state(x)

                def thinned_step(carry, key_block):
                    # accept flags are SUMMED over the whole thin_by block
                    # (int32), so acceptance_fraction counts every proposal,
                    # not just the stored step's
                    def inner(c_acc, k):
                        c, acc = c_acc
                        c, out = step(c, k)
                        return (c, acc + out[2].astype(jnp.int32)), None
                    acc0 = jnp.zeros(x.shape[:-1], jnp.int32)
                    (carry, acc), _ = jax.lax.scan(inner, (carry, acc0),
                                                   key_block[:-1])
                    carry, out = step(carry, key_block[-1])
                    n_accept = acc + out[2].astype(jnp.int32)
                    if store is not None:
                        # downcast the *stored* history inside the scan: the
                        # stacked chain is the biggest per-step memory
                        # write, and the host transfer halves too
                        out = (out[0].astype(store), out[1].astype(store), out[2])
                    out = (out[0], out[1], n_accept)
                    return carry, out

                key_blocks = keys.reshape((nsteps, thin_by) + keys.shape[1:])
                (x, logp), (xs, logps, accepts) = jax.lax.scan(
                    thinned_step, (x, logp), key_blocks)
                return x, logp, xs, logps, accepts

            self._run_jit[key] = jax.jit(run)
        return self._run_jit[key]

    def _state_shape(self):
        """Device-side walker state layout (replica axis only when used)."""
        core = (2, self._half, self.ndim)
        return (self.replicas,) + core if self.replicas > 1 else core

    # hooks the multi-process sharded sampler overrides: host data -> device
    # state placement, and device output -> host numpy (a global array that
    # spans processes is not fully addressable, so np.asarray cannot read it)
    def _prepare_state(self, x):
        return x

    def _wrap_run_state(self, x):
        """In-jit hook on the walker state at the top of the compiled scan;
        the sharded sampler overrides it with a mesh sharding constraint so
        ONE _compiled_run serves both (the scan body must never fork again:
        it drifted once, see the thin_by acceptance-undercount fix)."""
        return x

    def _prepare_logp(self, logp):
        """Placement hook for the per-walker log-prob array (state shape minus
        the parameter axis); the sharded sampler distributes it on its mesh."""
        return logp

    def _to_host(self, a):
        return np.asarray(a)

    # -------------------------------------------------------------- main API
    def run_mcmc(self, initial_state, nsteps, progress=False, progress_kwargs=None,
                 skip_initial_state_check=False, thin_by=1, **kwargs):
        """Advance the ensemble ``nsteps`` iterations from ``initial_state``
        (array of shape (nwalkers, ndim), or None to continue).

        With ``progress=True`` the scan is split into ~10 equal segments so
        acceptance-rate progress lines appear during long runs; otherwise the
        whole chain is one device dispatch."""
        if initial_state is None:
            if not hasattr(self, "_pos_internal"):
                raise ValueError("no previous state; provide initial_state")
            x = self._pos_internal
            logp = self._logp_internal
        else:
            pos = np.ascontiguousarray(np.asarray(initial_state, float))
            if pos.shape != (self.total_walkers, self.ndim):
                raise ValueError(f"initial_state must have shape {(self.total_walkers, self.ndim)}")
            if self._offset is not None:
                pos = (pos - self._offset) / self._scale
            shape = self._state_shape()
            x = self._prepare_state(jnp.asarray(pos.reshape(shape), dtype=self._dtype))
            logp = self.batched_logp(x.reshape(-1, self.ndim)).reshape(shape[:-1])
            if not skip_initial_state_check and not bool(jnp.all(jnp.isfinite(logp))):
                bad = int(jnp.sum(~jnp.isfinite(logp)))
                raise ValueError(f"{bad} walkers have non-finite initial log-probability")

        # bound host memory by default: a 131072-walker x 1000-step x 4-param
        # run would hold 4.2 GB of f64 history. When the projected history
        # passes ~1 GB, store chains as float32 (posterior summaries are
        # unaffected; walker state and proposals stay float64). Explicit
        # store_dtype (e.g. np.float64) disables the auto-downcast.
        if self._store_dtype is None:
            projected = (self._chain.nbytes
                         + nsteps * self.total_walkers * (self.ndim + 1) * 8)
            if projected > _AUTO_STORE_BYTES:
                print(f"chain history would be {projected / 1e9:.1f} GB in "
                      "float64; storing chains as float32 (pass "
                      "store_dtype=np.float64 to keep full precision)")
                self._store_dtype = np.float32
                self._run_jit = {}  # compiled scans baked the old store dtype

        desc = (progress_kwargs or {}).get("desc", "Sampling").strip()
        if progress and nsteps >= 50:
            seg = max(nsteps // 10, 1)
            segments = [seg] * (nsteps // seg)
            if nsteps % seg:
                segments.append(nsteps % seg)
        else:
            segments = [nsteps]
            if progress:
                print(f"{desc}: {nsteps} steps x {self.total_walkers} walkers "
                      f"(single compiled scan)")

        done = 0
        for seg_steps in segments:
            x, logp = self._run_segment(x, logp, seg_steps, thin_by)
            done += seg_steps
            if progress and len(segments) > 1:
                af = self._accepted.mean() / max(self._nsteps_total, 1)
                print(f"{desc}: {done}/{nsteps} steps (mean acceptance {af:.2f})")

        self._pos_internal = x
        self._logp_internal = logp
        pos = self._absolute(self._to_host(x).reshape(self.total_walkers, self.ndim))
        if self._offset is not None and np.dtype(self._dtype) == np.float32:
            # contraction safeguard: warn before the posterior width sinks
            # into f32 quantization of the scaled space
            spread = pos.std(axis=0) / self._scale
            if np.any((spread > 0) & (spread < 32 * np.finfo(np.float32).eps)):
                import warnings
                warnings.warn(
                    "walker spread has contracted below ~32 float32 ulps of "
                    "the rescaled state in at least one dimension; pass "
                    "dtype=jnp.float64 (or a narrower init window) to keep "
                    "resolving the posterior")
        return pos, self._to_host(logp).reshape(self.total_walkers), None

    def _run_segment(self, x, logp, nsteps, thin_by):
        n = nsteps * thin_by
        idx = jnp.arange(self._draw_count, self._draw_count + n)
        self._draw_count += n
        if self.replicas > 1:
            rep = jnp.arange(self.replicas)
            keys = jax.vmap(lambda i: jax.vmap(
                lambda r: jr.fold_in(jr.fold_in(self._base_key, i), r))(rep))(idx)
        else:
            keys = jax.vmap(lambda i: jr.fold_in(self._base_key, i))(idx)
        run = self._compiled_run(nsteps, thin_by)
        x, logp, xs, logps, accepts = run(x, logp, keys)

        # host-side bookkeeping (chain layout: steps-major like emcee
        # get_chain); with store_dtype the scan already emitted downcast
        # arrays — the in-scan cast owns the conversion
        xs = self._to_host(xs)                   # (nsteps, [R,] 2, half, ndim)
        logps_np = self._to_host(logps)
        accepts = self._to_host(accepts)
        chain_block = xs.reshape(nsteps, self.total_walkers, self.ndim)
        logp_block = logps_np.reshape(nsteps, self.total_walkers)
        if self._store_dtype is not None and self._chain.dtype != chain_block.dtype:
            # keep the accumulated history in the store dtype too — otherwise
            # np.concatenate silently promotes the downcast blocks back to
            # float64 and the host memory bound is lost
            self._chain = self._chain.astype(chain_block.dtype)
            self._logp = self._logp.astype(logp_block.dtype)
        self._chain = np.concatenate([self._chain, chain_block])
        self._logp = np.concatenate([self._logp, logp_block])
        self._accepted += accepts.reshape(nsteps, self.total_walkers).sum(0)
        self._nsteps_total += nsteps * thin_by
        return x, logp

    # ----------------------------------------------------------- checkpointing
    def save_checkpoint(self, filename, include_chain=True, extra=None):
        """Serialize the sampler state (walker positions, log-probs, RNG key +
        step counter, and optionally the accumulated chain) for exact resume.
        The reference can only save final flatchains (fitting.py:146-148);
        this adds true resume (SURVEY.md §5). ``extra``: a dict of scalar
        metadata (e.g. the driver's phase bookkeeping) stored alongside and
        returned by :meth:`load_checkpoint`."""
        state = {
            "pos": self._to_host(self._pos_internal),
            "logp": self._to_host(self._logp_internal),
            "key": jr.key_data(self._base_key),
            "draw_count": self._draw_count,
            "accepted": self._accepted,
            "nsteps_total": self._nsteps_total,
            "nwalkers": self.nwalkers,
            "ndim": self.ndim,
            "a": self.a,
            "replicas": self.replicas,
            # state is stored in the internal (rescaled) space; resume must
            # use the identical affine map (empty array = no rescaling)
            "param_offset": self._offset if self._offset is not None else np.array([]),
            "param_scale": self._scale if self._scale is not None else np.array([]),
        }
        if include_chain:
            state["chain"] = self._chain
            state["logp_chain"] = self._logp
        for k, v in (extra or {}).items():
            state["extra_" + k] = v
        from ..utils.checkpoint_io import atomic_savez
        atomic_savez(filename, **state)

    def load_checkpoint(self, filename):
        """Restore state saved by :meth:`save_checkpoint` into this sampler
        (the log-probability function itself is reconstructed by the caller).
        Returns the ``extra`` metadata dict that was saved (empty if none)."""
        data = np.load(filename)
        if int(data["nwalkers"]) != self.nwalkers or int(data["ndim"]) != self.ndim:
            raise ValueError("checkpoint shape mismatch: "
                             f"{int(data['nwalkers'])}x{int(data['ndim'])} vs "
                             f"{self.nwalkers}x{self.ndim}")
        if "replicas" in data and int(data["replicas"]) != self.replicas:
            raise ValueError(f"checkpoint replicas mismatch: {int(data['replicas'])} "
                             f"vs {self.replicas}")
        if "param_offset" in data:
            ck_off = data["param_offset"] if data["param_offset"].size else None
            ck_sc = data["param_scale"] if data["param_scale"].size else None
            same = ((ck_off is None) == (self._offset is None)
                    and (ck_off is None or (np.array_equal(ck_off, self._offset)
                                            and np.array_equal(ck_sc, self._scale))))
            if not same:
                raise ValueError("checkpoint parameter rescaling (param_offset/"
                                 "param_scale) does not match this sampler's; "
                                 "resume with the original settings")
        # re-place the state through the subclass hook: a sharded sampler must
        # distribute the restored walkers onto its (possibly multi-process)
        # mesh, not leave them committed to one local device
        self._pos_internal = self._prepare_state(jnp.asarray(data["pos"]))
        self._logp_internal = self._prepare_logp(jnp.asarray(data["logp"]))
        self._base_key = jr.wrap_key_data(jnp.asarray(data["key"]))
        self._draw_count = int(data["draw_count"])
        self._accepted = data["accepted"]
        self._nsteps_total = int(data["nsteps_total"])
        if "chain" in data:
            self._chain = data["chain"]
            self._logp = data["logp_chain"]
            if self._store_dtype is None and self._chain.dtype == np.float32:
                # the original run auto-downcast its history; keep emitting
                # f32 so the resumed chain stays identical (and bounded)
                # instead of silently promoting back to float64
                self._store_dtype = np.float32
                self._run_jit = {}
        else:
            # a chain-less checkpoint restores counters that no longer
            # correspond to any accumulated history: drop whatever this
            # instance had, or get_chain would prepend an unrelated run
            self._chain = self._chain[:0]
            self._logp = self._logp[:0]
        return {k[len("extra_"):]: data[k][()] for k in data.files
                if k.startswith("extra_")}

    sample = run_mcmc

    # ------------------------------------------------------------- accessors
    def _absolute(self, c):
        """Internal (possibly rescaled) state -> absolute parameter values.
        The map runs in float64 so a float32 scaled store still resolves
        absolute values to (scale * f32 ulp) precision."""
        if self._offset is None:
            return c
        return np.asarray(c, np.float64) * self._scale + self._offset

    def get_chain(self, flat=False, thin=1, discard=0):
        c = self._absolute(self._chain[discard::thin])
        if flat:
            return c.reshape(-1, self.ndim)
        return c

    def get_log_prob(self, flat=False, thin=1, discard=0):
        lp = self._logp[discard::thin]
        return lp.reshape(-1) if flat else lp

    @property
    def chain(self):
        """(nwalkers, nsteps, ndim), emcee's legacy layout (used by the
        reference's chain-history plots, fitting.py:139)."""
        return np.swapaxes(self._absolute(self._chain), 0, 1)

    @property
    def flatchain(self):
        return self.get_chain(flat=True)

    @property
    def lnprobability(self):
        return np.swapaxes(self._logp, 0, 1)

    @property
    def flatlnprobability(self):
        return self._logp.reshape(-1)

    @property
    def acceptance_fraction(self):
        n = max(self._nsteps_total, 1)
        return self._accepted / n

    def get_autocorr_time(self, **kwargs):
        """Integrated autocorrelation time per parameter (Sokal's adaptive
        windowing, as in emcee.autocorr). Diagnostics the reference never
        exposes (SURVEY.md §5 'add them').

        One batched real FFT over (walker, parameter) columns — at bench
        scale (131072 walkers) the round-2 per-walker Python loop was ~500k
        serial FFTs appended to a sub-second sampling run; walker counts
        beyond 4096 are stride-subsampled (the tau estimate is already
        tight at thousands of independent walkers)."""
        return _integrated_autocorr(self._chain)


def _next_pow_two(n):
    i = 1
    while i < n:
        i <<= 1
    return i


def _integrated_autocorr(chain, c=5.0, max_walkers=4096):
    """chain: (nsteps, nwalkers) for one parameter, or (nsteps, nwalkers,
    ndim); returns tau (scalar or (ndim,)). Batched over walkers AND
    parameters in one rfft; per-column normalization matches the per-walker
    1-D estimator exactly (columns with zero variance contribute zeros)."""
    chain = np.asarray(chain, float)
    squeeze = chain.ndim == 2
    if squeeze:
        chain = chain[:, :, None]
    n, w, d = chain.shape
    if w > max_walkers:
        stride = w // max_walkers
        chain = chain[:, ::stride][:, :max_walkers]
    x = chain - chain.mean(axis=0)
    nfft = 2 * _next_pow_two(n)
    f = np.fft.rfft(x, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=0)[:n].real
    # normalize by the exact sum of squares (acf[0] up to fft roundoff):
    # a zero-variance column is then *exactly* zero, not roundoff garbage
    norm = (x * x).sum(axis=0)                     # (nwalkers, ndim)
    good = norm > 0
    acf = np.where(good, acf / np.where(good, norm, 1.0), 0.0)
    fm = acf.mean(axis=1)                          # (nsteps, ndim)
    taus = 2.0 * np.cumsum(fm, axis=0) - 1.0
    window = np.arange(n)[:, None] >= c * taus
    first = np.argmax(window, axis=0)
    hit = np.any(window, axis=0)
    out = np.where(hit, taus[first, np.arange(taus.shape[1])], taus[-1])
    return out[0] if squeeze else out
