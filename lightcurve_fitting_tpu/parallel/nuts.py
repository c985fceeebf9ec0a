"""No-U-Turn sampler (NUTS): dynamic-trajectory HMC, jit-compiled end-to-end.

Why it exists here: round-2 validation (VALIDATION.md) showed the flagship
posterior is a thin curved ridge on which fixed-length HMC needs hand-picked
trajectory lengths and the stretch-move ensemble contracts for thousands of
steps. NUTS adapts the trajectory per transition — the standard remedy
(Hoffman & Gelman 2014; multinomial variant per Betancourt 2017). The
reference package cannot offer any gradient-based sampler at all (numpy
models, models.py throughout).

Accelerator-first design decisions:

* **Full-trajectory buffering.** Astronomy-model posteriors here are tiny
  (ndim ~ 4-10), so a transition keeps *every* visited state in a fixed
  ``(2^max_depth, ndim)`` buffer instead of the O(max_depth) checkpoint
  stack classic implementations need. That turns the subtree U-turn checks
  into masked vector reductions over static shapes — compiler-friendly, no
  recursion, no dynamic shapes.
* One transition is a ``lax.while_loop`` over tree doublings; each doubling
  integrates ``2^depth`` leapfrog steps with a ``lax.fori_loop`` (traced trip
  count). Chains are ``vmap``-ed; the whole chain history is one
  ``lax.scan``.
* Divergences (|dH| > 1000) invalidate the subtree, matching Stan.

API parallels :class:`HMCSampler`; the product entry point is
``fitting.lightcurve_hmc(..., sampler="nuts")``, which composes this with the
bounds bijection + whitening.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

__all__ = ["NUTSSampler"]

_DIVERGENCE = 1000.0


def _validate_chain_mesh(mesh, axis_name, nchains):
    """Resolve the chain-sharding axis name and validate divisibility; returns
    the axis name (None when unsharded)."""
    if mesh is None:
        return None
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    if nchains % n_dev:
        raise ValueError(f"nchains={nchains} must be divisible by the mesh's "
                         f"{axis_name!r} axis size {n_dev}")
    return axis_name


def _leapfrog(logp_and_grad, q, p, g, eps, inv_mass):
    """One kick-drift-kick step reusing the entry gradient ``g`` (it equals
    the previous step's exit gradient, so threading it through the trajectory
    halves the gradient evaluations — the dominant NUTS cost); NaN-safe
    gradients (out-of-support points carry zero gradient and are killed by
    their -inf weight instead). Returns (q, p, logp, exit gradient)."""
    p = p + 0.5 * eps * g
    q = q + eps * inv_mass * p
    logp, g2 = logp_and_grad(q)
    g2 = jnp.where(jnp.isfinite(g2), g2, 0.0)
    p = p + 0.5 * eps * g2
    return q, p, logp, g2


def _subtree_turns(Q, P, n_new, direction, inv_mass, max_len):
    """Any U-turn inside the freshly built subtree.

    Q, P: (max_len, ndim) buffers holding the subtree's states in generation
    order (only the first ``n_new`` rows are valid). The doubling structure
    requires the check between the endpoints of every aligned power-of-two
    block; blocks are enumerated per level with static shapes and masked by
    validity. ``direction`` orients the displacement into forward time.
    """
    V = P * inv_mass
    turned = jnp.asarray(False)
    levels = int(np.log2(max_len)) if max_len > 1 else 0
    for k in range(1, levels + 1):
        size = 2 ** k
        starts = jnp.arange(0, max_len, size)
        ends = starts + size - 1
        valid = ends < n_new
        s = jnp.where(valid, starts, 0)
        e = jnp.where(valid, ends, 0)
        dq = direction * (Q[e] - Q[s])                      # (nblocks, ndim)
        bad = (jnp.sum(V[s] * dq, axis=-1) < 0.0) | (jnp.sum(V[e] * dq, axis=-1) < 0.0)
        turned = turned | jnp.any(bad & valid)
    return turned


def _ends_turn(q_l, p_l, q_r, p_r, inv_mass):
    dq = q_r - q_l
    return (jnp.sum(p_l * inv_mass * dq) < 0.0) | (jnp.sum(p_r * inv_mass * dq) < 0.0)


def make_nuts_transition(log_prob_fn, ndim, max_depth=8):
    """Build ``transition(q, logp, key, eps, inv_mass) -> (q', logp', stats)``
    for one chain; vmap over chains. ``stats`` = (accept_stat, depth,
    diverged)."""
    logp_and_grad = jax.value_and_grad(log_prob_fn)
    max_len = 2 ** (max_depth - 1) if max_depth > 1 else 1

    def transition(q0, logp0, key, eps, inv_mass):
        k_mom, k_loop = jr.split(key)
        p0 = jr.normal(k_mom, (ndim,)) / jnp.sqrt(inv_mass)
        h0 = -logp0 + 0.5 * jnp.sum(p0 * p0 * inv_mass)

        def build_subtree(end_q, end_p, direction, n_steps, key):
            """Integrate ``n_steps`` leapfrogs from one tree end; returns the
            buffered states, their weights, the new end, the subtree's
            multinomial proposal, and validity stats."""
            Q = jnp.zeros((max_len, ndim), q0.dtype)
            P = jnp.zeros((max_len, ndim), q0.dtype)
            logw = jnp.full((max_len,), -jnp.inf, q0.dtype)
            logps = jnp.zeros((max_len,), q0.dtype)
            alphas = jnp.zeros((max_len,), q0.dtype)

            # one gradient evaluation seeds the subtree; every later step
            # reuses its predecessor's exit gradient (n_steps + 1 evals per
            # subtree instead of 2 n_steps)
            _, g_e = logp_and_grad(end_q)
            g_e = jnp.where(jnp.isfinite(g_e), g_e, 0.0)

            def body(i, carry):
                q, p, g, Q, P, logw, logps, alphas = carry
                q, p, logp, g = _leapfrog(logp_and_grad, q, p, g,
                                          direction * eps, inv_mass)
                h = -logp + 0.5 * jnp.sum(p * p * inv_mass)
                h = jnp.where(jnp.isnan(h), jnp.inf, h)
                Q = Q.at[i].set(q)
                P = P.at[i].set(p)
                logw = logw.at[i].set(h0 - h)
                logps = logps.at[i].set(logp)
                alphas = alphas.at[i].set(jnp.minimum(1.0, jnp.exp(h0 - h)))
                return q, p, g, Q, P, logw, logps, alphas

            q_e, p_e, _g_e, Q, P, logw, logps, alphas = jax.lax.fori_loop(
                0, n_steps, body, (end_q, end_p, g_e, Q, P, logw, logps, alphas))

            in_range = jnp.arange(max_len) < n_steps
            diverged = jnp.any(in_range & (logw < -_DIVERGENCE))
            turned = _subtree_turns(Q, P, n_steps, direction, inv_mass, max_len)
            logw_masked = jnp.where(in_range, logw, -jnp.inf)
            logW = jax.scipy.special.logsumexp(logw_masked)
            # multinomial draw from the subtree via Gumbel argmax
            g = -jnp.log(-jnp.log(jr.uniform(key, (max_len,))))
            idx = jnp.argmax(logw_masked + g)
            alpha_sum = jnp.sum(jnp.where(in_range, alphas, 0.0))
            return (Q[idx], logps[idx], logW, q_e, p_e, turned | diverged,
                    diverged, alpha_sum)

        # loop state: tree ends, proposal, total weight, flags, rng
        init = (q0, p0, q0, p0,            # left end, right end
                q0, logp0,                 # current proposal
                jnp.asarray(0.0, q0.dtype),  # logW of the accepted tree (w0 = 1)
                jnp.asarray(False), jnp.asarray(False),  # turned, diverged
                jnp.asarray(0, jnp.int32),               # depth
                jnp.asarray(0.0, q0.dtype), jnp.asarray(0.0, q0.dtype),  # alpha sum/count
                k_loop)

        def cond(state):
            turned, diverged, depth = state[7], state[8], state[9]
            return jnp.logical_and(depth < max_depth,
                                   jnp.logical_not(turned | diverged))

        def body(state):
            (q_l, p_l, q_r, p_r, q_prop, logp_prop, logW, turned, diverged,
             depth, a_sum, a_cnt, key) = state
            key, k_dir, k_sel, k_acc = jr.split(key, 4)
            direction = jnp.where(jr.bernoulli(k_dir), 1.0, -1.0).astype(q0.dtype)
            n_steps = jnp.asarray(2, jnp.int32) ** depth
            end_q = jnp.where(direction > 0, q_r, q_l)
            end_p = jnp.where(direction > 0, p_r, p_l)
            (q_new, logp_new, logW_new, q_e, p_e, bad_subtree, div_new,
             alpha_sum) = build_subtree(end_q, end_p, direction, n_steps, k_sel)

            # biased progressive sampling: take the new subtree's proposal
            # with probability min(1, W_new / W_old)
            take = jnp.log(jr.uniform(k_acc)) < (logW_new - logW)
            take = take & jnp.logical_not(bad_subtree)
            q_prop = jnp.where(take, q_new, q_prop)
            logp_prop = jnp.where(take, logp_new, logp_prop)

            q_l2 = jnp.where(direction > 0, q_l, q_e)
            p_l2 = jnp.where(direction > 0, p_l, p_e)
            q_r2 = jnp.where(direction > 0, q_e, q_r)
            p_r2 = jnp.where(direction > 0, p_e, p_r)
            # a bad subtree terminates growth without being merged
            logW2 = jnp.where(bad_subtree, logW, jnp.logaddexp(logW, logW_new))
            turned2 = bad_subtree | _ends_turn(q_l2, p_l2, q_r2, p_r2, inv_mass)
            return (jnp.where(bad_subtree, q_l, q_l2), jnp.where(bad_subtree, p_l, p_l2),
                    jnp.where(bad_subtree, q_r, q_r2), jnp.where(bad_subtree, p_r, p_r2),
                    q_prop, logp_prop, logW2, turned2, diverged | div_new,
                    depth + 1, a_sum + alpha_sum, a_cnt + n_steps.astype(q0.dtype), key)

        out = jax.lax.while_loop(cond, body, init)
        (q_l, p_l, q_r, p_r, q_prop, logp_prop, logW, turned, diverged,
         depth, a_sum, a_cnt, _key) = out
        accept_stat = a_sum / jnp.maximum(a_cnt, 1.0)
        return q_prop, logp_prop, (accept_stat, depth, diverged)

    return transition


class NUTSSampler:
    """Multi-chain adaptive NUTS. API parallels :class:`HMCSampler`:
    ``run_mcmc(initial, n_samples, n_warmup)``, ``flatchain``, ``chain``,
    ``acceptance_fraction`` (mean accept-stat), plus ``mean_tree_depth`` and
    ``divergence_rate`` diagnostics.

    ``mesh`` shards the chain axis over a 1-D :class:`jax.sharding.Mesh` —
    chains are independent given the adaptation state, so the per-step
    communication is only the warmup's cross-chain reductions (mean accept
    stat + Welford variance), which XLA lowers to small all-reduces from
    the sharding annotations; production sampling is collective-free."""

    def __init__(self, nchains, ndim, log_prob_fn, max_depth=8, target_accept=0.8,
                 init_step_size=0.1, init_scales=None, seed=None, mesh=None,
                 axis_name=None):
        self.nchains = int(nchains)
        self.ndim = int(ndim)
        self.max_depth = int(max_depth)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.init_scales = (np.ones(ndim) if init_scales is None
                            else np.asarray(init_scales, float))
        self._log_prob_fn = log_prob_fn
        self._transition = make_nuts_transition(log_prob_fn, self.ndim, self.max_depth)
        self.mesh = mesh
        self.axis_name = _validate_chain_mesh(mesh, axis_name, self.nchains)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        # per-step keys fold the global step index: chains are identical
        # however a run is segmented (enables exact checkpoint/resume)
        self._base_key = jr.PRNGKey(seed)
        self._draw_count = 0
        self.reset()

    def _take_keys(self, n):
        idx = jnp.arange(self._draw_count, self._draw_count + n)
        self._draw_count += n
        return jax.vmap(lambda i: jr.fold_in(self._base_key, i))(idx)

    def _sharding(self, *spec):
        from jax.sharding import NamedSharding, PartitionSpec
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    # ----------------------------------------------------------- checkpointing
    def save_checkpoint(self, filename, extra=None):
        """Serialize sampler state for exact resume: RNG base key + step
        counter, last chain positions, accumulated chain + stats, and the
        adapted kinetic terms. Meaningful once adaptation has run (the
        warmup scan is atomic — a kill during warmup restarts it)."""
        if self._last_pos is None:
            raise ValueError("nothing to checkpoint: no run has completed")
        state = {
            "key": jr.key_data(self._base_key),
            "draw_count": self._draw_count,
            "pos": self._last_pos,
            "logp": self._last_logp,
            "chain": self._chain,
            "accept_sum": self._accept_sum,
            "depth_sum": self._depth_sum,
            "divergences": self._divergences,
            "nsteps": self._nsteps,
            "step_size": self.step_size if self.step_size is not None else np.nan,
            "inv_mass": (self.inv_mass if self.inv_mass is not None
                         else np.full(self.ndim, np.nan)),
            "nchains": self.nchains,
            "ndim": self.ndim,
            # the tree budget is baked into the compiled transition: a resume
            # with a different max_depth would silently fork the chain
            "max_depth": self.max_depth,
        }
        for k, v in (extra or {}).items():
            state["extra_" + k] = v
        from ..utils.checkpoint_io import atomic_savez
        atomic_savez(filename, **state)

    def load_checkpoint(self, filename):
        """Restore :meth:`save_checkpoint` state; returns the extras dict."""
        data = np.load(filename)
        if int(data["nchains"]) != self.nchains or int(data["ndim"]) != self.ndim:
            raise ValueError("checkpoint shape mismatch: "
                             f"{int(data['nchains'])}x{int(data['ndim'])} vs "
                             f"{self.nchains}x{self.ndim}")
        if "max_depth" in data and int(data["max_depth"]) != self.max_depth:
            raise ValueError(f"checkpoint max_depth mismatch: "
                             f"{int(data['max_depth'])} vs {self.max_depth}; "
                             "resume with the original setting for an exact "
                             "continuation")
        self._base_key = jr.wrap_key_data(jnp.asarray(data["key"]))
        self._draw_count = int(data["draw_count"])
        self._last_pos = np.asarray(data["pos"])
        self._last_logp = np.asarray(data["logp"]) if "logp" in data else None
        self._chain = data["chain"]
        self._accept_sum = data["accept_sum"]
        self._depth_sum = data["depth_sum"]
        self._divergences = data["divergences"]
        self._nsteps = int(data["nsteps"])
        eps = float(data["step_size"])
        self.step_size = None if np.isnan(eps) else eps
        im = np.asarray(data["inv_mass"])
        self.inv_mass = None if np.isnan(im).all() else im
        return {k[len("extra_"):]: data[k][()] for k in data.files
                if k.startswith("extra_")}

    def reset(self):
        self._chain = np.empty((0, self.nchains, self.ndim))
        self._accept_sum = np.zeros(self.nchains)
        self._depth_sum = np.zeros(self.nchains)
        self._divergences = np.zeros(self.nchains)
        self._nsteps = 0
        self.step_size = None
        self.inv_mass = None
        self._last_pos = None
        self._last_logp = None

    def run_mcmc(self, initial_state, n_samples, n_warmup=500):
        x_np = np.asarray(initial_state, float)
        x0 = jnp.asarray(x_np)
        if x0.shape != (self.nchains, self.ndim):
            raise ValueError(f"initial_state must be {(self.nchains, self.ndim)}")
        if (self._last_logp is not None and self._last_pos is not None
                and np.array_equal(x_np, self._last_pos)):
            # bit-exact continuation: the carried logp can differ from a
            # recomputation in the last ulp (value_and_grad vs plain eval),
            # which would fork a resumed chain from the uninterrupted one
            logp0 = jnp.asarray(self._last_logp)
        else:
            logp0 = jax.vmap(self._log_prob_fn)(x0)
        if not bool(jnp.all(jnp.isfinite(logp0))):
            raise ValueError("non-finite initial log-probability")
        if n_warmup == 0:
            # continuation: sample with the previously adapted kinetic terms
            # (an empty warmup scan would silently collapse inv_mass to 1e-20)
            return self._run_adapted(x0, logp0, n_samples)
        if n_warmup < 2:
            raise ValueError("n_warmup must be 0 (continue a previously "
                             "adapted sampler) or >= 2")

        transition = self._transition
        nchains = self.nchains
        gamma, t0, kappa = 0.05, 10.0, 0.75

        def make_warmup_step(mu):
            def warmup_step(carry, key):
                x, logp, inv_mass, log_eps, log_eps_bar, h_bar, m, mean, m2, i = carry
                keys = jr.split(key, nchains)
                eps = jnp.exp(log_eps)
                x, logp, (astat, _depth, _div) = jax.vmap(
                    lambda xi, li, ki: transition(xi, li, ki, eps, inv_mass)
                )(x, logp, keys)
                a = jnp.mean(astat)
                h_bar = (1.0 - 1.0 / (i + 1 + t0)) * h_bar \
                    + (self.target_accept - a) / (i + 1 + t0)
                log_eps = mu - jnp.sqrt(i + 1.0) / gamma * h_bar
                w = (i + 1.0) ** (-kappa)
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
                m = m + nchains
                delta = x - mean
                mean = mean + jnp.sum(delta, axis=0) / m
                m2 = m2 + jnp.sum(delta * (x - mean), axis=0)
                return (x, logp, inv_mass, log_eps, log_eps_bar, h_bar,
                        m, mean, m2, i + 1.0), None
            return warmup_step

        def run_fn(x, logp, wkeys1, wkeys2):
            inv_mass0 = jnp.asarray(self.init_scales ** 2)
            mu = jnp.log(10.0 * self.init_step_size)
            carry = (x, logp, inv_mass0, jnp.log(self.init_step_size),
                     jnp.log(self.init_step_size), 0.0, 0.0,
                     jnp.zeros(self.ndim), jnp.zeros(self.ndim), 0.0)
            carry, _ = jax.lax.scan(make_warmup_step(mu), carry, wkeys1)
            x, logp, _, _, log_eps_bar, _, m, mean, m2, _ = carry
            var = m2 / jnp.maximum(m - 1.0, 1.0)
            inv_mass = jnp.maximum(var, 1e-20)
            mu2 = jnp.log(10.0) + log_eps_bar
            carry = (x, logp, inv_mass, log_eps_bar, log_eps_bar, 0.0, 0.0,
                     jnp.zeros(self.ndim), jnp.zeros(self.ndim), 0.0)
            carry, _ = jax.lax.scan(make_warmup_step(mu2), carry, wkeys2)
            x, logp, _, _, log_eps_bar, _, _, _, _, _ = carry
            return x, logp, jnp.exp(log_eps_bar), inv_mass

        if self.mesh is None:
            run = jax.jit(run_fn)
        else:
            ax = self.axis_name
            s = self._sharding
            run = jax.jit(run_fn,
                          in_shardings=(s(ax, None), s(ax), s(), s()),
                          out_shardings=(s(ax, None), s(ax), s(), s()))

        n_w1 = (2 * n_warmup) // 3
        x, logp, eps, inv_mass = run(x0, logp0, self._take_keys(n_w1),
                                     self._take_keys(n_warmup - n_w1))
        self.step_size = float(eps)
        self.inv_mass = np.asarray(inv_mass)
        # production always runs through the ONE compiled sample kernel (the
        # warmup jit compiling its own sample scan produced last-ulp codegen
        # differences vs the continuation path, forking resumed chains)
        return self._sample(x, logp, n_samples)

    def _sample_jitted(self):
        """The shared production kernel: sampling is bitwise identical
        whether reached from warmup, continuation, or checkpoint resume."""
        if getattr(self, "_sample_run", None) is not None:
            return self._sample_run
        transition = self._transition
        nchains = self.nchains

        def run_fn(x, logp, eps, inv_mass, skeys):
            def sample_step(carry, key):
                x, logp = carry
                keys = jr.split(key, nchains)
                x, logp, stats = jax.vmap(
                    lambda xi, li, ki: transition(xi, li, ki, eps, inv_mass)
                )(x, logp, keys)
                return (x, logp), (x, stats)

            (x, logp), (xs, stats) = jax.lax.scan(sample_step, (x, logp), skeys)
            return xs, stats, logp

        if self.mesh is None:
            self._sample_run = jax.jit(run_fn)
        else:
            ax = self.axis_name
            s = self._sharding
            self._sample_run = jax.jit(
                run_fn,
                in_shardings=(s(ax, None), s(ax), s(), s(), s()),
                out_shardings=(s(None, ax, None),
                               (s(None, ax), s(None, ax), s(None, ax)),
                               s(ax)))
        return self._sample_run

    def _sample(self, x0, logp0, n_samples):
        run = self._sample_jitted()
        xs, (astat, depth, div), logp_f = run(x0, logp0,
                                              jnp.asarray(self.step_size),
                                              jnp.asarray(self.inv_mass),
                                              self._take_keys(n_samples))
        self._chain = np.concatenate([self._chain, np.asarray(xs)])
        self._accept_sum += np.asarray(astat).sum(0)
        self._depth_sum += np.asarray(depth, float).sum(0)
        self._divergences += np.asarray(div, float).sum(0)
        self._nsteps += n_samples
        self._last_pos = np.asarray(xs[-1])
        self._last_logp = np.asarray(logp_f)
        return self._last_pos

    def _run_adapted(self, x0, logp0, n_samples):
        """Sampling-only run at the stored (step_size, inv_mass)."""
        if self.step_size is None or self.inv_mass is None:
            raise ValueError("n_warmup=0 requires a previous adapted run "
                             "(no stored step_size/inv_mass)")
        return self._sample(x0, logp0, n_samples)

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self.ndim)

    @property
    def acceptance_fraction(self):
        return self._accept_sum / max(self._nsteps, 1)

    @property
    def mean_tree_depth(self):
        return float(self._depth_sum.sum() / max(self._nsteps * self.nchains, 1))

    @property
    def divergence_rate(self):
        return float(self._divergences.sum() / max(self._nsteps * self.nchains, 1))
