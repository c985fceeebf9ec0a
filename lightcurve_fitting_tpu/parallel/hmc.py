"""Gradient-based Hamiltonian Monte Carlo — a capability the reference cannot
offer: its numpy models are not differentiable, while this framework's model
kernels use NaN-free double-where formulations (ops/mathx.py) precisely so
``jax.grad`` flows through the full likelihood (SURVEY.md §7).

Vectorized multi-chain HMC with dual-averaging step-size adaptation (Hoffman &
Gelman 2014, Alg. 5) and diagonal mass-matrix estimation from the warmup
samples. Whole run is one ``lax.scan``; chains are vmapped (and shardable the
same way walkers are). Hard prior boundaries (-inf) reject trajectories via the
Metropolis correction.

For multimodal or boundary-dominated posteriors the stretch-move ensemble
(parallel/sampler.py) remains the default; HMC shines for higher-dimensional
smooth posteriors (e.g. population hierarchies).
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr

__all__ = ["HMCSampler", "BoundsTransform", "WhitenedPosterior"]


class BoundsTransform:
    """Bijection between a box-constrained parameter space and R^n, Stan-style:
    two-sided bounds map through a scaled sigmoid, one-sided through exp,
    unbounded through identity. Removes hard -inf prior cliffs (which force
    the dual-averaged step size toward zero when posterior mass piles against
    a bound) and contributes the log-Jacobian so the transformed density is
    the correct pushforward.

    Masks are static (numpy) so the jax forms stay jit-friendly; unused
    branches are evaluated on sanitized values (double-where) to keep
    gradients NaN-free.
    """

    def __init__(self, lower, upper):
        lower = np.asarray(lower, float)
        upper = np.asarray(upper, float)
        self.lower = lower
        self.upper = upper
        self.two_sided = np.isfinite(lower) & np.isfinite(upper)
        self.lower_only = np.isfinite(lower) & ~np.isfinite(upper)
        self.upper_only = ~np.isfinite(lower) & np.isfinite(upper)
        self.one_sided = self.lower_only | self.upper_only
        # sanitized bounds for the unused branches
        self._lo2 = np.where(self.two_sided, lower, 0.0)
        self._hi2 = np.where(self.two_sided, upper, 1.0)
        self._width = self._hi2 - self._lo2
        self._lo1 = np.where(self.lower_only, lower, 0.0)
        self._hi1 = np.where(self.upper_only, upper, 0.0)

    def to_bounded(self, u):
        """u in R^n -> x in the box (jax)."""
        s = jax.nn.sigmoid(jnp.where(self.two_sided, u, 0.0))
        e = jnp.exp(jnp.where(self.one_sided, u, 0.0))
        x2 = self._lo2 + self._width * s
        x_lo = self._lo1 + e
        x_hi = self._hi1 - e
        x = jnp.where(self.two_sided, x2,
                      jnp.where(self.lower_only, x_lo,
                                jnp.where(self.upper_only, x_hi, u)))
        return x

    def log_jacobian(self, u):
        """log |dx/du| summed over parameters (jax)."""
        u2 = jnp.where(self.two_sided, u, 0.0)
        s = jax.nn.sigmoid(u2)
        two = jnp.log(jnp.where(self.two_sided, self._width, 1.0)) \
            + jnp.where(self.two_sided, jnp.log(s) + jnp.log1p(-s), 0.0)
        one = jnp.where(self.one_sided, u, 0.0)
        return jnp.sum(two + one)

    def to_unbounded(self, x, eps=1e-6):
        """x (host numpy, any leading shape) -> u; values at/beyond a bound are
        clipped ``eps`` inside so the logit stays finite."""
        x = np.asarray(x, float)
        p = np.clip((x - self._lo2) / self._width, eps, 1.0 - eps)
        u2 = np.log(p) - np.log1p(-p)
        gap_lo = np.maximum(x - self._lo1, eps)
        gap_hi = np.maximum(self._hi1 - x, eps)
        return np.where(self.two_sided, u2,
                        np.where(self.lower_only, np.log(gap_lo),
                                 np.where(self.upper_only, np.log(gap_hi), x)))

    def to_unbounded_jax(self, x, eps=1e-6):
        """jax twin of :meth:`to_unbounded` for traced values (used by the
        fused on-device MAP-centering kernel, ``parallel/batched.py``)."""
        p = jnp.clip((x - self._lo2) / self._width, eps, 1.0 - eps)
        u2 = jnp.log(p) - jnp.log1p(-p)
        gap_lo = jnp.maximum(x - self._lo1, eps)
        gap_hi = jnp.maximum(self._hi1 - x, eps)
        return jnp.where(self.two_sided, u2,
                         jnp.where(self.lower_only, jnp.log(gap_lo),
                                   jnp.where(self.upper_only, jnp.log(gap_hi),
                                             x)))


class WhitenedPosterior:
    """Affine reparametrization u = mu + L w of a (transformed) posterior,
    with L the Cholesky factor of a sample covariance estimate. Aligns HMC's
    diagonal unit mass with the posterior's correlation structure (ridge
    geometry), which a per-parameter mass matrix cannot."""

    def __init__(self, samples, jitter=1e-9):
        samples = np.atleast_2d(np.asarray(samples, float))
        self.mean = samples.mean(axis=0)
        cov = np.atleast_2d(np.cov(samples.T))
        scale = np.trace(cov) / cov.shape[0]
        self.L = np.linalg.cholesky(cov + jitter * scale * np.eye(cov.shape[0]))
        self._Lj = jnp.asarray(self.L)
        self._muj = jnp.asarray(self.mean)

    @classmethod
    def from_moments(cls, mean, L):
        """Rebuild from stored (mean, Cholesky factor) — used by checkpoint
        resume, where the warm samples are gone but the affine map must be
        bit-identical for the resumed chain to continue the original."""
        self = cls.__new__(cls)
        self.mean = np.asarray(mean, float)
        self.L = np.asarray(L, float)
        self._Lj = jnp.asarray(self.L)
        self._muj = jnp.asarray(self.mean)
        return self

    def to_u(self, w):
        return self._muj + jnp.matmul(self._Lj, w, precision=jax.lax.Precision.HIGHEST)

    def to_w(self, u):
        """host-side inverse for initializing chains"""
        return np.linalg.solve(self.L, (np.asarray(u, float) - self.mean).T).T

    def u_from_w_chain(self, w_chain):
        """map a (..., ndim) array of whitened samples back (host numpy)"""
        return self.mean + np.asarray(w_chain) @ self.L.T


class HMCSampler:
    """Multi-chain adaptive HMC. API parallels EnsembleSampler where sensible:
    ``run_mcmc(initial, n_samples, n_warmup)``, ``flatchain``, ``chain``,
    ``acceptance_fraction``."""

    def __init__(self, nchains, ndim, log_prob_fn, n_leapfrog=16, target_accept=0.8,
                 init_step_size=0.1, init_scales=None, seed=None, mesh=None,
                 axis_name=None):
        """``init_scales``: rough per-parameter posterior scales; used as the
        warmup mass matrix. Essential for posteriors with strong scale
        hierarchies (e.g. an explosion epoch constrained 1e4x more tightly
        than a temperature) — with a unit mass, dual averaging shrinks the
        step to the stiffest direction and warmup never mixes.

        ``mesh`` shards the chain axis (see :class:`NUTSSampler`: chains are
        independent; only the warmup's cross-chain adaptation reductions
        communicate, as XLA-inserted all-reduces)."""
        from .nuts import _validate_chain_mesh
        self.nchains = int(nchains)
        self.ndim = int(ndim)
        self.n_leapfrog = int(n_leapfrog)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.init_scales = (np.ones(ndim) if init_scales is None
                            else np.asarray(init_scales, float))
        self._logp_and_grad = jax.value_and_grad(log_prob_fn)
        self._log_prob_fn = log_prob_fn
        self.mesh = mesh
        self.axis_name = _validate_chain_mesh(mesh, axis_name, self.nchains)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        # per-step keys fold the global step index (exact checkpoint/resume,
        # see NUTSSampler)
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

    def reset(self):
        self._chain = np.empty((0, self.nchains, self.ndim))
        self._accept_prob_sum = np.zeros(self.nchains)
        self._nsteps = 0
        self.step_size = None
        self.inv_mass = None
        self._last_pos = None
        self._last_logp = None

    # ----------------------------------------------------------- checkpointing
    def save_checkpoint(self, filename, extra=None):
        """Serialize sampler state for exact resume (see
        :meth:`NUTSSampler.save_checkpoint`)."""
        if self._last_pos is None:
            raise ValueError("nothing to checkpoint: no run has completed")
        state = {
            "key": jr.key_data(self._base_key),
            "draw_count": self._draw_count,
            "pos": self._last_pos,
            "logp": self._last_logp,
            "chain": self._chain,
            "accept_prob_sum": self._accept_prob_sum,
            "nsteps": self._nsteps,
            "step_size": self.step_size if self.step_size is not None else np.nan,
            "inv_mass": (self.inv_mass if self.inv_mass is not None
                         else np.full(self.ndim, np.nan)),
            "nchains": self.nchains,
            "ndim": self.ndim,
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
        self._base_key = jr.wrap_key_data(jnp.asarray(data["key"]))
        self._draw_count = int(data["draw_count"])
        self._last_pos = np.asarray(data["pos"])
        self._last_logp = np.asarray(data["logp"]) if "logp" in data else None
        self._chain = data["chain"]
        self._accept_prob_sum = data["accept_prob_sum"]
        self._nsteps = int(data["nsteps"])
        eps = float(data["step_size"])
        self.step_size = None if np.isnan(eps) else eps
        im = np.asarray(data["inv_mass"])
        self.inv_mass = None if np.isnan(im).all() else im
        return {k[len("extra_"):]: data[k][()] for k in data.files
                if k.startswith("extra_")}

    # ------------------------------------------------------------- internals
    def _transition(self, x, logp, key, eps, inv_mass):
        """One HMC transition for a single chain (vmapped by the caller)."""
        k_mom, k_acc, k_jit = jr.split(key, 3)
        p0 = jr.normal(k_mom, (self.ndim,)) / jnp.sqrt(inv_mass)
        # jitter the path length 50-100% to avoid resonances; steps beyond the
        # drawn length are masked to identity (static shapes under jit)
        n_used = jr.randint(k_jit, (), (self.n_leapfrog + 1) // 2, self.n_leapfrog + 1)

        # the entry gradient of each step equals the previous step's exit
        # gradient: thread it through the scan (n_leapfrog + 1 gradient
        # evaluations per trajectory instead of 2 n_leapfrog)
        _, g0 = self._logp_and_grad(x)
        g0 = jnp.where(jnp.isfinite(g0), g0, 0.0)

        def leapfrog(carry, i):
            q, p, g = carry
            p2 = p + 0.5 * eps * g
            q2 = q + eps * inv_mass * p2
            _, g2 = self._logp_and_grad(q2)
            g2 = jnp.where(jnp.isfinite(g2), g2, 0.0)
            p2 = p2 + 0.5 * eps * g2
            active = i < n_used
            return (jnp.where(active, q2, q), jnp.where(active, p2, p),
                    jnp.where(active, g2, g)), ()

        (q_new, p_new, _), _ = jax.lax.scan(leapfrog, (x, p0, g0),
                                            jnp.arange(self.n_leapfrog))
        logp_new = self._log_prob_fn(q_new)
        h0 = logp - 0.5 * jnp.sum(p0 * p0 * inv_mass)
        h1 = logp_new - 0.5 * jnp.sum(p_new * p_new * inv_mass)
        log_accept = jnp.where(jnp.isfinite(h1), h1 - h0, -jnp.inf)
        accept_prob = jnp.minimum(1.0, jnp.exp(jnp.minimum(log_accept, 0.0)))
        accept = jnp.log(jr.uniform(k_acc)) < log_accept
        x_out = jnp.where(accept, q_new, x)
        logp_out = jnp.where(accept, logp_new, logp)
        return x_out, logp_out, accept_prob

    # ---------------------------------------------------------------- run
    def run_mcmc(self, initial_state, n_samples, n_warmup=500):
        x_np = np.asarray(initial_state, float)
        x0 = jnp.asarray(x_np)
        if x0.shape != (self.nchains, self.ndim):
            raise ValueError(f"initial_state must be {(self.nchains, self.ndim)}")
        if (self._last_logp is not None and self._last_pos is not None
                and np.array_equal(x_np, self._last_pos)):
            # bit-exact continuation (see NUTSSampler.run_mcmc)
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

        mu = jnp.log(10.0 * self.init_step_size)
        gamma, t0, kappa = 0.05, 10.0, 0.75

        def make_warmup_step(mu_local):
            def warmup_step(carry, key):
                x, logp, inv_mass, log_eps, log_eps_bar, h_bar, m, mean, m2, i = carry
                keys = jr.split(key, self.nchains)
                eps = jnp.exp(log_eps)
                x, logp, aprob = jax.vmap(
                    lambda xi, li, ki: self._transition(xi, li, ki, eps, inv_mass)
                )(x, logp, keys)
                # dual averaging on the mean acceptance across chains
                a = jnp.mean(aprob)
                h_bar = (1.0 - 1.0 / (i + 1 + t0)) * h_bar \
                    + (self.target_accept - a) / (i + 1 + t0)
                log_eps = mu_local - jnp.sqrt(i + 1.0) / gamma * h_bar
                w = (i + 1.0) ** (-kappa)
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
                # Welford running variance over all chain states
                m = m + self.nchains
                delta = x - mean
                mean = mean + jnp.sum(delta, axis=0) / m
                m2 = m2 + jnp.sum(delta * (x - mean), axis=0)
                return (x, logp, inv_mass, log_eps, log_eps_bar, h_bar,
                        m, mean, m2, i + 1.0), aprob
            return warmup_step

        def run_fn(x, logp, wkeys1, wkeys2):
            # phase 1: adapt eps on the user-provided scale mass, estimate the
            # posterior variance; phase 2: re-adapt eps on the estimated mass
            # (Stan-style windows — eps tuned for one metric is invalid for
            # another)
            inv_mass0 = jnp.asarray(self.init_scales ** 2)
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
        # production always runs through the ONE compiled sample kernel (see
        # NUTSSampler: a warmup-jit-local sample scan compiled with last-ulp
        # differences vs the continuation path, forking resumed chains)
        return self._sample(x, logp, n_samples)

    def _sample_jitted(self):
        """The shared production kernel (bitwise identical from warmup,
        continuation, and checkpoint resume)."""
        if getattr(self, "_sample_run", None) is not None:
            return self._sample_run

        def run_fn(x, logp, eps, inv_mass, skeys):
            def sample_step(carry, key):
                x, logp = carry
                keys = jr.split(key, self.nchains)
                x, logp, aprob = jax.vmap(
                    lambda xi, li, ki: self._transition(xi, li, ki, eps, inv_mass)
                )(x, logp, keys)
                return (x, logp), (x, aprob)

            (x, logp), (xs, aprob) = jax.lax.scan(sample_step, (x, logp), skeys)
            return xs, aprob, logp

        if self.mesh is None:
            self._sample_run = jax.jit(run_fn)
        else:
            s = self._sharding
            self._sample_run = jax.jit(
                run_fn,
                in_shardings=(s(self.axis_name, None), s(self.axis_name), s(), s(), s()),
                out_shardings=(s(None, self.axis_name, None),
                               s(None, self.axis_name), s(self.axis_name)))
        return self._sample_run

    def _sample(self, x0, logp0, n_samples):
        run = self._sample_jitted()
        xs, aprob, logp_f = run(x0, logp0, jnp.asarray(self.step_size),
                                jnp.asarray(self.inv_mass),
                                self._take_keys(n_samples))
        self._chain = np.concatenate([self._chain, np.asarray(xs)])
        self._accept_prob_sum += np.asarray(aprob).sum(0)
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
        return self._accept_prob_sum / max(self._nsteps, 1)
