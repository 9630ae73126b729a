"""Non-gaussian likelihoods on the exact state-space GP prior: Laplace
inference by iterated Kalman smoothing, O(n) a Newton step (the PyTorch
counterpart of :mod:`g3py_tpu.models.ngssm`).

``y_k | f(t_k) ~ likelihood`` (Poisson counts, Bernoulli probit, Student-t
robust regression, ordinal, ...) with the latent f carrying any supported
state-space kernel (:mod:`g3py_tpu_torch.ops.ssm`).  The posterior mode
solves

    max_f  sum_k log p(y_k | loc_k + f_k) - 1/2 f' K^{-1} f,

and each Newton step is one linear-gaussian smoothing pass with
pseudo-observations ``ytil = f + grad/W`` and noise ``1/W`` (W = -d^2
loglik/df^2, clipped to [1e-6, 1e8]; Nickisch, Solin & Grigorievskiy, ICML
2018), run as the parallel-in-time scans.  The evidence (the model's
``loglike``) is the Laplace approximation assembled from the final pass:

    log Z = loglik(f^) - 1/2 f^' K^{-1} f^ - 1/2 log|I + K W|,
    f^' K^{-1} f^ = sum_k f^_k W_k (ytil_k - f^_k),
    log|I + K W| = sum_k log s_k + sum_k log W_k,

with ``s_k`` the pseudo-model's innovation variances.  For
:class:`~g3py_tpu_torch.models.likelihoods.GaussianLik` the mode is reached
in one step and log Z is the exact gaussian evidence of
:class:`~g3py_tpu_torch.models.statespace.StateSpaceGP`.

The Newton loop is a Python loop of ``settings.ssm_laplace_iters`` steps,
each under ``torch.utils.checkpoint`` (the JAX package's ``lax.scan`` of
``jax.checkpoint``): the backward recomputes one step at a time, so the
activation memory is one pass's, and the gradient flows through the fixed
iterations.  The elementwise derivatives of the likelihood come from two
nested forward-mode products (``torch.func.jvp``), differentiable again for
that gradient.  No step reads the device from the host.  Past
``settings.ssm_chunk_threshold`` rows every pass and the evidence run as the
chunked block scans with the per-row pseudo-noise in their payload.  The
statistics follow the sparse variational family (``location``/
``kernel_diag`` the latent moments; ``mean``/``variance(noise=True)`` the
predictive moments through the likelihood; ``logpredictive`` Gauss-Hermite
log E[p(y|f)]).  The time-axis-sharded ``nll_distributed`` comes with item
16.
"""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import settings, as_tensor, host_statistic
from ..hypers import hval
from ..hypers.means import Zero
from ..ops.iterative import full_fp32
from ..ops.ssm import (ssm_leaves, ssm_blocks, parallel_kalman_filter, parallel_smoother,
                       parallel_kalman_quad_logdet, chunked_kalman_nll, chunked_smoother_diag,
                       ssm_prior_state_sample)
from .likelihoods import (Likelihood, GaussianLik, BernoulliLik, PoissonLik, OrdinalLik,
                          sample_conditional)
from .statespace import (StateSpaceGP, MultiStateSpaceGP, _NO_MESH, _draws, _guarded, _merged,
                         _normal, _projected, _query_positions, _simulation_smoother, _steps)
from .stochastic import StochasticProcess

__all__ = ["NonGaussianSSGP", "NGSSGP", "NonGaussianMultiSSGP", "NGMSSGP",
           "NonGaussianSTSSGP", "NGSTSSGP"]

W_MIN, W_MAX = 1e-6, 1e8


def _d12_of(lik, params, y, g):
    """(d loglik/dg, d^2 loglik/dg^2) elementwise at g: two nested
    forward-mode products with a tangent of ones (``logp_elem`` is
    elementwise), differentiable again in the params and g."""
    one = torch.ones_like(g)

    def d1(gg):
        return torch.func.jvp(lambda h: lik.logp_elem(params, y, h), (gg,), (one,))[1]

    return torch.func.jvp(d1, (g,), (one,))


def _newton_loop(newton, f0):
    """``settings.ssm_laplace_iters`` Newton steps from ``f0``, each under
    ``torch.utils.checkpoint`` when a gradient is being recorded."""
    f = f0
    for _ in range(int(settings.ssm_laplace_iters)):
        if torch.is_grad_enabled():
            f = checkpoint(newton, f, use_reentrant=False)
        else:
            f = newton(f)
    return f


def _pseudo(d1, d2, f):
    """(W, ytil): the clipped curvature (non-log-concave likelihoods get
    their negative curvature clamped) and the pseudo-observations."""
    w = torch.clamp(-d2, min=W_MIN, max=W_MAX)
    return w, f + d1 / w


def _evidence(ll_data, f_hat, w, ytil, logdet):
    quad = (f_hat * w * (ytil - f_hat)).sum(-1)
    ll = ll_data - 0.5 * quad - 0.5 * (logdet + torch.log(w).sum(-1))
    return _guarded(ll, posinf=True)


def _merged_pseudo(ts, tq, ytil, w):
    """The mode's sorted pseudo-observations merged with the query times
    (unobserved, noise 1): (order, times, y, r, obs) in sorted order."""
    order, ts2, ys2, os2 = _merged(ts, tq, ytil)
    r_all = torch.cat([1.0 / w, w.new_ones(w.shape[:-1] + tq.shape)], dim=-1)
    return order, ts2, ys2, r_all[..., order], os2


class NonGaussianSSGP(StateSpaceGP):
    """State-space GP with a non-gaussian observation model (module
    docstring).

    >>> m = g3t.NonGaussianSSGP(space=t, kernel=g3t.MAT32(t) + g3t.SIN(t),
    ...                         likelihood=g3t.PoissonLik())
    >>> m.observed(t, counts)
    >>> p = m.find_MAP()                    # the Laplace evidence
    >>> m.mean(p, space=tq)                 # E[y*] through the link"""

    def __init__(self, space=None, location=None, kernel=None, likelihood=None, harmonics=None,
                 *args, **kwargs):
        if likelihood is None:
            likelihood = PoissonLik()
        if not isinstance(likelihood, Likelihood):
            raise ValueError("likelihood= must be a Likelihood (GaussianLik, StudentTLik, "
                             "PoissonLik, NegBinomialLik, BernoulliLik, OrdinalLik, ...), got "
                             f"{type(likelihood).__name__}")
        self.f_location = location if location is not None else Zero()
        self.f_kernel = kernel
        self._leaves = ssm_leaves(kernel, harmonics=harmonics)
        self.f_likelihood = likelihood
        kwargs["space"] = space
        kwargs.setdefault("name", "NGSSGP")
        # not StateSpaceGP.__init__: it installs the gaussian noise
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return [self.f_location, self.f_kernel, self.f_likelihood]

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = StateSpaceGP.observed(self, inputs=inputs, outputs=outputs, order=order,
                                    index=index, hidden=hidden)
        self.f_likelihood.check_targets(self._outputs)
        return out

    def _noise_var(self, params):
        nv = self.f_likelihood.noise_var(params)
        if nv is None:
            raise ValueError(f"{type(self.f_likelihood).__name__} has no additive-noise "
                             "decomposition; use variance(noise=True) (predictive moments) "
                             "instead")
        return nv

    def default_hypers(self):
        """The data-driven defaults see the targets in latent space
        (``Likelihood.latent_guess``)."""
        z = (self.f_likelihood.latent_guess(np.asarray(self._outputs))
             if self._outputs is not None else self.outputs)
        out = {}
        for comp in self._components():
            if comp is self.f_likelihood:
                out.update(comp.default_hypers(self.inputs, self._outputs))
            else:
                out.update(comp.default_hypers_dims(self.inputs, z))
        return out

    # -- the Laplace mode (iterated Kalman smoothing) ------------------------------
    def _d12(self, params, y, g):
        return _d12_of(self.f_likelihood, params, y, g)

    def _chunked_pieces(self, params):
        """(pinf, h, blocks_fn, rows_of) of the chunked scans: each block
        builds its own (A, Q), and ``rows_of(r)`` wraps the per-row
        pseudo-noise (..., n) as the payload form (the shared-``r`` form
        cannot carry a noise a row)."""
        _, _, pinf, h = ssm_blocks(self._leaves, params,
                                   torch.zeros(1, dtype=settings.dtype, device=settings.device))

        def rows_of(r_vec):
            lead, n = r_vec.shape[:-1], r_vec.shape[-1]

            def rows_fn(pb):
                return h, pb.reshape(lead + pb.shape[-1:])

            return r_vec.reshape(-1, n), rows_fn

        return pinf, h, self._blocks_fn(params), rows_of

    def _passes(self, params, dt):
        """(mean_pass(r, y) -> smoothed latent mean, quad_logdet(r, y) ->
        (quad, logdet), scan pieces for the statistics)."""
        if dt.shape[0] > settings.ssm_chunk_threshold:
            pinf, h, blocks_fn, rows_of = self._chunked_pieces(params)

            def mean_pass(r, y):
                return chunked_smoother_diag(None, None, None, None, y, chunk=settings.ssm_chunk,
                                             rows=rows_of(r), blocks_fn=blocks_fn, dt=dt,
                                             pinf=pinf)[0]

            def quad_logdet(r, y):
                return chunked_kalman_nll(None, None, None, None, y, chunk=settings.ssm_chunk,
                                          rows=rows_of(r), blocks_fn=blocks_fn, dt=dt,
                                          pinf=pinf, split=True)
            return mean_pass, quad_logdet

        a, q, _, h = ssm_blocks(self._leaves, params, dt)

        def mean_pass(r, y):
            m_f, p_f = parallel_kalman_filter(a, q, h, r, y)
            m_s, _ = parallel_smoother(a, q, m_f, p_f)
            with full_fp32():
                return torch.matmul(m_s, h)

        def quad_logdet(r, y):
            return parallel_kalman_quad_logdet(a, q, h, r, y)
        return mean_pass, quad_logdet

    def _mode(self, params, inputs, outputs):
        """The Newton mode of the latent in sorted time order: ``(ts, loc_s,
        ys, f_hat, w, ytil, quad_logdet)``."""
        t = inputs[:, 0]
        order = torch.argsort(t, stable=True)
        ts, ys = t[order], outputs[order]
        loc_s = self.f_location(params, inputs)[..., order]
        mean_pass, quad_logdet = self._passes(params, _steps(ts))

        def newton(f):
            d1, d2 = self._d12(params, ys, loc_s + f)
            w, ytil = _pseudo(d1, d2, f)
            return mean_pass(1.0 / w, ytil)

        f_hat = _newton_loop(newton, torch.zeros_like(ys))
        d1, d2 = self._d12(params, ys, loc_s + f_hat)
        w, ytil = _pseudo(d1, d2, f_hat)
        return ts, loc_s, ys, f_hat, w, ytil, quad_logdet

    # -- the Laplace evidence (the model's loglike) --------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            ts, loc_s, ys, f_hat, w, ytil, quad_logdet = self._mode(params, inputs, outputs)
            # log|I + K W| = sum log s_k + sum log w_k: the filter's own
            # factorization of det(K + W^{-1})
            _, logdet = quad_logdet(1.0 / w, ytil)
            ll_data = self.f_likelihood.logp_elem(params, ys, loc_s + f_hat).sum(-1)
            return _evidence(ll_data, f_hat, w, ytil, logdet)

        return fn

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """The time-axis-sharded Laplace objective (item 16)."""
        raise NotImplementedError(_NO_MESH)

    # -- the Laplace posterior at queries ------------------------------------------
    def _run_smoother(self, params, tq, inputs, outputs):
        """Smoothed Laplace-posterior latent (mean, var) at the query times:
        one more smoothing pass over the pseudo-observations at the mode,
        the queries merged in unobserved."""
        ts, _, _, _, w, ytil, _ = self._mode(params, inputs, outputs)
        order, ts2, ys2, rs2, os2 = _merged_pseudo(ts, tq, ytil, w)
        dt = _steps(ts2)
        if ts2.shape[0] > settings.ssm_chunk_threshold:
            pinf, h, blocks_fn, rows_of = self._chunked_pieces(params)
            mean, var = chunked_smoother_diag(None, None, None, None, ys2, os2,
                                              chunk=settings.ssm_chunk, rows=rows_of(rs2),
                                              blocks_fn=blocks_fn, dt=dt, pinf=pinf)
        else:
            a, q, _, h = ssm_blocks(self._leaves, params, dt)
            m_f, p_f = parallel_kalman_filter(a, q, h, rs2, ys2, os2)
            m_s, p_s = parallel_smoother(a, q, m_f, p_f)
            with full_fp32():
                mean = torch.matmul(m_s, h)
                var = torch.matmul(torch.matmul(p_s, h), h)
        qpos = _query_positions(order, ts.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    # -- statistics through the likelihood ---------------------------------------
    def _latent(self, params, space, inputs, outputs, prior):
        if prior:
            return self.f_location(params, space), self._prior_diag(params, space.shape[0])
        m, vf = self._run_smoother(params, space[:, 0], inputs, outputs)
        return self.f_location(params, space) + m, vf

    def _moments(self, params, mf, vf, space):
        return self.f_likelihood.predictive_moments(params, mf, vf)

    def _log_predictive(self, params, mf, vf, y, space):
        lik = self.f_likelihood
        f, wq = lik._grid(mf, vf)
        lp = lik.logp_elem(params, y[None, :], f)
        return torch.logsumexp(lp + torch.log(torch.clamp(wq, min=1e-30))[:, None], dim=0)

    def th_mean(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            mf, vf = self._latent(params, space, inputs, outputs, prior)
            return self._moments(params, mf, vf, space)[0]

        return fn

    def _link_nonlinear(self):
        return isinstance(self.f_likelihood, (BernoulliLik, PoissonLik, OrdinalLik))

    def th_median(self, prior=False, noise=False, simulations=None):
        if self._link_nonlinear():
            return None
        return self.th_mean(prior=prior, noise=noise)

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            mf, vf = self._latent(params, space, inputs, outputs, prior)
            return self._moments(params, mf, vf, space)[1] if noise else vf

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        """log E[p(y* | f*)] a query (Gauss-Hermite log-sum-exp), summed."""
        def fn(params, space, inputs, outputs, vector):
            mf, vf = self._latent(params, space, inputs, outputs, prior)
            return self._log_predictive(params, mf, vf, vector, space).sum()

        return fn

    # -- joint draws (the simulation smoother on the pseudo-model) ----------------
    def _joint_draws(self, params, tq, inputs, outputs, samples, seed, prior=False):
        """(nq, samples) joint latent draws under the Laplace posterior:
        the simulation smoother on the pseudo-observation model at the mode
        (``prior``: exact prior paths).  ``seed`` takes the forms of
        :meth:`StateSpaceGP._joint_draws`."""
        draws, gen = _draws(seed, settings.device)
        if prior:
            # sorted: a negative dt makes Q indefinite
            order = torch.argsort(tq, stable=True)
            a, q, _, h = ssm_blocks(self._leaves, params, _steps(tq[order]))
            eps = _normal(draws, gen, "x", (samples,) + a.shape[-3:-1], a)
            with full_fp32():
                f = torch.matmul(ssm_prior_state_sample(a, q, eps), h).T
            return f[torch.argsort(order)]
        ts, _, _, _, w, ytil, _ = self._mode(params, inputs, outputs)
        order, ts2, ys2, rs2, os2 = _merged_pseudo(ts, tq, ytil, w)
        a, q, _, h = ssm_blocks(self._leaves, params, _steps(ts2))
        return _simulation_smoother(a, q, h, rs2, ys2, os2, samples, draws, gen,
                                    _query_positions(order, ts.shape[0]))

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None, seed=0):
        """Joint latent paths g = loc + f (``noise=True``: then y | g drawn
        through the likelihood a row, numpy ``rng``, default seed + 1)."""
        pj, space, inputs, outputs = self._host(params, space, inputs, outputs)
        xq = self._as_matrix(space)
        with torch.no_grad():
            f = self._joint_draws(pj, xq[:, 0], inputs, outputs, int(samples), seed,
                                  prior=prior)
            f = (f + self.f_location(pj, xq)[:, None]).cpu().numpy().astype(settings.floatx)
        if not noise:
            return f
        if rng is None:
            rng = np.random.default_rng((0 if isinstance(seed, dict) else int(seed)) + 1)
        return sample_conditional(self.f_likelihood, pj, f, rng)

    def _noise_host(self, pj, space):
        return float(np.maximum(float(hval(self.f_likelihood.var, pj)), 1e-10))

    def _link_host(self, out, space):
        from scipy import stats

        if isinstance(self.f_likelihood, BernoulliLik):
            return stats.norm.cdf(out)
        if isinstance(self.f_likelihood, PoissonLik):
            return np.exp(np.clip(out, -30, 30))
        return out

    def _all_gaussian(self):
        return isinstance(self.f_likelihood, GaussianLik)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Latent-normal quantiles pushed through the monotone links (probit
        probability, Poisson rate); Monte Carlo through the likelihood for
        ``noise=True`` on a non-gaussian model (500 draws)."""
        from scipy import stats

        if self._all_gaussian() or not noise:
            params, space, m, v = self._host_moments(params, space, inputs, outputs, prior)
            if noise:
                v = v + self._noise_host(self._tensor_params(params), space)
            out = stats.norm.ppf(q, loc=m, scale=np.sqrt(np.maximum(v, 1e-12)))
            return self._link_host(out, space)
        draws = self.sampler(params, space, inputs, outputs, samples=500, prior=prior,
                             noise=True, rng=np.random.default_rng(7))
        return np.quantile(draws, q, axis=1)


NGSSGP = NonGaussianSSGP


class NonGaussianMultiSSGP(MultiStateSpaceGP):
    """Multi-output time series with non-gaussian observations on the exact
    LMC-mixed state-space prior: P channels observe counts, binary events
    or heavy-tailed values through their own likelihoods,

        g_p(t) = loc(t) + b_p + sum_q W[p, q] f_q(t),   y_k ~ lik_{p_k}(g_{p_k}(t_k)),

    with the latents, mixing and biases of
    :class:`~g3py_tpu_torch.models.statespace.MultiStateSpaceGP` and the
    Laplace inference of :class:`NonGaussianSSGP`: each Newton step is one
    smoothing pass with per-row emission vectors ``h_k = sum_q W[p_k, q]
    Hq``.  ``likelihood`` is one Likelihood shared by every channel or a
    list of P (repeated classes get their hyper names suffixed by
    position).  Rows are ``(t, output_index)``.

    >>> x, y = g3t.stack_outputs([t0, t1], [counts0, events1])
    >>> m = g3t.NonGaussianMultiSSGP(space=x, kernel=g3t.MAT32(t0),
    ...                              likelihood=[g3t.PoissonLik(), g3t.BernoulliLik()])"""

    def __init__(self, space=None, location=None, kernel=None, likelihood=None, outputs_dim=2,
                 latents=None, harmonics=None, *args, **kwargs):
        from .lmc import Mixing

        ks = tuple(kernel) if isinstance(kernel, (list, tuple)) else (kernel,)
        self.n_outputs = int(outputs_dim)
        if latents is None:
            latents = len(ks) if len(ks) > 1 else min(self.n_outputs, 2)
        self.n_latents = int(latents)
        if len(ks) not in (1, self.n_latents):
            raise ValueError(f"kernel list has {len(ks)} entries for {self.n_latents} latents "
                             "(pass one shared kernel or one per latent)")
        self._shared_kernel = len(ks) == 1
        self.f_kernels = ks
        if self._shared_kernel:
            self._leaf_sets = [ssm_leaves(ks[0], harmonics=harmonics)] * self.n_latents
        else:
            self._leaf_sets = [ssm_leaves(k, harmonics=harmonics) for k in ks]
        self.f_location = location if location is not None else Zero()
        self.f_mixing = Mixing(self.n_outputs, self.n_latents)
        if likelihood is None:
            likelihood = PoissonLik()
        liks = list(likelihood) if isinstance(likelihood, (list, tuple)) else [likelihood]
        for lik in liks:
            if not isinstance(lik, Likelihood):
                raise ValueError(f"likelihood= must be a Likelihood or a list of "
                                 f"{self.n_outputs} (one per channel), got "
                                 f"{type(lik).__name__}")
        if len(liks) not in (1, self.n_outputs):
            raise ValueError(f"likelihood list has {len(liks)} entries for {self.n_outputs} "
                             "channels (pass one shared likelihood or one per channel)")
        # repeated likelihood classes would collide on hyper names
        seen = {}
        for lik in liks:
            c = seen.get(lik.name, 0)
            seen[lik.name] = c + 1
            if c:
                lik.name = f"{lik.name}{c}"
        self.f_likelihoods = tuple(liks)
        kwargs["space"] = space
        kwargs.setdefault("name", "NGMSSGP")
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return ([self.f_location] + list(self.f_kernels) + [self.f_mixing]
                + list(self.f_likelihoods))

    def _host_lik_idx(self, x):
        idx = np.rint(np.asarray(x)[:, 1]).astype(np.int64)
        return idx if len(self.f_likelihoods) > 1 else np.zeros_like(idx)

    def _latent_targets(self):
        """Per-row targets in latent space through each row's likelihood
        (``Likelihood.latent_guess``): what the mixing and kernel defaults
        see."""
        if self._outputs is None:
            return None
        li = self._host_lik_idx(self._inputs)
        z = np.zeros(len(li), settings.floatx)
        for j, lik in enumerate(self.f_likelihoods):
            mask = li == j
            if np.any(mask):
                z[mask] = lik.latent_guess(np.asarray(self._outputs)[mask])
        return z

    def _channel_targets(self, j):
        """Targets observed through likelihood j (host)."""
        if self._outputs is None:
            return None
        yj = np.asarray(self._outputs)[self._host_lik_idx(self._inputs) == j]
        return yj if len(yj) else None

    def default_hypers(self):
        feats = self._features(self.inputs)
        z = self._latent_targets()
        out = {}
        out.update(self.f_location.default_hypers_dims(feats, z))
        for k in self.f_kernels:
            out.update(k.default_hypers_dims(feats, z))
        out.update(self.f_mixing.default_hypers(self.inputs, z))
        for j, lik in enumerate(self.f_likelihoods):
            out.update(lik.default_hypers(y=self._channel_targets(j)))
        return out

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = StochasticProcess.observed(self, inputs=inputs, outputs=outputs, order=order,
                                         index=index, hidden=hidden)
        x = np.asarray(self._inputs)
        if x.ndim != 2 or x.shape[1] != 2:
            raise ValueError("NonGaussianMultiSSGP rows are (t, output_index) pairs — expected "
                             f"(n, 2) inputs, got {x.shape} (build them with "
                             "with_output/stack_outputs)")
        idx = np.rint(x[:, 1]).astype(np.int64)
        if idx.min() < 0 or idx.max() >= self.n_outputs:
            raise ValueError(f"output indices must lie in [0, {self.n_outputs}); got "
                             f"[{idx.min()}, {idx.max()}]")
        for j, lik in enumerate(self.f_likelihoods):
            yj = self._channel_targets(j)
            if yj is not None:
                lik.check_targets(yj)
        return out

    # -- per-row likelihood selection ----------------------------------------------
    def _lik_idx(self, idx):
        """The likelihood index a row (zeros for a shared likelihood)."""
        return torch.zeros_like(idx) if len(self.f_likelihoods) == 1 else idx

    @staticmethod
    def _select_rows(per_lik, li):
        """A gather a row from per-likelihood (..., n) tensors: the other
        likelihoods' values (possibly out of their domain) touch neither the
        selected values nor their gradients."""
        if len(per_lik) == 1:
            return per_lik[0]
        st = torch.stack(torch.broadcast_tensors(*per_lik))
        return torch.gather(st, 0, li.expand(st.shape[1:])[None])[0]

    def _d12(self, params, y, g, idx):
        pairs = [_d12_of(lik, params, y, g) for lik in self.f_likelihoods]
        li = self._lik_idx(idx)
        return (self._select_rows([p[0] for p in pairs], li),
                self._select_rows([p[1] for p in pairs], li))

    def _ll_rows(self, params, y, g, idx):
        return self._select_rows([lik.logp_elem(params, y, g) for lik in self.f_likelihoods],
                                 self._lik_idx(idx))

    # -- the Laplace mode ----------------------------------------------------------
    def _chunked_pieces(self, params, idxs, w_mix):
        """(pinf, blocks_fn, rows_of) of the chunked scans: the payload
        carries the channel index and the per-row pseudo-noise; each block
        builds its own emission rows and (A, Q)."""
        _, _, pinf, hq = self._blocks(params, torch.zeros(1, dtype=settings.dtype,
                                                          device=settings.device))
        idxf = idxs.to(settings.dtype)

        def rows_of(r_vec):
            lead, n = r_vec.shape[:-1], r_vec.shape[-1]

            def rows_fn(pb):
                ii = torch.clamp(torch.round(pb[0]).to(torch.int64), min=0)
                with full_fp32():
                    hb = torch.matmul(w_mix[..., ii, :], hq)
                return hb, pb[1:].reshape(lead + pb.shape[-1:])

            return torch.cat([idxf[None], r_vec.reshape(-1, n)]), rows_fn

        return pinf, self._blocks_fn(params), rows_of

    def _passes(self, params, dt, idxs, w_mix):
        if dt.shape[0] > settings.ssm_chunk_threshold:
            pinf, blocks_fn, rows_of = self._chunked_pieces(params, idxs, w_mix)

            def mean_pass(r, y):
                return chunked_smoother_diag(None, None, None, None, y, chunk=settings.ssm_chunk,
                                             rows=rows_of(r), blocks_fn=blocks_fn, dt=dt,
                                             pinf=pinf)[0]

            def quad_logdet(r, y):
                return chunked_kalman_nll(None, None, None, None, y, chunk=settings.ssm_chunk,
                                          rows=rows_of(r), blocks_fn=blocks_fn, dt=dt,
                                          pinf=pinf, split=True)
            return mean_pass, quad_logdet

        a, q, _, hq = self._blocks(params, dt)
        h = self._h_rows(params, hq, idxs, w_mix)

        def mean_pass(r, y):
            m_f, p_f = parallel_kalman_filter(a, q, h, r, y)
            m_s, _ = parallel_smoother(a, q, m_f, p_f)
            with full_fp32():
                return (m_s * h).sum(-1)

        def quad_logdet(r, y):
            return parallel_kalman_quad_logdet(a, q, h, r, y)
        return mean_pass, quad_logdet

    def _mode(self, params, inputs, outputs, w_mix=None):
        """The Newton mode of the mixed latent in sorted time order: ``(ts,
        idxs, loc_s, ys, f_hat, w, ytil, quad_logdet, w_mix)``; the mixing
        is read once (one K1 site gram and one K2 factorization for the
        spatio-temporal family) unless the caller has it."""
        t, idx = self._split(inputs)
        order = torch.argsort(t, stable=True)
        ts, idxs = t[order], idx[order]
        ys = outputs[order]
        w_mix = self._weights(params) if w_mix is None else w_mix
        loc_s = self._loc_bias(params, inputs)[..., order]
        mean_pass, quad_logdet = self._passes(params, _steps(ts), idxs, w_mix)

        def newton(f):
            d1, d2 = self._d12(params, ys, loc_s + f, idxs)
            w, ytil = _pseudo(d1, d2, f)
            return mean_pass(1.0 / w, ytil)

        f_hat = _newton_loop(newton, torch.zeros_like(ys))
        d1, d2 = self._d12(params, ys, loc_s + f_hat, idxs)
        w, ytil = _pseudo(d1, d2, f_hat)
        return ts, idxs, loc_s, ys, f_hat, w, ytil, quad_logdet, w_mix

    # -- the Laplace evidence ------------------------------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            ts, idxs, loc_s, ys, f_hat, w, ytil, quad_logdet, _ = self._mode(params, inputs,
                                                                             outputs)
            _, logdet = quad_logdet(1.0 / w, ytil)
            ll_data = self._ll_rows(params, ys, loc_s + f_hat, idxs).sum(-1)
            return _evidence(ll_data, f_hat, w, ytil, logdet)

        return fn

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """The time-axis-sharded Laplace objective (item 16)."""
        raise NotImplementedError(_NO_MESH)

    # -- the Laplace posterior at query rows -----------------------------------------
    def _merged_rows(self, params, xq, inputs, outputs):
        """The mode's pseudo-observations merged with the query rows ``xq``
        (unobserved): (order, n_obs, times, idx, y, r, obs, w_mix)."""
        tq, idxq = self._split(xq)
        ts, idxs, _, _, _, w, ytil, _, w_mix = self._mode(params, inputs, outputs)
        order, ts2, ys2, rs2, os2 = _merged_pseudo(ts, tq, ytil, w)
        return order, ts.shape[0], ts2, torch.cat([idxs, idxq])[order], ys2, rs2, os2, w_mix

    def _run_smoother(self, params, xq, inputs, outputs):
        """Smoothed Laplace-posterior mixed moments (no location or bias) at
        query rows ``xq`` (nq, 2)."""
        order, n_obs, ts2, idxs2, ys2, rs2, os2, w_mix = self._merged_rows(params, xq, inputs,
                                                                           outputs)
        dt = _steps(ts2)
        if ts2.shape[0] > settings.ssm_chunk_threshold:
            pinf, blocks_fn, rows_of = self._chunked_pieces(params, idxs2, w_mix)
            mean, var = chunked_smoother_diag(None, None, None, None, ys2, os2,
                                              chunk=settings.ssm_chunk, rows=rows_of(rs2),
                                              blocks_fn=blocks_fn, dt=dt, pinf=pinf)
        else:
            a, q, _, hq = self._blocks(params, dt)
            h = self._h_rows(params, hq, idxs2, w_mix)
            m_f, p_f = parallel_kalman_filter(a, q, h, rs2, ys2, os2)
            m_s, p_s = parallel_smoother(a, q, m_f, p_f)
            mean, var = _projected(m_s, p_s, h)
        qpos = _query_positions(order, n_obs)
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    # -- statistics through the likelihoods ----------------------------------------
    def _latent(self, params, space, inputs, outputs, prior):
        if prior:
            return self._loc_bias(params, space), self._prior_diag(params, space)
        m, vf = self._run_smoother(params, space, inputs, outputs)
        return self._loc_bias(params, space) + m, vf

    def _moments(self, params, mf, vf, space):
        outs = [lik.predictive_moments(params, mf, vf) for lik in self.f_likelihoods]
        li = self._lik_idx(self._split(space)[1])
        return (self._select_rows([o[0] for o in outs], li),
                self._select_rows([o[1] for o in outs], li))

    def _log_predictive(self, params, mf, vf, y, space):
        pers = []
        for lik in self.f_likelihoods:
            f, wq = lik._grid(mf, vf)
            lp = lik.logp_elem(params, y[None, :], f)
            pers.append(torch.logsumexp(lp + torch.log(torch.clamp(wq, min=1e-30))[:, None],
                                        dim=0))
        return self._select_rows(pers, self._lik_idx(self._split(space)[1]))

    th_mean = NonGaussianSSGP.th_mean
    th_variance = NonGaussianSSGP.th_variance
    th_logpredictive = NonGaussianSSGP.th_logpredictive

    def th_median(self, prior=False, noise=False, simulations=None):
        if any(isinstance(lik, (BernoulliLik, PoissonLik, OrdinalLik))
               for lik in self.f_likelihoods):
            return None
        return self.th_mean(prior=prior, noise=noise)

    # -- joint draws -----------------------------------------------------------------
    def _joint_draws(self, params, xq, inputs, outputs, samples, seed, prior=False):
        """(nq, samples) joint mixed-latent draws under the Laplace
        posterior (``prior``: exact prior paths); ``seed`` as in
        :meth:`StateSpaceGP._joint_draws`."""
        if prior:
            return MultiStateSpaceGP._joint_draws(self, params, xq, inputs, outputs, samples,
                                                  seed, prior=True)
        draws, gen = _draws(seed, settings.device)
        order, n_obs, ts2, idxs2, ys2, rs2, os2, w_mix = self._merged_rows(params, xq, inputs,
                                                                           outputs)
        a, q, _, hq = self._blocks(params, _steps(ts2))
        h = self._h_rows(params, hq, idxs2, w_mix)
        return _simulation_smoother(a, q, h, rs2, ys2, os2, samples, draws, gen,
                                    _query_positions(order, n_obs))

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None, seed=0):
        """Joint latent paths g = loc + b_p + mixed f (``noise=True``: then
        y | g through each row's channel likelihood)."""
        pj, space, inputs, outputs = self._host(params, space, inputs, outputs)
        xq = np.asarray(space, settings.floatx)
        with torch.no_grad():
            f = self._joint_draws(pj, as_tensor(xq), inputs, outputs, int(samples), seed,
                                  prior=prior)
            f = (f + self._loc_bias(pj, xq)[:, None]).cpu().numpy().astype(settings.floatx)
        if not noise:
            return f
        if rng is None:
            rng = np.random.default_rng((0 if isinstance(seed, dict) else int(seed)) + 1)
        li = self._host_lik_idx(xq)
        out = np.empty_like(f)
        for j, lik in enumerate(self.f_likelihoods):
            mask = li == j
            if np.any(mask):
                out[mask] = sample_conditional(lik, pj, f[mask], rng)
        return out

    def _all_gaussian(self):
        return all(isinstance(lik, GaussianLik) for lik in self.f_likelihoods)

    def _noise_host(self, pj, space):
        nv = np.array([float(np.maximum(float(hval(lik.var, pj)), 1e-10))
                       for lik in self.f_likelihoods])
        return nv[self._host_lik_idx(space)]

    def _link_host(self, out, space):
        from scipy import stats

        if self._all_gaussian():
            return out
        li = self._host_lik_idx(space)
        for j, lik in enumerate(self.f_likelihoods):
            mask = li == j
            if not np.any(mask):
                continue
            if isinstance(lik, BernoulliLik):
                out[mask] = stats.norm.cdf(out[mask])
            elif isinstance(lik, PoissonLik):
                out[mask] = np.exp(np.clip(out[mask], -30, 30))
        return out

    quantiler = NonGaussianSSGP.quantiler


NGMSSGP = NonGaussianMultiSSGP


class NonGaussianSTSSGP(NonGaussianMultiSSGP):
    """Spatio-temporal non-gaussian observations on the exact separable
    space-time prior: with ``PoissonLik`` (the default) a discretized
    spatio-temporal log-gaussian Cox process, counts y(t, site) at m sites
    with intensity exp(loc(t) + b_site + f(t, x)), f the separable k_t k_s
    GP.  The mixing is ``chol(K_s(sites))`` (the
    :class:`~g3py_tpu_torch.models.spatiotemporal.SpatialMixing` of the
    gaussian family: one K1 site gram and one K2 factorization an
    evaluation) and the observations ride the Laplace loop of
    :class:`NonGaussianMultiSSGP`.  ``field`` gives the latent surface at
    any spatial points and ``field_rate`` pushes it through the likelihood.
    Rows are ``(t, site_index)``; one likelihood is shared by all sites.

    >>> st = g3t.NonGaussianSTSSGP(space=x, kernel=g3t.MAT32(t),
    ...                            space_kernel=g3t.SE(sites), sites=sites)
    >>> lam, _ = st.field_rate(tq, xq, params=p)   # intensity anywhere"""

    def __init__(self, space=None, location=None, kernel=None, space_kernel=None, sites=None,
                 likelihood=None, harmonics=None, *args, **kwargs):
        from .spatiotemporal import SpatialMixing

        if space_kernel is None or sites is None:
            raise ValueError("NonGaussianSTSSGP needs space_kernel= (a Kernel over the site "
                             "coordinates) and sites= (m, d_s)")
        sites = np.asarray(sites, settings.floatx)
        if sites.ndim == 1:
            sites = sites[:, None]
        m_sites = int(sites.shape[0])
        self.n_outputs = m_sites
        self.n_latents = m_sites
        self._shared_kernel = True
        self.f_kernels = (kernel,)
        self._leaf_sets = [ssm_leaves(kernel, harmonics=harmonics)] * m_sites
        self.f_location = location if location is not None else Zero()
        self.f_space_kernel = space_kernel
        self.f_mixing = SpatialMixing(space_kernel, sites)
        if likelihood is None:
            likelihood = PoissonLik()
        if isinstance(likelihood, (list, tuple)) or not isinstance(likelihood, Likelihood):
            raise ValueError("the spatio-temporal family shares ONE likelihood across sites "
                             "(per-site lists belong to NonGaussianMultiSSGP); got "
                             f"{type(likelihood).__name__}")
        self.f_likelihoods = (likelihood,)
        kwargs["space"] = space
        kwargs.setdefault("name", "NGSTSSGP")
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- registration (the gaussian family's, with the likelihood tuple) -----------
    def _components(self):
        return ([self.f_location, self.f_kernels[0], self.f_space_kernel, self.f_mixing]
                + list(self.f_likelihoods))

    def _check_hypers(self):
        feats = self._features(self.inputs)
        self.f_location.check_dims(feats)
        self.f_kernels[0].check_dims(feats)
        self.f_space_kernel.check_dims(self.f_mixing.sites)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        feats = self._features(self.inputs)
        z = self._latent_targets()
        out = {}
        out.update(self.f_location.default_hypers_dims(feats, z))
        out.update(self.f_kernels[0].default_hypers_dims(feats, z))
        out.update(self.f_space_kernel.default_hypers_dims(self.f_mixing.sites, z))
        out.update(self.f_mixing.default_hypers(self.inputs, z))
        for j, lik in enumerate(self.f_likelihoods):
            out.update(lik.default_hypers(y=self._channel_targets(j)))
        return out

    # -- the off-site field: the gaussian family's algebra on the pseudo-model -----
    from .spatiotemporal import SpatioTemporalSSGP as _ST

    _kt0 = _ST._kt0
    _interp = _ST._interp
    field = _ST.field
    task_correlations = _ST.task_correlations
    del _ST

    def _run_smoother_weights(self, params, tq, wrows, inputs, outputs, w=None):
        """Smoothed Laplace-posterior mixed moments at the query times whose
        emission vectors come from explicit latent-weight rows ``wrows``
        (off-site interpolation); ``w`` the mixing when the caller has it."""
        ts, idxs, _, _, _, wn, ytil, _, w_mix = self._mode(params, inputs, outputs, w)
        order, ts2, ys2, rs2, os2 = _merged_pseudo(ts, tq, ytil, wn)
        a, q, _, hq = self._blocks(params, _steps(ts2))
        wall = torch.cat([w_mix[..., idxs, :],
                          wrows.expand(w_mix.shape[:-2] + wrows.shape[-2:])], dim=-2)[..., order, :]
        with full_fp32():
            h = torch.matmul(wall, hq)
        m_f, p_f = parallel_kalman_filter(a, q, h, rs2, ys2, os2)
        m_s, p_s = parallel_smoother(a, q, m_f, p_f)
        mean, var = _projected(m_s, p_s, h)
        qpos = _query_positions(order, ts.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    def field_rate(self, t, x, params=None, inputs=None, outputs=None, prior=False):
        """Predictive observation mean and variance through the shared
        likelihood at arbitrary space-time points (host numpy): for
        ``PoissonLik`` the posterior intensity surface (per-site biases
        excluded, as in ``field``)."""
        params = self.params if params is None else params
        mean, var = self.field(t, x, params=params, inputs=inputs, outputs=outputs, prior=prior)
        pj = self._tensor_params(params)
        with torch.no_grad():
            m, v = self.f_likelihoods[0].predictive_moments(pj, as_tensor(mean), as_tensor(var))
        return m.cpu().numpy(), v.cpu().numpy()


NGSTSSGP = NonGaussianSTSSGP
