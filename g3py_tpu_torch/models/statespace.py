"""State-space GP: exact O(n) inference for 1-D Markovian kernels (the
PyTorch counterpart of :mod:`g3py_tpu.models.statespace`).

An OU / Matern / cosine / periodic GP (or a sum or product of them; SE and
SM through their Taylor approximation) is rewritten as its linear-gaussian
state-space model (:mod:`g3py_tpu_torch.ops.ssm`) and the NLL and the
posterior come from parallel-in-time Kalman filtering and smoothing
(associative scans of O(log n) depth).  The time series the reference
ships (sunspots, CO2, EURUSD) get exact inference in O(n):

>>> ssgp = g3t.StateSpaceGP(space=t, kernel=g3t.MAT32(t) + g3t.OU(t))
>>> ssgp.observed(t, y)                     # t (n, 1), any spacing, any n
>>> params = ssgp.find_MAP()
>>> ssgp.predict(params, space=t_query)

Observation noise is a :class:`~g3py_tpu_torch.hypers.kernels.KernelNoise`
hyper named as the dense ``GP(noisy=True)``'s, so param dicts transfer.
Statistics are the dense GP's: latent mean, latent marginal variance
(``noise=True`` adds the noise), the pointwise log predictive density; the
full posterior covariance is no state-space-sized object
(``th_covariance`` raises).  Above ``settings.ssm_chunk_threshold`` rows,
training takes the chunked monoid scan and the statistics the chunked
two-pass smoother (O(``ssm_chunk``) memory).  A params dict of R rows runs
every scan over (R, n, s, s): the sampler's rows, ``fixed_*`` and
``errors_datatrace`` are one scan for all rows.  The time-axis-sharded
``nll_distributed`` comes with item 16.
"""

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic
from ..hypers import hval
from ..hypers.kernels import KernelNoise
from ..hypers.means import Zero
from ..ops.guards import to_num
from ..ops.iterative import full_fp32, _generator
from ..ops.ssm import (ssm_leaves, ssm_blocks, ssm_blocks_multi, parallel_kalman_filter,
                       parallel_kalman_nll, chunked_kalman_nll, chunked_smoother_diag,
                       parallel_smoother, ssm_prior_state_sample, LOG2PI)
from .stochastic import StochasticProcess, _statistic

__all__ = ["StateSpaceGP", "SSGP", "MultiStateSpaceGP", "LMCSSGP"]

_NO_MESH = ("time-axis-sharded training (nll_distributed) is not ported yet "
            "(ROADMAP Queue 1 item 16)")


def _guarded(ll, posinf=False):
    """The loglike with NaN/-Inf (and, with ``posinf``, +Inf) set to
    ``settings.logp_guard``."""
    g = settings.logp_guard
    return torch.where(~torch.isfinite(ll), torch.full_like(ll, g),
                       to_num(ll, nan=g, neginf=g, posinf=g if posinf else 1e10))


def _steps(ts):
    return torch.cat([ts.new_zeros(1), torch.diff(ts)])


def _merged(t_obs, t_q, y_res):
    """Observed and query times merged and sorted (stable): (order, sorted
    times, sorted residuals with zeros at the queries, sorted obs mask)."""
    n_obs, nq = t_obs.shape[0], t_q.shape[0]
    t_all = torch.cat([t_obs, t_q])
    y_all = torch.cat([y_res, y_res.new_zeros(y_res.shape[:-1] + (nq,))], dim=-1)
    obs = torch.cat([torch.ones(n_obs, dtype=torch.bool, device=t_all.device),
                     torch.zeros(nq, dtype=torch.bool, device=t_all.device)])
    order = torch.argsort(t_all, stable=True)
    return order, t_all[order], y_all[..., order], obs[order]


def _query_positions(order, n_obs):
    """Positions of the query rows in the sorted order."""
    return torch.argsort(order)[n_obs:]


def _draws(seed, device):
    """Injected standard normals (a dict) or a generator from a seed."""
    if isinstance(seed, dict):
        return {k: as_tensor(np.asarray(v)) for k, v in seed.items()}, None
    return None, _generator(seed, device)


def _normal(draws, gen, key, shape, like):
    if draws is not None:
        return draws[key].reshape(shape)
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


class StateSpaceGP(StochasticProcess):
    """Exact 1-D Markovian GP by parallel Kalman filtering and smoothing."""

    def __init__(self, space=None, location=None, kernel=None, harmonics=None, *args,
                 **kwargs):
        self.f_location = location if location is not None else Zero()
        self.f_kernel = kernel
        # validates the kernel tree; ``harmonics`` truncates the SIN leaf's
        # cosine expansion (default settings.ssm_harmonics)
        self._leaves = ssm_leaves(kernel, harmonics=harmonics)
        # the dense GP(noisy=True)'s name: param dicts transfer verbatim
        self.f_noise = KernelNoise(name="Noise")
        kwargs["space"] = space
        kwargs.setdefault("name", "SSGP")
        super().__init__(*args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return [self.f_location, self.f_kernel, self.f_noise]

    def _check_hypers(self):
        for comp in self._components():
            comp.check_dims(self.inputs)
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        out = {}
        for comp in self._components():
            out.update(comp.default_hypers_dims(self.inputs, self.outputs))
        return out

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = super().observed(inputs=inputs, outputs=outputs, order=order, index=index,
                               hidden=hidden)
        x = np.asarray(self._inputs)
        if x.ndim == 2 and x.shape[1] != 1:
            raise ValueError("StateSpaceGP is a 1-D (time) model; inputs must be (n, 1), got "
                             f"{x.shape} — for multi-D use the dense/sparse families")
        return out

    # -- the state-space pieces ----------------------------------------------------
    def _noise_var(self, params):
        """The noise variance (..., 1), floored at 1e-10: it broadcasts
        against (..., n) rows."""
        return torch.clamp(hval(self.f_noise.var, params), min=1e-10)[..., None]

    def _blocks_fn(self, params):
        return lambda d: ssm_blocks(self._leaves, params, d, stationary_first=False)[:2]

    def _run_smoother(self, params, tq, inputs, outputs):
        """Filter and smoother over the observed times merged with the query
        times ``tq`` (unobserved rows): the smoothed latent mean and variance
        at the queries (the location is the caller's)."""
        tobs = inputs[:, 0]
        yres = outputs - self.f_location(params, inputs)
        order, ts, ys, os_ = _merged(tobs, tq, yres)
        dt = _steps(ts)
        r = self._noise_var(params)
        if ts.shape[0] > settings.ssm_chunk_threshold:
            # beyond-memory serving: the two-pass chunked smoother with
            # per-block (A, Q); the (n, s, s) stacks never exist
            _, _, pinf, h = ssm_blocks(self._leaves, params, dt.new_zeros(1))
            mean, var = chunked_smoother_diag(None, None, h, r, ys, os_, chunk=settings.ssm_chunk,
                                              blocks_fn=self._blocks_fn(params), dt=dt,
                                              pinf=pinf)
        else:
            a, q, _, h = ssm_blocks(self._leaves, params, dt)
            m_f, p_f = parallel_kalman_filter(a, q, h, r, ys, os_)
            m_s, p_s = parallel_smoother(a, q, m_f, p_f)
            with full_fp32():
                mean = torch.matmul(m_s, h)
                var = torch.matmul(torch.matmul(p_s, h), h)
        qpos = _query_positions(order, tobs.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    def _prior_diag(self, params, nq):
        """The stationary variance H Pinf H' (the prior marginal at any t),
        (..., nq)."""
        dt0 = torch.zeros(1, dtype=settings.dtype, device=settings.device)
        _, _, pinf, h = ssm_blocks(self._leaves, params, dt0)
        v = torch.matmul(torch.matmul(pinf, h), h)
        return v[..., None].expand(v.shape + (nq,))

    # -- the exact marginal likelihood ---------------------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            t = inputs[:, 0]
            order = torch.argsort(t, stable=True)
            ts = t[order]
            ys = (outputs - self.f_location(params, inputs))[..., order]
            dt = _steps(ts)
            r = self._noise_var(params)
            if ts.shape[0] > settings.ssm_chunk_threshold:
                # beyond-memory training: the chunked monoid scan keeps the
                # backward's memory at O(ssm_chunk); (A, Q) per block
                _, _, pinf, h = ssm_blocks(self._leaves, params, dt.new_zeros(1))
                nll = chunked_kalman_nll(None, None, h, r, ys, chunk=settings.ssm_chunk,
                                         blocks_fn=self._blocks_fn(params), dt=dt, pinf=pinf)
            else:
                a, q, _, h = ssm_blocks(self._leaves, params, dt)
                nll = parallel_kalman_nll(a, q, h, r, ys)[0]
            return _guarded(-nll)

        return fn

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """Time-axis-sharded exact NLL over a device mesh (item 16)."""
        raise NotImplementedError(_NO_MESH)

    # -- moment statistics ---------------------------------------------------------
    def th_location(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self.f_location(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                m, _ = self._run_smoother(params, space[:, 0], inputs, outputs)
                return self.f_location(params, space) + m
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self._prior_diag(params, space.shape[0])
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._run_smoother(params, space[:, 0], inputs, outputs)[1]
        return fn

    def th_mean(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_median(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            if prior:
                v = self._prior_diag(params, space.shape[0])
            else:
                v = self._run_smoother(params, space[:, 0], inputs, outputs)[1]
            return v + self._noise_var(params) if noise else v

        return fn

    def th_covariance(self, prior=False, noise=False):
        raise ValueError(
            "StateSpaceGP has no O(n)-sized full posterior covariance (the smoother carries "
            "marginals and one-step cross terms); use variance/std for bands or sampler for "
            "joint structure — or the dense GP at small n")

    def th_logpredictive(self, prior=False, noise=False):
        """Pointwise predictive density sum_i log N(y_i; m_i, v_i + r)."""

        def fn(params, space, inputs, outputs, vector):
            if prior:
                m = self.f_location(params, space)
                v = self._prior_diag(params, space.shape[0])
            else:
                m, v = self._run_smoother(params, space[:, 0], inputs, outputs)
                m = m + self.f_location(params, space)
            tot = v + self._noise_var(params)
            return (-0.5 * (LOG2PI + torch.log(tot)) - 0.5 * (vector - m) ** 2 / tot).sum(-1)

        return fn

    location = _statistic("th_location", "Latent posterior (or prior) mean.")
    kernel_diag = _statistic("th_kernel_diag", "Latent marginal variance.")

    # -- serving -------------------------------------------------------------------
    def posterior_state(self, params=None):
        """The serving state is the params themselves (the scans re-run per
        query batch at O(n) cost)."""
        return {}

    def predictor(self, params=None):
        from .predictor import Predictor

        return Predictor(self, params)

    # -- joint sampling (the simulation smoother) ----------------------------------
    def _joint_draws(self, params, tq, inputs, outputs, samples, seed, prior=False):
        """(nq, samples) joint draws of the latent f at the query times by
        the Matheron simulation smoother: prior state trajectories x' (one
        associative scan), their synthetic observations y' = Hx' + e
        filtered and smoothed beside the data, and m_s(y) + H(x' -
        m_s'(y')).  ``seed`` is a seed, a ``torch.Generator`` or the
        standard normals themselves: ``{"x": (samples, n, s), "y":
        (samples, n)}`` over the sorted merged rows (``{"x": (samples, nq,
        s)}`` for the prior), the JAX package's ``normal(k1, (n, s))`` and
        ``normal(k2, (n,))`` of each ``split`` key."""
        draws, gen = _draws(seed, settings.device)
        r = self._noise_var(params)
        if prior:
            # sorted as the posterior branch: a negative dt makes Q indefinite
            order = torch.argsort(tq, stable=True)
            a, q, _, h = ssm_blocks(self._leaves, params, _steps(tq[order]))
            eps = _normal(draws, gen, "x", (samples,) + a.shape[-3:-1], a)
            with full_fp32():
                f = torch.matmul(ssm_prior_state_sample(a, q, eps), h).T      # (nq, S)
            return f[torch.argsort(order)]
        tobs = inputs[:, 0]
        order, ts, ys, os_ = _merged(tobs, tq, outputs - self.f_location(params, inputs))
        a, q, _, h = ssm_blocks(self._leaves, params, _steps(ts))
        return _simulation_smoother(a, q, h, r, ys, os_, samples, draws, gen,
                                    _query_positions(order, tobs.shape[0]))

    # -- host-side sampling and quantiles ------------------------------------------
    def _host(self, params, space, inputs, outputs):
        params = self.params if params is None else params
        space = self.space if space is None else space
        inputs = self._device_data("inputs") if inputs is None else self._as_matrix(inputs)
        outputs = self._device_data("outputs") if outputs is None else self._as_vector(outputs)
        return self._tensor_params(params), space, inputs, outputs

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None, seed=0):
        """(n, samples) joint draws of f (``noise=True`` adds the observation
        noise a row from numpy ``rng``, default seed + 1) at the query times,
        coupled through the exact posterior (the simulation smoother)."""
        pj, space, inputs, outputs = self._host(params, space, inputs, outputs)
        xq = self._as_matrix(space)
        with torch.no_grad():
            f = self._joint_draws(pj, xq[:, 0], inputs, outputs, int(samples), seed,
                                  prior=prior)
            f = (f + self.f_location(pj, xq)[:, None]).cpu().numpy().astype(settings.floatx)
        if noise:
            if rng is None:
                rng = np.random.default_rng((0 if isinstance(seed, dict) else int(seed)) + 1)
            s2 = float(np.maximum(float(hval(self.f_noise.var, pj)), 1e-10))
            f = f + np.sqrt(s2) * rng.standard_normal(f.shape).astype(settings.floatx)
        return f

    def _host_moments(self, params, space, inputs, outputs, prior):
        params = self.params if params is None else params
        space = self.space if space is None else space
        with torch.no_grad():
            m = self.location(params, space, inputs, outputs, prior=prior)
            v = np.maximum(self.kernel_diag(params, space, inputs, outputs, prior=prior), 0.0)
        return params, space, m, v

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        from scipy import stats

        params, space, m, v = self._host_moments(params, space, inputs, outputs, prior)
        if noise:
            v = v + float(np.maximum(np.asarray(params[self.f_noise.var.name]), 1e-10))
        return stats.norm.ppf(q, loc=m, scale=np.sqrt(np.maximum(v, 1e-12)))


SSGP = StateSpaceGP


class MultiStateSpaceGP(StateSpaceGP):
    """Exact O(n) multi-output time-series GP: P observed channels are
    linear mixtures of Q independent Markovian latent GPs,

        g_p(t) = loc(t) + b_p + sum_q W[p, q] f_q(t),     y ~ N(g_p(t), s2_p),

    with the LMC mixing ``W`` (P, Q), the biases and the per-output noise
    variances trainable (:class:`~g3py_tpu_torch.models.lmc.Mixing`,
    :class:`~g3py_tpu_torch.models.lmc.MultiGaussianLik`).  The joint state
    stacks the Q latent SSMs block-diagonally; each event row observes one
    channel through its own emission vector ``h_k = sum_q W[p_k, q] H_q``,
    so channels may be sampled at different times.  Rows are ``(t,
    output_index)`` (:func:`~g3py_tpu_torch.models.lmc.with_output`,
    :func:`~g3py_tpu_torch.models.lmc.stack_outputs`); ``kernel`` is one
    Kernel shared by the Q latents or a list of Q kernels."""

    def __init__(self, space=None, location=None, kernel=None, outputs_dim=2, latents=None,
                 harmonics=None, *args, **kwargs):
        from .lmc import Mixing, MultiGaussianLik

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
        self.f_location = location if location is not None else Zero()
        if self._shared_kernel:
            self._leaf_sets = [ssm_leaves(ks[0], harmonics=harmonics)] * self.n_latents
        else:
            self._leaf_sets = [ssm_leaves(k, harmonics=harmonics) for k in ks]
        self.f_mixing = Mixing(self.n_outputs, self.n_latents)
        self.f_likelihood = MultiGaussianLik(self.n_outputs)
        kwargs["space"] = space
        kwargs.setdefault("name", "MSSGP")
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return [self.f_location] + list(self.f_kernels) + [self.f_mixing, self.f_likelihood]

    def _features(self, x):
        """The host time column (the latent kernels see time, not the index)."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        return x[:, :1]

    def _check_hypers(self):
        feats = self._features(self.inputs)
        self.f_location.check_dims(feats)
        for k in self.f_kernels:
            k.check_dims(feats)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        feats = self._features(self.inputs)
        out = {}
        out.update(self.f_location.default_hypers_dims(feats, self.outputs))
        for k in self.f_kernels:
            out.update(k.default_hypers_dims(feats, self.outputs))
        out.update(self.f_mixing.default_hypers(self.inputs, self.outputs))
        out.update(self.f_likelihood.default_hypers(self.inputs, self.outputs))
        return out

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = StochasticProcess.observed(self, inputs=inputs, outputs=outputs, order=order,
                                         index=index, hidden=hidden)
        x = np.asarray(self._inputs)
        if x.ndim != 2 or x.shape[1] != 2:
            raise ValueError("MultiStateSpaceGP rows are (t, output_index) pairs — expected "
                             f"(n, 2) inputs, got {x.shape} (build them with "
                             "with_output/stack_outputs)")
        idx = np.rint(x[:, 1]).astype(np.int64)
        if idx.min() < 0 or idx.max() >= self.n_outputs:
            raise ValueError(f"output indices must lie in [0, {self.n_outputs}); got "
                             f"[{idx.min()}, {idx.max()}]")
        self.f_likelihood.check_targets(self._outputs)
        return out

    # -- the state-space pieces ----------------------------------------------------
    @staticmethod
    def _split(x):
        """(t (n,), output index (n,)) of (t, index) rows."""
        x = as_tensor(x)
        return x[:, 0], torch.clamp(torch.round(x[:, 1]).to(torch.int64), min=0)

    def _blocks(self, params, dt, stationary_first=True):
        return ssm_blocks_multi(self._leaf_sets, params, dt, stationary_first=stationary_first)

    def _blocks_fn(self, params):
        return lambda d: self._blocks(params, d, stationary_first=False)[:2]

    def _weights(self, params):
        """The mixing W (..., P, Q)."""
        return self.f_mixing.values(params)[0]

    def _bias(self, params):
        return hval(self.f_mixing.b, params)

    def _h_rows(self, params, hq, idx, w=None):
        """Per-row emission vectors (..., n, S): h_k = sum_q W[p_k, q] Hq[q]."""
        w = self._weights(params) if w is None else w
        with full_fp32():
            return torch.matmul(w[..., idx, :], hq)

    def _r_rows(self, params, idx):
        return self.f_likelihood._vars(params)[..., idx]

    def _residual(self, params, x, y):
        """y minus location(t) and the per-output bias."""
        x = as_tensor(x)
        _, idx = self._split(x)
        return as_tensor(y) - self.f_location(params, x[:, :1]) - self._bias(params)[..., idx]

    def _loc_bias(self, params, space):
        space = as_tensor(space)
        _, idx = self._split(space)
        return self.f_location(params, space[:, :1]) + self._bias(params)[..., idx]

    def _prior_vq(self, params):
        """Each latent's stationary variance H_q Pinf H_q' (..., Q)."""
        dt0 = torch.zeros(1, dtype=settings.dtype, device=settings.device)
        _, _, pinf, hq = self._blocks(params, dt0)
        return (torch.matmul(pinf[..., None, :, :], hq[:, :, None])[..., 0] * hq).sum(-1)

    # -- the exact marginal likelihood ---------------------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            t, idx = self._split(inputs)
            order = torch.argsort(t, stable=True)
            ts, idxs = t[order], idx[order]
            ys = self._residual(params, inputs, outputs)[..., order]
            dt = _steps(ts)
            w = self._weights(params)
            if ts.shape[0] > settings.ssm_chunk_threshold:
                # beyond-memory training: the per-row-emission chunked scan;
                # each block builds its own h/r and (A, Q)
                _, _, pinf, hq = self._blocks(params, dt.new_zeros(1))
                nll = chunked_kalman_nll(
                    None, None, None, None, ys, chunk=settings.ssm_chunk,
                    rows=(idxs, w, hq, self.f_likelihood._vars(params)),
                    blocks_fn=self._blocks_fn(params), dt=dt, pinf=pinf)
            else:
                a, q, _, hq = self._blocks(params, dt)
                nll = parallel_kalman_nll(a, q, self._h_rows(params, hq, idxs, w),
                                          self._r_rows(params, idxs), ys)[0]
            return _guarded(-nll)

        return fn

    # -- smoothing -----------------------------------------------------------------
    def _run_smoother(self, params, xq, inputs, outputs):
        """Smoothed mixed moments (no location or bias) at query rows ``xq``
        (nq, 2): mean_k = h_k' m_s, var_k = h_k' P_s h_k."""
        tq, idxq = self._split(xq)
        tobs, idxobs = self._split(inputs)
        yres = self._residual(params, inputs, outputs)
        order, ts, ys, os_ = _merged(tobs, tq, yres)
        idxs = torch.cat([idxobs, idxq])[order]
        dt = _steps(ts)
        w = self._weights(params)
        if ts.shape[0] > settings.ssm_chunk_threshold:
            _, _, pinf, hq = self._blocks(params, dt.new_zeros(1))
            mean, var = chunked_smoother_diag(
                None, None, None, None, ys, os_, chunk=settings.ssm_chunk,
                rows=(idxs, w, hq, self.f_likelihood._vars(params)),
                blocks_fn=self._blocks_fn(params), dt=dt, pinf=pinf)
        else:
            a, q, _, hq = self._blocks(params, dt)
            h = self._h_rows(params, hq, idxs, w)
            # the query rows are masked out of the filter, but their r still
            # enters s = hQh' + r: keep it the row's own (positive) variance
            r = self._r_rows(params, idxs)
            m_f, p_f = parallel_kalman_filter(a, q, h, r, ys, os_)
            m_s, p_s = parallel_smoother(a, q, m_f, p_f)
            mean, var = _projected(m_s, p_s, h)
        qpos = _query_positions(order, tobs.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    def _prior_diag(self, params, space):
        """Prior marginal variance a row: sum_q W[p,q]^2 H_q Pinf H_q'."""
        _, idx = self._split(space)
        w = self._weights(params)
        return (w[..., idx, :] ** 2 * self._prior_vq(params)[..., None, :]).sum(-1)

    # -- moment statistics ---------------------------------------------------------
    def th_location(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self._loc_bias(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                m, _ = self._run_smoother(params, space, inputs, outputs)
                return self._loc_bias(params, space) + m
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self._prior_diag(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._run_smoother(params, space, inputs, outputs)[1]
        return fn

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            if prior:
                v = self._prior_diag(params, space)
            else:
                v = self._run_smoother(params, space, inputs, outputs)[1]
            if noise:
                v = v + self._r_rows(params, self._split(space)[1])
            return v

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            if prior:
                m = self._loc_bias(params, space)
                v = self._prior_diag(params, space)
            else:
                ms, v = self._run_smoother(params, space, inputs, outputs)
                m = self._loc_bias(params, space) + ms
            tot = v + self._r_rows(params, self._split(space)[1])
            return (-0.5 * (LOG2PI + torch.log(tot)) - 0.5 * (vector - m) ** 2 / tot).sum(-1)

        return fn

    # -- joint sampling (the simulation smoother, per-row emissions) ---------------
    def _joint_draws(self, params, xq, inputs, outputs, samples, seed, prior=False):
        """(nq, samples) joint draws of the mixed latent g (no location or
        bias) at query rows ``xq`` (see :meth:`StateSpaceGP._joint_draws`,
        whose ``seed`` forms this takes)."""
        draws, gen = _draws(seed, settings.device)
        tq, idxq = self._split(xq)
        if prior:
            order = torch.argsort(tq, stable=True)
            a, q, _, hq = self._blocks(params, _steps(tq[order]))
            h = self._h_rows(params, hq, idxq[order])
            eps = _normal(draws, gen, "x", (samples,) + a.shape[-3:-1], a)
            with full_fp32():
                f = (ssm_prior_state_sample(a, q, eps) * h).sum(-1).T
            return f[torch.argsort(order)]
        tobs, idxobs = self._split(inputs)
        order, ts, ys, os_ = _merged(tobs, tq, self._residual(params, inputs, outputs))
        idxs = torch.cat([idxobs, idxq])[order]
        a, q, _, hq = self._blocks(params, _steps(ts))
        h = self._h_rows(params, hq, idxs)
        r = self._r_rows(params, idxs)
        return _simulation_smoother(a, q, h, r, ys, os_, samples, draws, gen,
                                    _query_positions(order, tobs.shape[0]))

    # -- host-side sampling and quantiles ------------------------------------------
    def _noise_rows_host(self, pj, space):
        idx = np.rint(np.asarray(space)[:, 1]).astype(np.int64)
        return self.f_likelihood._vars(pj).cpu().numpy()[idx]

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None, seed=0):
        pj, space, inputs, outputs = self._host(params, space, inputs, outputs)
        xq = np.asarray(space, settings.floatx)
        with torch.no_grad():
            f = self._joint_draws(pj, as_tensor(xq), inputs, outputs, int(samples), seed,
                                  prior=prior)
            f = (f + self._loc_bias(pj, xq)[:, None]).cpu().numpy().astype(settings.floatx)
        if noise:
            if rng is None:
                rng = np.random.default_rng((0 if isinstance(seed, dict) else int(seed)) + 1)
            s2 = self._noise_rows_host(pj, xq)
            f = f + np.sqrt(s2)[:, None] * rng.standard_normal(f.shape).astype(settings.floatx)
        return f

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        from scipy import stats

        params, space, m, v = self._host_moments(params, space, inputs, outputs, prior)
        if noise:
            v = v + self._noise_rows_host(self._tensor_params(params), space)
        return stats.norm.ppf(q, loc=m, scale=np.sqrt(np.maximum(v, 1e-12)))

    # -- user-facing extras --------------------------------------------------------
    def task_correlations(self, params=None):
        """The learned cross-output latent correlation (P, P): W W'
        normalized to a unit diagonal (host numpy)."""
        params = self.params if params is None else params
        w = np.asarray(hval(self.f_mixing.w, self._tensor_params(params)).cpu().numpy(),
                       np.float64)
        b = w @ w.T
        d = np.sqrt(np.maximum(np.diagonal(b), 1e-12))
        return b / np.outer(d, d)


LMCSSGP = MultiStateSpaceGP


def _projected(m_s, p_s, h):
    """Per-row projections h_k' m_s and h_k' P_s h_k."""
    with full_fp32():
        return (m_s * h).sum(-1), (torch.matmul(p_s, h[..., None])[..., 0] * h).sum(-1)


def _simulation_smoother(a, q, h, r, ys, os_, samples, draws, gen, qpos):
    """(nq, samples) Matheron draws at the sorted positions ``qpos``: prior
    trajectories x' (one scan), their observations y' = h'x' + e filtered
    and smoothed beside the data, m_s(y) + h'(x' - m_s'(y')); ``h`` is
    shared (s,) or per row (n, s)."""
    m_f, p_f = parallel_kalman_filter(a, q, h, r, ys, os_)
    m_s, _ = parallel_smoother(a, q, m_f, p_f)
    x = ssm_prior_state_sample(a, q, _normal(draws, gen, "x", (samples,) + a.shape[-3:-1], a))
    with full_fp32():
        yprime = (x * h).sum(-1) + torch.sqrt(r) * _normal(draws, gen, "y",
                                                          (samples, ys.shape[-1]), a)
    mfp, pfp = parallel_kalman_filter(a, q, h, r, yprime, os_)
    msp, _ = parallel_smoother(a, q, mfp, pfp)
    with full_fp32():
        out = ((m_s + x - msp) * h).sum(-1)                                 # (S, n)
    return out[:, qpos].T

