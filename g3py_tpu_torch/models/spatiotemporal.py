"""Exact separable spatio-temporal GP, linear in the time axis (the PyTorch
counterpart of :mod:`g3py_tpu.models.spatiotemporal`).

For a separable kernel ``k((t, x), (t', x')) = k_t(t, t') k_s(x, x')``
observed on m fixed spatial sites, the space-time GP is an m-output LMC
whose mixing is derived from the spatial kernel: with ``K_s = L L'``,
``f(t, site_p) = sum_q L[p, q] g_q(t)``, g_q iid ~ GP(0, k_t) (Sarkka,
Solin & Hartikainen 2013).  The exact machinery is
:class:`~g3py_tpu_torch.models.statespace.MultiStateSpaceGP` with the free
mixing replaced by ``chol(K_s(sites))``.  On the card the site gram is one
K1 launch (an SE/MAT site kernel on ARD_L2) and its factorization one K2
launch an evaluation; an off-site query adds one K1 cross gram.

Off-site prediction stays exact for marginals: conditioned on the site
field, f(t, x*) = a' f(t, sites) + r(t) with ``a = K_s^{-1} k_s(S, x*)``
and a residual independent of every observation (``field``).
:class:`SparseSpatioTemporalSSGP` takes free spatial coordinates, sparse in
space (m inducing sites, FITC residuals in the noise) and exact in time.
"""

import numpy as np
import torch

from ..config import settings, as_tensor
from ..hypers import Hypers, Flat, hval, is_param
from ..hypers.means import Zero
from ..ops.guards import to_cov
from ..ops.iterative import full_fp32
from ..ops.linalg import safe_cholesky, solve_lower_triangular, solve_upper_triangular
from ..ops.ssm import (ssm_leaves, ssm_blocks, parallel_kalman_filter, parallel_kalman_nll,
                       parallel_smoother, ssm_prior_state_sample, chunked_kalman_nll,
                       chunked_smoother_diag)
from .lmc import MultiGaussianLik
from .sparse import signal_kernel_diag
from .statespace import (MultiStateSpaceGP, _NO_MESH, _draws, _guarded, _merged, _normal,
                         _projected, _query_positions, _simulation_smoother, _steps)
from .stochastic import StochasticProcess

__all__ = ["SpatioTemporalSSGP", "STSSGP", "SpatialMixing", "SparseSpatioTemporalSSGP"]


class SpatialMixing(Hypers):
    """Mixing derived from a spatial kernel over fixed sites:
    ``values(params) -> (chol(K_s(sites)), b)`` with the per-site bias ``b``
    the only free hyper here (the spatial kernel is a component of the
    owning process).  Drop-in for :class:`~g3py_tpu_torch.models.lmc.Mixing`
    on the MultiStateSpaceGP machinery."""

    def __init__(self, kernel, sites, name=None, bias=True):
        self.kernel = kernel
        self.sites = np.asarray(sites, settings.floatx)
        self.P = int(self.sites.shape[0])
        self.Q = self.P
        self.b = None
        self.bias = bool(bias)
        super().__init__(name=name if name is not None else "SpaceMix")

    def check_hypers(self, parent=""):
        if not self.bias:
            # inducing-site mixing: a per-site bias has no meaning
            self.b = np.zeros((self.P,), settings.floatx)
            return
        if self.b is None:
            self.b = self._param(None, parent + self.name + "_b", prior=Flat(), shape=(self.P,))

    def default_hypers(self, x=None, y=None):
        """The per-site bias defaults to the site's target mean (rows are
        (t, site_index))."""
        if not self.bias:
            return {}
        b0 = np.zeros((self.P,), settings.floatx)
        if x is not None and y is not None and np.ndim(x) == 2:
            idx = np.asarray(np.rint(np.asarray(x)[:, -1]), np.int64)
            y = np.asarray(y)
            for p in range(self.P):
                yp = y[idx == p]
                if len(yp):
                    b0[p] = np.mean(yp)
        return {self.b: b0} if is_param(self.b) else {}

    def spatial_cov(self, params):
        """K_s over the sites, PSD-guarded (one K1 launch for an SE/MAT
        site kernel on ARD_L2)."""
        return to_cov(self.kernel.cov(params, as_tensor(self.sites)))

    def values(self, params):
        """(W = chol(K_s) (..., m, m), b (..., m)): one K2 launch."""
        return safe_cholesky(self.spatial_cov(params)), hval(self.b, params)


class SpatioTemporalSSGP(MultiStateSpaceGP):
    """Exact separable spatio-temporal GP on m spatial sites (module
    docstring).  Rows are ``(t, site_index)``; ``sites`` (m, d_s) are the
    coordinates the spatial kernel sees.

    >>> st = g3t.SpatioTemporalSSGP(space=x, kernel=g3t.MAT32(t),
    ...                             space_kernel=g3t.SE(sites), sites=sites)
    >>> st.observed(x, y); p = st.find_MAP()
    >>> m, v = st.field(tq, xq, params=p)       # any spatial points
    >>> st.task_correlations(p)                 # the normalized K_s

    The state dimension is ``S = m * s_t`` (m=32 sites, MAT32: S=64).
    Per-site biases and noise variances are sensor-level parameters, not
    part of the field: ``field`` reports ``location(t) + f(t, x)``."""

    def __init__(self, space=None, location=None, kernel=None, space_kernel=None, sites=None,
                 harmonics=None, *args, **kwargs):
        if space_kernel is None or sites is None:
            raise ValueError("SpatioTemporalSSGP needs space_kernel= (a Kernel over the site "
                             "coordinates) and sites= (m, d_s)")
        sites = np.asarray(sites, settings.floatx)
        if sites.ndim == 1:
            sites = sites[:, None]
        m = int(sites.shape[0])
        self.n_outputs = m
        self.n_latents = m
        self._shared_kernel = True
        self.f_kernels = (kernel,)
        self._leaf_sets = [ssm_leaves(kernel, harmonics=harmonics)] * m
        self.f_location = location if location is not None else Zero()
        self.f_space_kernel = space_kernel
        self.f_mixing = SpatialMixing(space_kernel, sites)
        self.f_likelihood = MultiGaussianLik(m)
        kwargs["space"] = space
        kwargs.setdefault("name", "STSSGP")
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return [self.f_location, self.f_kernels[0], self.f_space_kernel, self.f_mixing,
                self.f_likelihood]

    def _check_hypers(self):
        feats = self._features(self.inputs)
        self.f_location.check_dims(feats)
        self.f_kernels[0].check_dims(feats)
        self.f_space_kernel.check_dims(self.f_mixing.sites)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        feats = self._features(self.inputs)
        out = {}
        out.update(self.f_location.default_hypers_dims(feats, self.outputs))
        out.update(self.f_kernels[0].default_hypers_dims(feats, self.outputs))
        # the spatial kernel's defaults see the site coordinates
        out.update(self.f_space_kernel.default_hypers_dims(self.f_mixing.sites, self.outputs))
        out.update(self.f_mixing.default_hypers(self.inputs, self.outputs))
        out.update(self.f_likelihood.default_hypers(self.inputs, self.outputs))
        return out

    # -- off-site (field) prediction -----------------------------------------------
    def _kt0(self, params):
        """k_t(0): the stationary variance of one latent, H Pinf H' (...,)."""
        dt0 = torch.zeros(1, dtype=settings.dtype, device=settings.device)
        _, _, pinf_t, h_t = ssm_blocks(self._leaf_sets[0], params, dt0)
        return torch.matmul(torch.matmul(pinf_t, h_t), h_t)

    def _interp(self, params, xq, l=None):
        """Interpolation weights a (..., nq, m), a_q = K_s^{-1} k_s(S, x*),
        and the per-query residual variance k_t(0) (k_s(x*, x*) - k(x*, S)
        K_s^{-1} k(S, x*)) (..., nq); ``l`` the sites' factor when the
        caller has it."""
        z = as_tensor(self.f_mixing.sites)
        xq = as_tensor(xq)
        if xq.ndim == 1:
            xq = xq[:, None]
        if l is None:
            l = safe_cholesky(self.f_mixing.spatial_cov(params))
        kxs = self.f_space_kernel.cov(params, z, xq)                 # (..., m, nq)
        v = solve_lower_triangular(l, kxs)
        a = solve_upper_triangular(l.transpose(-1, -2), v).transpose(-1, -2)
        kqq = signal_kernel_diag(self.f_space_kernel, params, xq)
        resid_s = torch.clamp(kqq - (v * v).sum(-2), min=0.0)
        return a, self._kt0(params)[..., None] * resid_s

    def field(self, t, x, params=None, inputs=None, outputs=None, prior=False, noise=None):
        """Posterior (mean, var) of ``location(t) + f(t, x)`` at arbitrary
        space-time points — ``t`` (nq,) times, ``x`` (nq, d_s) coordinates
        (or (nq,) for 1-D space); exact marginals, host numpy out.  The
        per-site biases and noise are sensor-level and excluded (``noise``
        must be falsy).  One K1 site gram, one K2 factorization and one K1
        cross gram."""
        if isinstance(t, dict):
            raise TypeError("field(t, x, params=...) — times first, params by keyword "
                            "(unlike the params-first statistics)")
        if noise:
            raise ValueError("field() reports the latent field; per-site noise has no "
                             "off-site definition — query on-site rows via variance(..., "
                             "noise=True) instead")
        pj = self._tensor_params(self.params if params is None else params)
        with torch.no_grad():
            t = as_tensor(np.asarray(t).reshape(-1))
            w = self._weights(pj)
            a, resid = self._interp(pj, x, l=w)
            if a.shape[-2] != t.shape[0]:
                raise ValueError(f"t has {t.shape[0]} rows but x has {a.shape[-2]}")
            with full_fp32():
                wrows = torch.matmul(a, w)
            loc = self.f_location(pj, t[:, None])
            if prior:
                var = (wrows ** 2 * self._prior_vq(pj)[..., None, :]).sum(-1) + resid
                return loc.cpu().numpy(), torch.clamp(var, min=0.0).cpu().numpy()
            inputs = self._device_data("inputs") if inputs is None else self._as_matrix(inputs)
            outputs = self._device_data("outputs") if outputs is None else \
                self._as_vector(outputs)
            mq, vq = self._run_smoother_weights(pj, t, wrows, inputs, outputs, w=w)
            return ((loc + mq).cpu().numpy(),
                    torch.clamp(vq + resid, min=0.0).cpu().numpy())

    def _run_smoother_weights(self, params, tq, wrows, inputs, outputs, w=None):
        """Smoothed mixed moments at the query times ``tq`` whose emission
        vectors come from explicit latent-weight rows ``wrows`` (nq, Q)
        instead of a site index."""
        tobs, idxobs = self._split(inputs)
        order, ts, ys, os_ = _merged(tobs, tq, self._residual(params, inputs, outputs))
        a, q, _, hq = self._blocks(params, _steps(ts))
        w = self._weights(params) if w is None else w
        wall = torch.cat([w[..., idxobs, :], wrows.expand(w.shape[:-2] + wrows.shape[-2:])],
                         dim=-2)[..., order, :]
        with full_fp32():
            h = torch.matmul(wall, hq)
        r_obs = self._r_rows(params, idxobs)
        r_all = torch.cat([r_obs, r_obs.new_ones(r_obs.shape[:-1] + tq.shape)], dim=-1)
        m_f, p_f = parallel_kalman_filter(a, q, h, r_all[..., order], ys, os_)
        m_s, p_s = parallel_smoother(a, q, m_f, p_f)
        mean, var = _projected(m_s, p_s, h)
        qpos = _query_positions(order, tobs.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    def task_correlations(self, params=None):
        """The normalized spatial kernel over the sites (host numpy)."""
        pj = self._tensor_params(self.params if params is None else params)
        with torch.no_grad():
            ks = self.f_mixing.spatial_cov(pj).cpu().numpy()
        d = np.sqrt(np.maximum(np.diagonal(ks), 1e-12))
        return ks / np.outer(d, d)


STSSGP = SpatioTemporalSSGP


class SparseSpatioTemporalSSGP(SpatioTemporalSSGP):
    """Spatio-temporal GP at arbitrary spatial locations: sparse in space (m
    inducing sites), exact in time (O(n) parallel Kalman).  Rows are ``(t,
    x_1..x_ds)``; the m-site latent field u(t) = f(t, Z) is the Markovian
    state and every row projects onto it by kernel interpolation,

        f(t, x) = a(x)' u(t) + r(t, x),     a(x) = K_s(Z, Z)^{-1} k_s(Z, x),

    the residual's variance ``k_t(0) (k_s(x, x) - k' K_s^{-1} k)`` folded
    into the row's noise (FITC in space).  With Z covering the observed
    locations the residual vanishes and the model equals the exact family.

    >>> st = g3t.SparseSpatioTemporalSSGP(space=x, kernel=g3t.MAT32(x[:, :1]),
    ...                                   space_kernel=g3t.SE(x[:, 1:]), inducing=16)

    ``inducing``: an (m, d_s) site array, or an int m (the k-means centres
    of the observed coordinates).  One evaluation is a K1 site gram, a K1
    (m, n) cross gram and one K2 factorization; past
    ``settings.ssm_chunk_threshold`` rows each block builds its own
    emissions (a cross gram a block) and (A, Q).  Per-site biases and
    noises become one global noise variance (and ``location`` the mean)."""

    def __init__(self, space=None, location=None, kernel=None, space_kernel=None, inducing=None,
                 harmonics=None, *args, **kwargs):
        from .sparse import select_inducing

        if space_kernel is None or inducing is None:
            raise ValueError("SparseSpatioTemporalSSGP needs space_kernel= and inducing= (an "
                             "(m, d_s) site array, or an int m for k-means of the observed "
                             "spatial coordinates)")
        if np.ndim(inducing) == 0:
            if space is None:
                raise ValueError("inducing=<int> needs space= rows (t, x...) to place the "
                                 "k-means sites")
            xs = np.asarray(space, settings.floatx)
            if xs.ndim != 2 or xs.shape[1] < 2:
                raise ValueError(f"rows must be (t, x_1..x_ds) — got shape {xs.shape}")
            sites = select_inducing(xs[:, 1:], int(inducing))
        else:
            sites = np.asarray(inducing, settings.floatx)
            if sites.ndim == 1:
                sites = sites[:, None]
        m = int(sites.shape[0])
        self.n_outputs = 1
        self.n_latents = m
        self._shared_kernel = True
        self.f_kernels = (kernel,)
        self._leaf_sets = [ssm_leaves(kernel, harmonics=harmonics)] * m
        self.f_location = location if location is not None else Zero()
        self.f_space_kernel = space_kernel
        self.f_mixing = SpatialMixing(space_kernel, sites, bias=False)
        self.f_likelihood = MultiGaussianLik(1)
        kwargs["space"] = space
        kwargs.setdefault("name", "SparseST")
        StochasticProcess.__init__(self, *args, **kwargs)

    # -- rows are (t, x...) instead of (t, site_index) -----------------------------
    @staticmethod
    def _split(x):
        """(t (n,), spatial coordinates (n, d_s))."""
        x = as_tensor(x)
        return x[:, 0], x[:, 1:]

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = StochasticProcess.observed(self, inputs=inputs, outputs=outputs, order=order,
                                         index=index, hidden=hidden)
        x = np.asarray(self._inputs)
        d_s = self.f_mixing.sites.shape[1]
        if x.ndim != 2 or x.shape[1] != 1 + d_s:
            raise ValueError(f"SparseSpatioTemporalSSGP rows are (t, x_1..x_ds) with "
                             f"d_s={d_s} — expected (n, {1 + d_s}) inputs, got {x.shape}")
        self.f_likelihood.check_targets(self._outputs)
        return out

    def default_hypers(self):
        feats = self._features(self.inputs)
        out = {}
        out.update(self.f_location.default_hypers_dims(feats, self.outputs))
        out.update(self.f_kernels[0].default_hypers_dims(feats, self.outputs))
        out.update(self.f_space_kernel.default_hypers_dims(self.f_mixing.sites, self.outputs))
        # one global noise from the pooled target variance (the rows end in
        # coordinates, not an output index)
        y = np.asarray(self.outputs) if self.outputs is not None else None
        if is_param(self.f_likelihood.var) and y is not None and y.size > 1:
            out[self.f_likelihood.var] = np.array([np.var(y) / 10.0 + 1e-6], settings.floatx)
        return out

    # -- interpolated emissions ----------------------------------------------------
    def _vrows(self, params, l, kt0, xs):
        """Latent-weight rows and FITC residuals from one triangular solve:
        with W = L = chol(K_s), a' L = k' L^{-T} = v' for v = L^{-1} k, so
        the mixing-pushed interpolation rows are the solve's output
        transposed."""
        xs = as_tensor(xs)
        if xs.ndim == 1:
            xs = xs[:, None]
        kxs = self.f_space_kernel.cov(params, as_tensor(self.f_mixing.sites), xs)   # (..., m, c)
        v = solve_lower_triangular(l, kxs)
        kqq = signal_kernel_diag(self.f_space_kernel, params, xs)
        resid = kt0[..., None] * torch.clamp(kqq - (v * v).sum(-2), min=0.0)
        return v.transpose(-1, -2), resid

    def _wrows(self, params, xs, l=None):
        """Per-row latent weights (..., n, m) (the interpolation onto the
        sites pushed through W = chol(K_s)) and the FITC residual variances
        (..., n)."""
        if l is None:
            l = self._weights(params)
        return self._vrows(params, l, self._kt0(params), xs)

    def _residual(self, params, x, y):
        return as_tensor(y) - self.f_location(params, as_tensor(x)[:, :1])

    def _loc_bias(self, params, space):
        return self.f_location(params, as_tensor(space)[:, :1])

    def _s2(self, params):
        return self.f_likelihood._vars(params)[..., 0]

    def _r_rows(self, params, xs):
        """The observation-noise variance a row: one global s2."""
        s2 = self._s2(params)
        return s2[..., None].expand(s2.shape + (xs.shape[0],))

    def _rows_fn(self, params, hq):
        """The payload rows_fn of the chunked scans: the payload is the
        transposed coordinates (d_s, n) and each block's emissions come from
        one cross gram and one triangular solve."""
        l = self._weights(params)
        kt0 = self._kt0(params)
        s2 = self._s2(params)

        def rows_fn(pb):
            vb, residb = self._vrows(params, l, kt0, pb.T)
            with full_fp32():
                hb = torch.matmul(vb, hq)
            return hb, s2[..., None] + residb

        return rows_fn

    # -- the exact-in-time marginal likelihood under the FITC spatial noise --------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            t, xs = self._split(inputs)
            order = torch.argsort(t, stable=True)
            ys = self._residual(params, inputs, outputs)[..., order]
            dt = _steps(t[order])
            if t.shape[0] > settings.ssm_chunk_threshold:
                # beyond-memory training: (A, Q) and the interpolated
                # emissions built a block at a time (payload form)
                _, _, pinf, hq = self._blocks(params, dt.new_zeros(1))
                rows_fn = self._rows_fn(params, hq)
                nll = chunked_kalman_nll(None, None, None, None, ys, chunk=settings.ssm_chunk,
                                         rows=(xs[order].T, rows_fn),
                                         blocks_fn=self._blocks_fn(params), dt=dt, pinf=pinf)
            else:
                a, q, _, hq = self._blocks(params, dt)
                wrows, resid = self._wrows(params, xs)
                with full_fp32():
                    h = torch.matmul(wrows[..., order, :], hq)
                r = self._s2(params)[..., None] + resid[..., order]
                nll = parallel_kalman_nll(a, q, h, r, ys)[0]
            return _guarded(-nll, posinf=True)

        return fn

    # -- smoothing with interpolated emissions -------------------------------------
    def _run_smoother_weights(self, params, tq, wrows, inputs, outputs, w=None):
        """Smoothed moments of the site-field projection a'u at the query
        times with explicit weight rows ``wrows`` (nq, m); the queries'
        residual variance is the caller's.  Observed rows emit through their
        own interpolated weights with FITC-inflated noise."""
        tobs, xsobs = self._split(inputs)
        wobs, resid_obs = self._wrows(params, xsobs, l=w)
        order, ts, ys, os_ = _merged(tobs, tq, self._residual(params, inputs, outputs))
        a, q, _, hq = self._blocks(params, _steps(ts))
        wall = torch.cat([wobs, wrows.expand(wobs.shape[:-2] + wrows.shape[-2:])],
                         dim=-2)[..., order, :]
        with full_fp32():
            h = torch.matmul(wall, hq)
        r_obs = self._s2(params)[..., None] + resid_obs
        r_all = torch.cat([r_obs, r_obs.new_ones(r_obs.shape[:-1] + tq.shape)], dim=-1)
        m_f, p_f = parallel_kalman_filter(a, q, h, r_all[..., order], ys, os_)
        m_s, p_s = parallel_smoother(a, q, m_f, p_f)
        mean, var = _projected(m_s, p_s, h)
        qpos = _query_positions(order, tobs.shape[0])
        return mean[..., qpos], torch.clamp(var[..., qpos], min=0.0)

    def _run_smoother(self, params, xq, inputs, outputs):
        """Posterior (mean, var) of the latent field f(t, x) at the query
        rows: the projection's moments plus the rows' own residual variances
        (past ``settings.ssm_chunk_threshold`` rows, the two-pass chunked
        smoother with per-block (A, Q) and emissions)."""
        tq, xsq = self._split(xq)
        tobs, xsobs = self._split(inputs)
        n_obs = tobs.shape[0]
        w = self._weights(params)
        wq, residq = self._wrows(params, xsq, l=w)
        if n_obs + tq.shape[0] > settings.ssm_chunk_threshold:
            order, ts, ys, os_ = _merged(tobs, tq, self._residual(params, inputs, outputs))
            xs_all = torch.cat([xsobs, xsq])[order]
            _, _, pinf, hq = self._blocks(params, torch.zeros_like(ts[:1]))
            rows_fn = self._rows_fn(params, hq)
            # the query rows' r is the same (positive) formula; the obs mask
            # keeps them out of the filter
            mean, var = chunked_smoother_diag(None, None, None, None, ys, os_,
                                              chunk=settings.ssm_chunk, rows=(xs_all.T, rows_fn),
                                              blocks_fn=self._blocks_fn(params), dt=_steps(ts),
                                              pinf=pinf)
            qpos = _query_positions(order, n_obs)
            return mean[..., qpos], torch.clamp(var[..., qpos] + residq, min=0.0)
        m, v = self._run_smoother_weights(params, tq, wq, inputs, outputs, w=w)
        return m, torch.clamp(v + residq, min=0.0)

    def _prior_diag(self, params, space):
        _, xsq = self._split(space)
        wq, residq = self._wrows(params, xsq)
        return (wq ** 2 * self._prior_vq(params)[..., None, :]).sum(-1) + residq

    # -- joint draws (the simulation smoother over interpolated emissions) ---------
    def _joint_draws(self, params, xq, inputs, outputs, samples, seed, prior=False):
        """(nq, samples) joint draws; ``seed`` as
        :meth:`StateSpaceGP._joint_draws`, whose normals dict here also
        carries ``"res"`` (nq, samples), the residuals' draws (the JAX
        package's ``normal(kres, ...)`` of its first ``split``)."""
        draws, gen = _draws(seed, settings.device)
        tq, xsq = self._split(xq)
        w = self._weights(params)
        wq, residq = self._wrows(params, xsq, l=w)
        res = torch.sqrt(torch.clamp(residq, min=0.0))[:, None] * _normal(
            draws, gen, "res", (tq.shape[0], samples), wq)
        if prior:
            order = torch.argsort(tq, stable=True)
            a, q, _, hq = self._blocks(params, _steps(tq[order]))
            with full_fp32():
                h = torch.matmul(wq[order], hq)
                eps = _normal(draws, gen, "x", (samples,) + a.shape[-3:-1], a)
                f = (ssm_prior_state_sample(a, q, eps) * h).sum(-1).T
            return f[torch.argsort(order)] + res
        tobs, xsobs = self._split(inputs)
        wobs, resid_obs = self._wrows(params, xsobs, l=w)
        order, ts, ys, os_ = _merged(tobs, tq, self._residual(params, inputs, outputs))
        a, q, _, hq = self._blocks(params, _steps(ts))
        with full_fp32():
            h = torch.matmul(torch.cat([wobs, wq])[order], hq)
        r_obs = self._s2(params) + resid_obs
        r = torch.cat([r_obs, r_obs.new_ones(tq.shape)])[order]
        return _simulation_smoother(a, q, h, r, ys, os_, samples, draws, gen,
                                    _query_positions(order, tobs.shape[0])) + res

    # -- host-side sampling and quantiles ------------------------------------------
    def _noise_rows_host(self, pj, space):
        s2 = float(self._s2(pj).cpu().numpy())
        return np.full(len(np.asarray(space)), s2, settings.floatx)

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """Time-axis-sharded NLL with interpolated emissions (item 16)."""
        raise NotImplementedError(_NO_MESH)
