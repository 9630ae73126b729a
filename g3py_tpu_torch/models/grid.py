"""GridGP: exact GP inference on Cartesian-product grids (the PyTorch
counterpart of :mod:`g3py_tpu.models.grid`).

When the inputs form a full grid ``X = axes_1 x ... x axes_D`` and the
kernel is separable across axes, the gram is the Kronecker product of the
per-axis grams and exact inference costs their eigendecompositions plus
tensor contractions (Saatci 2011): a 256 x 256 grid (N = 65,536) trains
exactly.  Each per-axis gram of an SE/MAT factor on ARD_L2 is one K1
launch.

>>> gp = g3t.GridGP(axes=[t, x], kernel=[g3t.MAT32(t), g3t.SE(x)])
>>> gp.observed(gp.space, y.ravel())        # rows in meshgrid 'ij' order
>>> params = gp.find_MAP()
>>> gp.predict(params, space=queries)       # arbitrary off-grid rows

The marginal likelihood is :func:`~g3py_tpu_torch.ops.kron.kron_gp_nll`
(an autograd Function with the analytic, eigh-free backward).  Incomplete
grids (missing cells) go through the matrix-free
:func:`~g3py_tpu_torch.ops.kron.masked_kron_nll` (PCG, SLQ, BBMM
gradients; knobs ``masked_rank``/``masked_cg_iters``/``masked_probes``/
``masked_lanczos``/``masked_seed``); a CG relative residual above 5e-2
guards the loglike.  Observation noise is a
:class:`~g3py_tpu_torch.hypers.kernels.KernelNoise` hyper named as the
dense ``GP(noisy=True)``'s.  The statistics are the state-space family's
(latent mean and marginal variance, ``noise=True`` adding the noise, the
diagonal log predictive); the (M, M) ``covariance`` is assembled by chunked
Khatri-Rao contractions, and ``sampler`` draws exact joint fields by
Matheron's rule on the per-axis-augmented grid.  A params dict of rows is
evaluated a row at a time, and ``nll_distributed`` comes with item 16.
"""

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic
from ..hypers import hval
from ..hypers.kernels import KernelNoise
from ..hypers.means import Zero
from ..ops.iterative import full_fp32, _generator
from ..ops.kron import (kron_eigs, kron_dinv, kron_apply, kron_gp_nll, cross_mean, cross_var,
                        cross_cov, LOG2PI, masked_kron_nll, masked_cross_solve)
from .sparse import signal_kernel_diag
from .statespace import _NO_MESH, _guarded
from .stochastic import StochasticProcess, _statistic

__all__ = ["GridGP", "grid_rows"]


def grid_rows(axes):
    """(N, D) rows of the Cartesian product of 1-D ``axes`` in
    ``meshgrid(indexing='ij')`` raveling order."""
    axes = [np.asarray(a, settings.floatx).reshape(-1) for a in axes]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def _draw_source(seed, device):
    """Injected standard normals (a dict of arrays) or a generator."""
    if isinstance(seed, dict):
        return {k: as_tensor(np.asarray(v)) for k, v in seed.items()}, None
    return None, _generator(seed, device)


def _normals(draws, gen, key, shape):
    if draws is not None:
        return draws[key].reshape(shape)
    return torch.randn(shape, generator=gen, dtype=settings.dtype, device=settings.device)


def _scaled_field(qs, sq, eps):
    """Prior fields (S, *u) of covariance (x) Q_i diag(lam_i) Q_i': the
    per-axis eigen scaling of the standard normals ``eps`` (S, *u)."""
    nd = len(sq)
    for i, s in enumerate(sq):
        shape = [1] * (nd + 1)
        shape[i + 1] = s.shape[0]
        eps = eps * s.reshape(shape)
    return kron_apply(list(qs), eps.movedim(0, -1)).movedim(-1, 0)


class GridGP(StochasticProcess):
    """Exact separable-kernel GP on a Cartesian grid by Kronecker
    eigendecomposition (module docstring)."""

    _batched_rows = False

    def __init__(self, space=None, location=None, kernel=None, axes=None, masked_rank=64,
                 masked_cg_iters=150, masked_probes=8, masked_lanczos=25, masked_seed=0, *args,
                 **kwargs):
        if kernel is None or not isinstance(kernel, (list, tuple)):
            raise ValueError("GridGP takes kernel=[k_1, ..., k_D], one separable factor per "
                             "grid axis")
        self.f_kernels = tuple(kernel)
        self._masked = dict(rank=int(masked_rank), cg_iters=int(masked_cg_iters),
                            probes=int(masked_probes), lanczos_iters=int(masked_lanczos),
                            seed=masked_seed if isinstance(masked_seed, dict) else int(masked_seed))
        self.f_location = location if location is not None else Zero()
        self.f_noise = KernelNoise(name="Noise")
        if axes is not None:
            self._axes = [np.asarray(a, settings.floatx).reshape(-1, 1) for a in axes]
            if len(self._axes) != len(self.f_kernels):
                raise ValueError(f"{len(self.f_kernels)} kernels for {len(self._axes)} axes")
            if space is None:
                n_cells = int(np.prod([a.shape[0] for a in self._axes]))
                if n_cells > (1 << 22):
                    # a strided subsample of the rows stands for the grid in
                    # the dims checks and defaults; the geometry is _axes
                    shp = tuple(a.shape[0] for a in self._axes)
                    flat = np.linspace(0, n_cells - 1, 1 << 14, dtype=np.int64)
                    idx = np.unravel_index(flat, shp)
                    space = np.stack([self._axes[i][idx[i], 0] for i in range(len(self._axes))],
                                     axis=1)
                else:
                    space = grid_rows([a[:, 0] for a in self._axes])
        else:
            self._axes = None   # inferred at observed()
        kwargs["space"] = space
        kwargs.setdefault("name", "GridGP")
        super().__init__(*args, **kwargs)

    # -- registration --------------------------------------------------------------
    def _components(self):
        return [self.f_location] + list(self.f_kernels) + [self.f_noise]

    def _check_hypers(self):
        self.f_location.check_dims(self.inputs)
        for k, a in zip(self.f_kernels, self._axes_for_hypers()):
            k.check_dims(a)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def _axes_for_hypers(self):
        if self._axes is not None:
            return self._axes
        x = np.asarray(self.inputs)
        return [np.unique(x[:, i]).reshape(-1, 1) for i in range(x.shape[1])]

    def default_hypers(self):
        out = {}
        out.update(self.f_location.default_hypers_dims(self.inputs, self.outputs))
        for k, a in zip(self.f_kernels, self._axes_for_hypers()):
            out.update(k.default_hypers_dims(a, self.outputs))
        out.update(self.f_noise.default_hypers_dims(self.inputs, self.outputs))
        return out

    # -- grid bookkeeping ----------------------------------------------------------
    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = super().observed(inputs=inputs, outputs=outputs, order=order, index=index,
                               hidden=hidden)
        x = np.asarray(self._inputs, settings.floatx)
        if x.ndim != 2 or x.shape[1] != len(self.f_kernels):
            raise ValueError(f"GridGP with {len(self.f_kernels)} kernels expects "
                             f"(N, {len(self.f_kernels)}) rows, got {x.shape}")
        if self._axes is None:
            self._axes = [np.unique(x[:, i]).reshape(-1, 1) for i in range(x.shape[1])]
        shape = self._grid_shape()
        n = int(np.prod(shape))
        if x.shape[0] > n:
            raise ValueError(f"inputs are not a complete grid: {x.shape[0]} rows vs "
                             f"prod(axis sizes) = {n} (duplicate rows?)")
        pos = np.ravel_multi_index(self._multi_index_np(x), shape)
        if len(np.unique(pos)) != x.shape[0]:
            raise ValueError("duplicate or off-axis rows after per-column matching")
        # fewer rows than cells: the masked (matrix-free) path
        return out

    def _multi_index_np(self, x):
        """Host per-column axis indices (validation only)."""
        idx = []
        for i, a in enumerate(self._axes):
            j = np.clip(np.searchsorted(a[:, 0], x[:, i]), 0, a.shape[0] - 1)
            if not np.allclose(a[j, 0], x[:, i], rtol=0, atol=1e-5):
                raise ValueError(f"column {i} has values off the grid axis")
            idx.append(j)
        return tuple(idx)

    def _grid_shape(self):
        return tuple(a.shape[0] for a in self._axes)

    def _multi_index(self, x):
        """Per-column axis indices on the device: the nearer of the two
        neighbours of the insertion point (float rounding may put an exact
        grid value one past it)."""
        idx = []
        for i, a in enumerate(self._axes):
            ax = as_tensor(a[:, 0])
            col = x[:, i].contiguous()
            j = torch.clamp(torch.searchsorted(ax, col), 0, a.shape[0] - 1)
            jm = torch.clamp(j - 1, 0, a.shape[0] - 1)
            pick_lo = torch.abs(ax[jm] - col) <= torch.abs(ax[j] - col)
            idx.append(torch.where(pick_lo, jm, j))
        return tuple(idx)

    def _yres(self, params, inputs, outputs):
        return outputs - self.f_location(params, inputs)

    def _y_tensor(self, params, inputs, outputs):
        """The residualized observations scattered into (n_1, ..., n_D)."""
        yres = self._yres(params, inputs, outputs)
        return yres.new_zeros(self._grid_shape()).index_put(self._multi_index(inputs), yres)

    def _grams(self, params):
        return tuple(k.cov(params, as_tensor(a)) for k, a in zip(self.f_kernels, self._axes))

    def _noise_var(self, params):
        return torch.clamp(hval(self.f_noise.var, params), min=1e-10)

    def _is_complete(self, inputs):
        return int(inputs.shape[0]) == int(np.prod(self._grid_shape()))

    def _idx_stack(self, x):
        return torch.stack(self._multi_index(x))

    # -- the marginal likelihood ---------------------------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            if self._is_complete(inputs):
                nll = kron_gp_nll(self._grams(params), self._noise_var(params),
                                  self._y_tensor(params, inputs, outputs))
                return _guarded(-nll)
            # an incomplete grid: the observed block's matvec is still
            # Kronecker, so the matrix-free NLL; an untrusted CG solve reads
            # as the guard, not as a plausible value
            mk = self._masked
            nll, info = masked_kron_nll(self._grams(params), self._noise_var(params),
                                        self._yres(params, inputs, outputs),
                                        self._idx_stack(inputs), self._grid_shape(), mk["rank"],
                                        mk["cg_iters"], mk["probes"], mk["lanczos_iters"],
                                        mk["seed"])
            ll = _guarded(-nll)
            return torch.where(info["cg_rel_residual"] > 5e-2,
                               torch.full_like(ll, settings.logp_guard), ll)

        return fn

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """The device-sharded Kronecker NLL (item 16)."""
        raise NotImplementedError(_NO_MESH)

    # -- posterior pieces ----------------------------------------------------------
    def _eig_state(self, params, inputs, outputs):
        qs, lams = kron_eigs(self._grams(params))
        dinv = kron_dinv(lams, self._noise_var(params))
        at = kron_apply([q.T for q in qs], self._y_tensor(params, inputs, outputs)) * dinv
        return qs, dinv, kron_apply(list(qs), at)

    def _cross(self, params, space):
        """Per-axis cross grams [(M, n_i)] of paired query rows."""
        return [k.cov(params, space[:, i:i + 1], as_tensor(a))
                for i, (k, a) in enumerate(zip(self.f_kernels, self._axes))]

    def _prior_diag(self, params, space):
        out = None
        for i, k in enumerate(self.f_kernels):
            d = signal_kernel_diag(k, params, space[:, i:i + 1])
            out = d if out is None else out * d
        return out

    def _masked_b(self, cs, idx):
        """(n_obs, M) cross gram between the queries and the observed cells:
        Khatri-Rao rows gathered at the observed multi-indices."""
        b = None
        for c, ix in zip(cs, idx):
            piece = c[:, ix]
            b = piece if b is None else b * piece
        return b.T

    def _masked_solve(self, params, idx, b):
        return masked_cross_solve(self._grams(params), self._noise_var(params), idx,
                                  self._grid_shape(), b, rank=self._masked["rank"],
                                  cg_iters=max(200, self._masked["cg_iters"]))

    def _posterior_moments(self, params, space, inputs, outputs):
        cs = self._cross(params, space)
        kdiag = self._prior_diag(params, space)
        if self._is_complete(inputs):
            qs, dinv, alpha = self._eig_state(params, inputs, outputs)
            return cross_mean(cs, alpha), torch.clamp(cross_var(cs, qs, dinv, kdiag), min=0.0)
        # a masked grid: one multi-RHS PCG solves alpha and the variance
        # columns together
        idx = self._idx_stack(inputs)
        b = self._masked_b(cs, idx)
        rhs = torch.cat([self._yres(params, inputs, outputs)[:, None], b], dim=1)
        sol = self._masked_solve(params, idx, rhs)
        alpha, sb = sol[:, 0], sol[:, 1:]
        with full_fp32():
            mean = (b * alpha[:, None]).sum(0)
            var = kdiag - (b * sb).sum(0)
        return mean, torch.clamp(var, min=0.0)

    # -- moment statistics ---------------------------------------------------------
    def th_location(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self.f_location(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                m, _ = self._posterior_moments(params, space, inputs, outputs)
                return self.f_location(params, space) + m
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self._prior_diag(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._posterior_moments(params, space, inputs, outputs)[1]
        return fn

    def th_mean(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_median(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            if prior:
                v = self._prior_diag(params, space)
            else:
                v = self._posterior_moments(params, space, inputs, outputs)[1]
            return v + self._noise_var(params) if noise else v

        return fn

    def _prior_cov(self, params, space):
        kqq = None
        for i, k in enumerate(self.f_kernels):
            g = k.cov(params, space[:, i:i + 1])
            kqq = g if kqq is None else kqq * g
        return kqq

    def th_covariance(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            kqq = self._prior_cov(params, space)
            if prior:
                out = kqq
            elif self._is_complete(inputs):
                qs, dinv, _ = self._eig_state(params, inputs, outputs)
                out = cross_cov(self._cross(params, space), qs, dinv, kqq)
            else:
                idx = self._idx_stack(inputs)
                b = self._masked_b(self._cross(params, space), idx)
                with full_fp32():
                    out = kqq - torch.matmul(b.T, self._masked_solve(params, idx, b))
            if noise:
                out = out + self._noise_var(params) * torch.eye(out.shape[0], dtype=out.dtype,
                                                                device=out.device)
            return out

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            if prior:
                m = self.f_location(params, space)
                v = self._prior_diag(params, space)
            else:
                ms, v = self._posterior_moments(params, space, inputs, outputs)
                m = self.f_location(params, space) + ms
            tot = v + self._noise_var(params)
            return (-0.5 * (LOG2PI + torch.log(tot)) - 0.5 * (vector - m) ** 2 / tot).sum()

        return fn

    location = _statistic("th_location", "Latent posterior (or prior) mean.")
    kernel_diag = _statistic("th_kernel_diag", "Latent marginal variance.")

    # -- serving -------------------------------------------------------------------
    def posterior_state(self, params=None):
        """The serving state is the params themselves (the eigen state is
        rebuilt a query batch at O(sum n_i^3))."""
        return {}

    def predictor(self, params=None):
        from .predictor import Predictor

        return Predictor(self, params)

    # -- joint sampling (Matheron on the per-axis-augmented grid) -------------------
    def _joint_draws(self, params, xq_np, inputs, outputs, samples, seed, prior=False):
        """(M, samples) exact joint draws of the latent field at the query
        rows.  A query coordinate joins its grid axis, so the prior over
        (grid x queries) is Kronecker on the augmented axes: a prior field
        there (Q_u sqrt(lam_u) eps) is corrected against the observations,
        f* = f'_q + K_*X S^{-1} (y - f'_X - eps_noise).  ``seed`` is an
        int, a ``torch.Generator`` or the standard normals: ``{"field":
        (samples, *u_shape), "noise": (samples, n_cells or n_obs)}``."""
        xq_np = np.asarray(xq_np, settings.floatx)
        axes_u, grid_ix, query_ix = [], [], []
        for i, a in enumerate(self._axes):
            u, inv = np.unique(np.concatenate([a[:, 0], xq_np[:, i]]), return_inverse=True)
            axes_u.append(u.reshape(-1, 1))
            grid_ix.append(inv[:a.shape[0]])
            query_ix.append(inv[a.shape[0]:])
        ushape = tuple(u.shape[0] for u in axes_u)
        if int(np.prod(ushape)) > 4_000_000:
            raise ValueError(f"augmented sampling grid has {int(np.prod(ushape))} cells — thin "
                             "the query set (or query on a coarser grid)")
        draws, gen = _draw_source(seed, settings.device)
        qs_u, lams_u = kron_eigs(tuple(k.cov(params, as_tensor(u))
                                       for k, u in zip(self.f_kernels, axes_u)))
        fields = _scaled_field(qs_u, [torch.sqrt(lam) for lam in lams_u],
                               _normals(draws, gen, "field", (samples,) + ushape))
        qix = tuple(as_tensor(qi).long() for qi in query_ix)
        f_q = fields[(slice(None),) + qix]                                 # (S, M)
        if prior:
            return f_q.T
        xq = as_tensor(xq_np)
        r = self._noise_var(params)
        gix = [as_tensor(g).long() for g in grid_ix]
        cs = self._cross(params, xq)
        if self._is_complete(inputs):
            gmesh = torch.meshgrid(*gix, indexing="ij")
            f_grid = fields[(slice(None),) + tuple(gmesh)]                # (S, *grid)
            eps_n = _normals(draws, gen, "noise", f_grid.shape)
            resid = self._y_tensor(params, inputs, outputs)[None] - f_grid - torch.sqrt(r) * eps_n
            qs, lams = kron_eigs(self._grams(params))
            dinv = kron_dinv(lams, r)
            st = kron_apply([q.T for q in qs], resid.movedim(0, -1)) * dinv[..., None]
            alpha_r = kron_apply(list(qs), st)                            # (*grid, S)
            return (f_q + cross_mean(cs, alpha_r).T).T
        # a masked grid: every draw's residual in one multi-RHS PCG
        idx = self._idx_stack(inputs)
        obs_u = tuple(g[ix] for g, ix in zip(gix, idx))
        f_obs = fields[(slice(None),) + obs_u]                            # (S, n_obs)
        eps_n = _normals(draws, gen, "noise", f_obs.shape)
        resids = self._yres(params, inputs, outputs)[None] - f_obs - torch.sqrt(r) * eps_n
        alphas = self._masked_solve(params, idx, resids.T)               # (n_obs, S)
        with full_fp32():
            corr = torch.matmul(alphas.T, self._masked_b(cs, idx))
        return (f_q + corr).T

    # -- host sampling and quantiles ----------------------------------------------
    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None, seed=0):
        """(M, samples) joint draws of the latent field at the query rows
        (``noise=True`` adds the observation noise a row from numpy
        ``rng``, default seed + 1)."""
        params = self.params if params is None else params
        space = self.space if space is None else space
        pj = self._tensor_params(params)
        inputs = self._device_data("inputs") if inputs is None else self._as_matrix(inputs)
        outputs = self._device_data("outputs") if outputs is None else self._as_vector(outputs)
        with torch.no_grad():
            f = self._joint_draws(pj, space, inputs, outputs, int(samples), seed, prior=prior)
            f = (f + self.f_location(pj, self._as_matrix(space))[:, None]).cpu().numpy()
        f = f.astype(settings.floatx)
        if noise:
            if rng is None:
                rng = np.random.default_rng((0 if isinstance(seed, dict) else int(seed)) + 1)
            s2 = float(np.maximum(float(hval(self.f_noise.var, pj)), 1e-10))
            f = f + np.sqrt(s2) * rng.standard_normal(f.shape).astype(settings.floatx)
        return f

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        from scipy import stats

        params = self.params if params is None else params
        space = self.space if space is None else space
        with torch.no_grad():
            m = self.location(params, space, inputs, outputs, prior=prior)
            v = np.maximum(self.kernel_diag(params, space, inputs, outputs, prior=prior), 0.0)
        if noise:
            v = v + float(np.maximum(float(hval(self.f_noise.var,
                                                self._tensor_params(params))), 1e-10))
        return stats.norm.ppf(q, loc=m, scale=np.sqrt(np.maximum(v, 1e-12)))
