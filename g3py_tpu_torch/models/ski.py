"""SKIGP: structured kernel interpolation (KISS-GP) for scattered rows (the
PyTorch counterpart of :mod:`g3py_tpu.models.ski`).

Scattered low-D rows are interpolated onto a uniform per-axis inducing grid
with cubic-convolution weights (Keys 1981), K(X, X') ~ W K_uu W' (Wilson &
Nickisch 2015), ``W`` 4^D taps a row and ``K_uu`` the Kronecker gram over
the grid (one K1 launch an SE/MAT axis).  The gram matvec is a gather, the
per-axis contractions and a scatter-add (:func:`~g3py_tpu_torch.ops.kron.
ski_operator`), and inference rides the matrix-free stack
(:func:`~g3py_tpu_torch.ops.kron.ski_nll`: PCG, SLQ, BBMM gradients), as
GridGP's incomplete grids do.  Every statistic uses W K_uu W' (exact at
rows on grid nodes, where the weights are one-hot).  Knobs: ``grid_shape``
and ``pad_cells``; ``ski_rank``/``ski_cg_iters``/``ski_probes``/
``ski_lanczos``/``ski_seed``.  The loglike guards a CG relative residual
above 5e-2.

>>> gp = g3t.SKIGP(kernel=[g3t.SE(t), g3t.SE(x)], grid_shape=[128, 128])
>>> gp.observed(X, y)              # any scattered (N, 2) rows
>>> params = gp.find_MAP()
"""

import numpy as np
import torch

from ..config import settings, as_tensor
from ..ops.iterative import full_fp32
from ..ops.kron import (kron_apply, kron_eigs, cubic_interp_axis, ski_nll, ski_solve,
                        ski_operator, ski_prior_diag)
from .grid import GridGP, _draw_source, _normals, _scaled_field
from .statespace import _NO_MESH, _guarded
from .stochastic import StochasticProcess

__all__ = ["SKIGP"]


class SKIGP(GridGP):
    """KISS-GP on a uniform inducing grid (module docstring).

    ``grid_shape`` is an int (every axis) or a list of per-axis sizes; the
    grid spans each column's observed range padded by ``pad_cells`` cells
    on each side."""

    def __init__(self, space=None, location=None, kernel=None, grid_shape=128, pad_cells=3,
                 ski_rank=64, ski_cg_iters=150, ski_probes=8, ski_lanczos=25, ski_seed=0, *args,
                 **kwargs):
        self._grid_shape_arg = grid_shape
        self._pad_cells = int(pad_cells)
        self._ski = dict(rank=int(ski_rank), cg_iters=int(ski_cg_iters), probes=int(ski_probes),
                         lanczos_iters=int(ski_lanczos),
                         seed=ski_seed if isinstance(ski_seed, dict) else int(ski_seed))
        self._geom = None             # per-axis (lo, h, m), set at observed()
        self._space_given = space is not None
        if space is None and isinstance(kernel, (list, tuple)):
            # a D-column placeholder fixing ndim; the data come at observed()
            space = np.array([[0.0, 1.0]] * len(kernel), dtype=settings.floatx).T
        kwargs.setdefault("name", "SKIGP")
        super().__init__(space=space, location=location, kernel=kernel, axes=None, *args,
                         **kwargs)

    # -- grid geometry -------------------------------------------------------------
    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        # not GridGP.observed: scattered rows are the point
        out = StochasticProcess.observed(self, inputs=inputs, outputs=outputs, order=order,
                                         index=index, hidden=hidden)
        x = np.asarray(self._inputs, settings.floatx)
        if x.ndim != 2 or x.shape[1] != len(self.f_kernels):
            raise ValueError(f"SKIGP with {len(self.f_kernels)} kernels expects "
                             f"(N, {len(self.f_kernels)}) rows, got {x.shape}")
        self._fit_grid(x)
        if not self._space_given:
            self.set_space(space=self._inputs)
        return out

    def _fit_grid(self, x):
        shp = self._grid_shape_arg
        if np.isscalar(shp):
            shp = [int(shp)] * x.shape[1]
        if len(shp) != x.shape[1]:
            raise ValueError(f"grid_shape has {len(shp)} sizes for {x.shape[1]} axes")
        geom, axes = [], []
        for i, m in enumerate(shp):
            m = int(m)
            interior = m - 1 - 2 * self._pad_cells
            if interior < 1:
                raise ValueError(f"axis {i}: grid size {m} too small for pad_cells="
                                 f"{self._pad_cells} (need >= {2 * self._pad_cells + 2})")
            lo_d = float(x[:, i].min())
            span = max(float(x[:, i].max()) - lo_d, 1e-6)
            h = span / interior
            lo = lo_d - self._pad_cells * h
            geom.append((lo, h, m))
            axes.append((lo + h * np.arange(m)).astype(settings.floatx).reshape(-1, 1))
        self._geom = geom
        self._axes = axes

    def _taps(self, x):
        """Stacked cubic taps of (n, D) rows: (D, n, 4) indices and
        weights."""
        idxs, ws = [], []
        for i, (lo, h, m) in enumerate(self._geom):
            ix, w = cubic_interp_axis(lo, h, m, x[:, i])
            idxs.append(ix)
            ws.append(w)
        return torch.stack(idxs), torch.stack(ws)

    def _ops(self, idx, w):
        return ski_operator(tuple(idx), tuple(w), self._grid_shape())

    def _solve(self, ks, s2, xi, xw, b):
        return ski_solve(ks, s2, xi, xw, self._grid_shape(), b, rank=self._ski["rank"],
                         cg_iters=max(200, self._ski["cg_iters"]))

    # -- the marginal likelihood ---------------------------------------------------
    def th_loglike_fn(self):
        def fn(params, space, inputs, outputs):
            idx, w = self._taps(inputs)
            sk = self._ski
            nll, info = ski_nll(self._grams(params), self._noise_var(params),
                                self._yres(params, inputs, outputs), idx, w, self._grid_shape(),
                                sk["rank"], sk["cg_iters"], sk["probes"], sk["lanczos_iters"],
                                sk["seed"])
            ll = _guarded(-nll)
            return torch.where(info["cg_rel_residual"] > 5e-2,
                               torch.full_like(ll, settings.logp_guard), ll)

        return fn

    def nll_distributed(self, params=None, mesh=None, axis="dp"):
        """The row-sharded SKI NLL (item 16)."""
        raise NotImplementedError(_NO_MESH)

    # -- posterior pieces ----------------------------------------------------------
    def _prior_diag(self, params, space):
        qi, qw = self._taps(space)
        return ski_prior_diag(self._grams(params), tuple(qi), tuple(qw))

    def _cross_b(self, ks, xi, xw, qi, qw, m_q):
        """(n_obs, M) SKI cross gram W_X K_uu W_q': the query identity
        scattered onto the grid, one round of contractions, gathered at the
        observed taps."""
        eye = torch.eye(m_q, dtype=settings.dtype, device=settings.device)
        return self._ops(xi, xw)[0](kron_apply(list(ks), self._ops(qi, qw)[1](eye)))

    def _alpha(self, params, inputs, outputs, ks, s2, xi, xw):
        """(W K_uu W' + s2 I)^{-1} (y - m): the serving state where a
        Predictor holds it, one PCG otherwise."""
        a = params.get("_state_ski_alpha")
        if a is not None:
            return a
        return self._solve(ks, s2, xi, xw, self._yres(params, inputs, outputs))

    def _posterior_mean(self, params, space, inputs, outputs):
        """W_q K_uu W_X' alpha, never the (n, M) cross gram."""
        ks = self._grams(params)
        xi, xw = self._taps(inputs)
        qi, qw = self._taps(space)
        alpha = self._alpha(params, inputs, outputs, ks, self._noise_var(params), xi, xw)
        return self._ops(qi, qw)[0](kron_apply(list(ks), self._ops(xi, xw)[1](alpha)))

    def _posterior_moments(self, params, space, inputs, outputs):
        ks = self._grams(params)
        s2 = self._noise_var(params)
        xi, xw = self._taps(inputs)
        qi, qw = self._taps(space)
        b = self._cross_b(ks, xi, xw, qi, qw, space.shape[0])
        a_held = params.get("_state_ski_alpha")
        if a_held is not None:
            # serving: alpha is state, only the variance columns solve
            alpha, sb = a_held, self._solve(ks, s2, xi, xw, b)
        else:
            # alpha and the variance columns in one multi-RHS PCG
            rhs = torch.cat([self._yres(params, inputs, outputs)[:, None], b], dim=1)
            sol = self._solve(ks, s2, xi, xw, rhs)
            alpha, sb = sol[:, 0], sol[:, 1:]
        with full_fp32():
            mean = (b * alpha[:, None]).sum(0)
            var = ski_prior_diag(ks, tuple(qi), tuple(qw)) - (b * sb).sum(0)
        return mean, torch.clamp(var, min=0.0)

    def th_location(self, prior=False, noise=False):
        if prior:
            return super().th_location(prior=True)

        def fn(params, space, inputs, outputs, vector):
            return self.f_location(params, space) + self._posterior_mean(params, space, inputs,
                                                                         outputs)

        return fn

    def posterior_state(self, params=None):
        """Serving state: alpha solved once (a mean batch is then one grid
        round trip; a variance batch solves its own cross columns)."""
        pj = self._tensor_params(self.params if params is None else params)
        with torch.no_grad():
            x = self._device_data("inputs")
            xi, xw = self._taps(x)
            alpha = self._solve(self._grams(pj), self._noise_var(pj), xi, xw,
                                self._yres(pj, x, self._device_data("outputs")))
        return {"_state_ski_alpha": alpha}

    def th_covariance(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            ks = self._grams(params)
            qi, qw = self._taps(space)
            kqq = self._cross_b(ks, qi, qw, qi, qw, space.shape[0])
            if prior:
                out = kqq
            else:
                xi, xw = self._taps(inputs)
                b = self._cross_b(ks, xi, xw, qi, qw, space.shape[0])
                sb = self._solve(ks, self._noise_var(params), xi, xw, b)
                with full_fp32():
                    out = kqq - torch.matmul(b.T, sb)
            if noise:
                out = out + self._noise_var(params) * torch.eye(out.shape[0], dtype=out.dtype,
                                                                device=out.device)
            return out

        return fn

    # -- joint sampling (pathwise Matheron on the inducing grid) ---------------------
    def _joint_draws(self, params, xq_np, inputs, outputs, samples, seed, prior=False):
        """(M, samples) joint draws of the SKI latent field: prior fields on
        the grid by per-axis eigen scaling (covariance exactly K_uu),
        interpolated to the observed and query rows, every draw corrected
        through one multi-RHS PCG against the SKI gram.  ``seed`` as
        :meth:`GridGP._joint_draws`'s (``noise`` (samples, n_obs))."""
        xq = as_tensor(np.asarray(xq_np, settings.floatx))
        ks = self._grams(params)
        qs_u, lams_u = kron_eigs(ks)
        ushape = self._grid_shape()
        draws, gen = _draw_source(seed, settings.device)
        fields = _scaled_field(qs_u, [torch.sqrt(lam) for lam in lams_u],
                               _normals(draws, gen, "field", (samples,) + ushape))
        qi, qw = self._taps(xq)
        q_wv = self._ops(qi, qw)[0]
        f_q = q_wv(fields.movedim(0, -1)).T                            # (S, M)
        if prior:
            return f_q.T
        xi, xw = self._taps(inputs)
        r = self._noise_var(params)
        f_obs = self._ops(xi, xw)[0](fields.movedim(0, -1)).T           # (S, n_obs)
        eps_n = _normals(draws, gen, "noise", f_obs.shape)
        resids = self._yres(params, inputs, outputs)[None] - f_obs - torch.sqrt(r) * eps_n
        alphas = self._solve(ks, r, xi, xw, resids.T)                    # (n_obs, S)
        b = self._cross_b(ks, xi, xw, qi, qw, xq.shape[0])
        with full_fp32():
            return (f_q + torch.matmul(alphas.T, b)).T
