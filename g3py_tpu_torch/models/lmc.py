"""The linear model of coregionalization over the sparse variational family
(the PyTorch counterpart of :mod:`g3py_tpu.models.lmc`).

P observed outputs are linear mixtures of Q latent sparse GPs,

    g_p(x) = loc(x) + b_p + sum_q W[p, q] f_q(x),      f_q ~ GP(0, k_q),
    y ~ N(g_p(x), s2_p),

with the mixing W (P, Q), the biases b and the noise variances s2 ordinary
trainable hypers.  Every input and space matrix is in row format: the LAST
column is the integer output index in [0, P) (:func:`with_output`,
:func:`stack_outputs`), the feature columns are the others.

On the card, one evaluation of the bound is:

* one shared kernel (``kernel=`` a Kernel): the whitened-head algebra of
  :mod:`.svgp` — Kuu and Kuf (K1 twice), one Kuu factorization (K2 once),
  the Q heads batched products;
* one kernel a latent (``kernel=[k1, ..., kQ]``): the Q grams of one K1
  family on ARD_L2 over the same dims are one batched K1 launch a gram
  (the Q rates and amplitudes as its rows), any other mix one gram a
  latent; the Q Kuu are always one batched K2 launch.

A params dict of R hyperparameter rows adds a leading row axis to all of
it (the rows and latents of a gram share one launch).
"""

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic
from ..hypers import Hypers, Flat, FlatExp, hval, is_param
from ..hypers import kernels as _kernels
from ..hypers.kernels import KernelNoise, KernelStationary
from ..ops.guards import to_num, to_cov, to_bounded
from ..ops.linalg import safe_cholesky, solve_lower_triangular
from .elliptical import _contains_kernel_noise
from .likelihoods import LOG2PI, Likelihood
from .sparse import signal_kernel_diag
from .svgp import (STATE_SVP_LUU, SparseVariationalProcess, VariationalQHeads,
                   _whitened_head_moments)

__all__ = ["Mixing", "MultiGaussianLik", "LMCSVP", "with_output", "stack_outputs"]


def with_output(x, p):
    """Append an output-index column ``p`` to the feature matrix ``x``: the
    row format of every LMC input and space matrix."""
    x = np.asarray(x, settings.floatx)
    if x.ndim == 1:
        x = x[:, None]
    return np.concatenate([x, np.full((len(x), 1), float(p), settings.floatx)], axis=1)


def stack_outputs(xs, ys=None):
    """Stack per-output datasets (``xs`` a list of P feature matrices,
    ``ys`` their target vectors) into LMC row format: ``x_stacked`` (sum
    n_p, d+1), or ``(x_stacked, y_stacked)``."""
    x = np.concatenate([with_output(xp, p) for p, xp in enumerate(xs)], axis=0)
    if ys is None:
        return x
    return x, np.concatenate([np.asarray(yp, settings.floatx).reshape(-1) for yp in ys])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Mixing(Hypers):
    """The mixing: ``w`` (P, Q) latent-to-output weights and ``b`` (P,)
    per-output biases, flat priors.  Default ``w``: output p loads on
    latent p % Q with weight std(y_p); default ``b``: the outputs' means."""

    def __init__(self, outputs_dim, latents, name=None):
        self.P = int(outputs_dim)
        self.Q = int(latents)
        self.w = None
        self.b = None
        super().__init__(name=name if name is not None else "Mix")

    def check_hypers(self, parent=""):
        if self.w is None:
            self.w = self._param(None, parent + self.name + "_w", prior=Flat(),
                                 shape=(self.P, self.Q))
        if self.b is None:
            self.b = self._param(None, parent + self.name + "_b", prior=Flat(),
                                 shape=(self.P,))

    def default_hypers(self, x=None, y=None):
        w0 = np.zeros((self.P, self.Q), settings.floatx)
        b0 = np.zeros((self.P,), settings.floatx)
        scale = np.ones((self.P,), settings.floatx)
        if x is not None and y is not None and np.ndim(x) == 2:
            idx = np.asarray(np.rint(np.asarray(x)[:, -1]), np.int64)
            y = np.asarray(y)
            for p in range(self.P):
                yp = y[idx == p]
                if len(yp):
                    b0[p] = np.mean(yp)
                    scale[p] = max(float(np.std(yp)), 1e-3)
        for p in range(self.P):
            w0[p, p % self.Q] = scale[p]
        out = {}
        if is_param(self.w):
            out[self.w] = w0
        if is_param(self.b):
            out[self.b] = b0
        return out

    def values(self, params):
        """(W (..., P, Q), b (..., P))."""
        return hval(self.w, params), hval(self.b, params)


class MultiGaussianLik(Likelihood):
    """Per-output gaussian noise: y ~ N(g_p, s2_p), one FlatExp variance an
    output; the expected loglikelihood is the analytic gaussian integral a
    row, with the row's own variance."""

    def __init__(self, outputs_dim, x=None, var=None, name=None):
        self.P = int(outputs_dim)
        self.var = var
        super().__init__(x=x, name=name if name is not None else "MultiGaussLik")

    def check_hypers(self, parent=""):
        self.var = self._param(self.var, parent + self.name + "_var", FlatExp(),
                               shape=(self.P,))

    def default_hypers(self, x=None, y=None):
        if not is_param(self.var):
            return {}
        v0 = np.full((self.P,), 0.1, settings.floatx)
        if x is not None and y is not None and np.ndim(x) == 2:
            idx = np.asarray(np.rint(np.asarray(x)[:, -1]), np.int64)
            y = np.asarray(y)
            for p in range(self.P):
                yp = y[idx == p]
                if len(yp) > 1:
                    v0[p] = np.var(yp) / 10.0 + 1e-6
        return {self.var: v0}

    def _vars(self, params):
        """(..., P) noise variances, floored at 1e-10."""
        return torch.clamp(hval(self.var, params), min=1e-10)

    def expected_logp_rows(self, params, y, idx, mg, vg):
        """E_{g ~ N(mg, vg)}[log N(y; g, s2_idx)] a row."""
        s2 = self._vars(params)[..., idx]
        return -0.5 * (LOG2PI + torch.log(s2)) - ((as_tensor(y) - mg) ** 2 + vg) / (2.0 * s2)

    def check_targets(self, y):
        if not np.all(np.isfinite(np.asarray(y))):
            raise ValueError("LMC targets must be finite")


def _same_dims(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def _stacked_cov(kernels, params, x1, x2=None):
    """The Q grams K_q(x1, x2) as a (..., Q, m, n) stack.  Kernels of one K1
    family on ARD_L2 over the same dims are one launch of the fused gram
    with their rates and amplitudes as rows (after any hyperparameter
    rows); any other mix is one gram a kernel."""
    k0 = kernels[0]
    kind = k0._gram_dispatchable() if isinstance(k0, KernelStationary) else None
    fused = kind is not None and all(
        isinstance(k, KernelStationary) and k._gram_dispatchable() == kind
        and _same_dims(k.metric.dims, k0.metric.dims) for k in kernels)
    if not fused:
        return torch.stack([k.cov(params, x1, x2) for k in kernels], dim=-3)
    s1, s2 = k0.metric._sliced(x1, x1 if x2 is None else x2)
    rate = torch.stack([hval(k.metric.rate, params) for k in kernels], dim=-2)  # (..., Q, d)
    lead, q = rate.shape[:-2], rate.shape[-2]
    var = torch.stack([hval(k.var, params).expand(lead) for k in kernels], dim=-1)
    extras = [k._gram_extra(params) for k in kernels]
    extra = None if extras[0] is None else torch.stack([e.expand(lead) for e in extras], dim=-1)

    def rows(s):  # an input with the hyperparameter rows: one copy a latent
        if s.ndim == 2:
            return s
        return s[..., None, :, :].expand(lead + (q,) + s.shape[-2:]).reshape((-1,) + s.shape[-2:])

    out = _kernels.stationary_gram(kind, rows(s1), rows(s2), rate.reshape(-1, rate.shape[-1]),
                                   var.reshape(-1),
                                   None if extra is None else extra.reshape(-1))
    return out.reshape(lead + (q,) + out.shape[-2:])


class LMCSVP(SparseVariationalProcess):
    """Sparse variational linear model of coregionalization.

    >>> x, y = stack_outputs([x0, x1], [y0, y1])
    >>> lmc = g3t.LMCSVP(space=x, kernel=g3t.SE(x[:, :-1]), outputs_dim=2, latents=2,
    ...                  inducing=32)
    >>> lmc.observed(x, y)
    >>> params, losses = lmc.fit_svgp(batch_size=1024, steps=2000)
    >>> lmc.mean(params, with_output(xq, 1))          # output 1 at xq
    >>> lmc.task_correlations(params)                 # learned (P, P)

    ``kernel`` works on the FEATURE columns: one Kernel shares its gram
    across the Q latents, a list of Q kernels gives each latent its own.
    Scalar statistics keep (n,) shapes (each row selects its output)."""

    _event_ndim = 1

    def __init__(self, space=None, location=None, kernel=None, outputs_dim=2, latents=None,
                 inducing=32, learn_inducing=True, *args, **kwargs):
        ks = tuple(kernel) if isinstance(kernel, (list, tuple)) else (kernel,)
        for k in ks:
            if k is not None and (_contains_kernel_noise(k) or isinstance(k, KernelNoise)):
                raise ValueError("LMCSVP takes noise-free latent kernels — per-output "
                                 "observation noise lives in MultiGaussianLik")
        self.n_outputs = int(outputs_dim)
        if latents is None:
            latents = len(ks) if len(ks) > 1 else min(self.n_outputs, 2)
        self.n_latents = int(latents)
        if len(ks) not in (1, self.n_latents):
            raise ValueError(f"kernel list has {len(ks)} entries for {self.n_latents} latents "
                             "(pass one shared kernel or one per latent)")
        self._shared_kernel = len(ks) == 1
        self.f_kernels = ks
        kwargs.setdefault("name", "LMC")
        self.f_mixing = Mixing(self.n_outputs, self.n_latents)
        super().__init__(space=space, location=location, kernel=ks[0],
                         likelihood=MultiGaussianLik(self.n_outputs), inducing=inducing,
                         learn_inducing=learn_inducing, *args, **kwargs)

    def _make_q(self, m):
        return VariationalQHeads(m, self.n_latents)

    # -- the row format ---------------------------------------------------------
    @staticmethod
    def _split(x):
        """(features (n, d), output index (n,)) of row-format ``x``."""
        x = as_tensor(x)
        return x[:, :-1], torch.clamp(torch.round(x[:, -1]).to(torch.int64), min=0)

    def _features(self, x):
        """The host feature slice (dims, defaults, inducing selection)."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        return x[:, :-1] if x.shape[1] > 1 else x

    # -- registration over the feature dims ---------------------------------------
    def _components(self):
        return ([self.f_location] + list(self.f_kernels)
                + [self.f_inducing, self.f_q, self.f_mixing, self.f_likelihood])

    def _check_hypers(self):
        feats = self._features(self.inputs)
        for comp in (self.f_location, *self.f_kernels, self.f_inducing):
            comp.check_dims(feats)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        feats = self._features(self.inputs)
        out = {}
        for comp in (self.f_location, *self.f_kernels, self.f_inducing):
            out.update(comp.default_hypers_dims(feats, self.outputs))
        out.update(self.f_q.default_hypers())
        out.update(self.f_mixing.default_hypers(self.inputs, self.outputs))
        out.update(self.f_likelihood.default_hypers(self.inputs, self.outputs))
        return out

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = super(SparseVariationalProcess, self).observed(
            inputs=inputs, outputs=outputs, order=order, index=index, hidden=hidden)
        x = np.asarray(self._inputs)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError("LMC inputs are (n, d+1) rows whose LAST column is the output "
                             "index (build them with with_output/stack_outputs)")
        idx = np.rint(x[:, -1]).astype(np.int64)
        if idx.min() < 0 or idx.max() >= self.n_outputs:
            raise ValueError(f"output indices must lie in [0, {self.n_outputs}); got "
                             f"[{idx.min()}, {idx.max()}]")
        self.f_inducing.resolve(self._features(x))
        self.f_likelihood.check_targets(self._outputs)
        return out

    # -- latent heads (zero mean: the location is added after the mixing) ---------
    def _latent_heads(self, params, xf, want_cov=False):
        """Per-latent q(f) moments at feature rows xf: mf (..., n, Q),
        varf (..., n, Q) [, covf (..., Q, n, n)]."""
        z = self.f_inducing.value(params)
        qm, lq = self.f_q.factors(params)  # (..., Q, m), (..., Q, m, m)
        if self._shared_kernel:
            k = self.f_kernels[0]
            return _whitened_head_moments(k, lambda p, xx: signal_kernel_diag(k, p, xx),
                                          params, z, xf, qm, lq, want_cov=want_cov,
                                          luu=params.get(STATE_SVP_LUU))
        kuu = to_cov(_stacked_cov(self.f_kernels, params, z))  # (..., Q, m, m)
        m = kuu.shape[-1]
        luu = safe_cholesky(kuu.reshape(-1, m, m)).reshape(kuu.shape)  # one batched K2
        v = solve_lower_triangular(luu, to_num(_stacked_cov(self.f_kernels, params, z, xf)))
        mf = torch.einsum("...qmn,...qm->...nq", v, qm)
        lv = torch.matmul(lq.transpose(-1, -2), v)
        if want_cov:
            kss = to_cov(_stacked_cov(self.f_kernels, params, xf))
            covf = (kss - torch.matmul(v.transpose(-1, -2), v)
                    + torch.matmul(lv.transpose(-1, -2), lv))
            return mf, torch.diagonal(covf, dim1=-2, dim2=-1).transpose(-1, -2), covf
        kdiag = torch.stack([signal_kernel_diag(k, params, xf) for k in self.f_kernels], dim=-2)
        varf = to_bounded(kdiag - (v * v).sum(dim=-2), 0.0) + (lv * lv).sum(dim=-2)
        return mf, varf.transpose(-1, -2)

    def _prior_heads(self, params, xf):
        """Prior per-latent moments: zero mean, each kernel's diagonal."""
        varf = torch.stack([to_bounded(signal_kernel_diag(k, params, xf), 0.0)
                            for k in self.f_kernels], dim=-1)
        if self._shared_kernel:
            varf = varf.expand(varf.shape[:-1] + (self.n_latents,))
        return torch.zeros_like(varf), varf

    def _mixed(self, params, xq, prior=False):
        """Per-row mixed moments at row-format xq: (mg, vg, idx), with mg =
        loc + b_p + W[p] . mf and vg = sum_q W[p, q]^2 varf_q."""
        xf, idx = self._split(xq)
        mf, varf = self._prior_heads(params, xf) if prior else self._latent_heads(params, xf)
        w, b = self.f_mixing.values(params)
        wr = w[..., idx, :]  # (..., n, Q)
        mg = self.f_location(params, xf) + b[..., idx] + (wr * mf).sum(dim=-1)
        vg = (wr * wr * varf).sum(dim=-1)
        return mg, vg, idx

    # -- the bound ----------------------------------------------------------------
    def _ell(self, params, xb, yb, w=None):
        mg, vg, idx = self._mixed(params, xb)
        e = self.f_likelihood.expected_logp_rows(params, yb, idx, mg, vg)
        if w is not None:
            e = e * w
        return e.sum(dim=-1)

    # -- moment statistics (scalar rows) -------------------------------------------
    def th_location(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            return self._mixed(params, space, prior=prior)[0]
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            return self._mixed(params, space, prior=prior)[1]
        return fn

    def th_mean(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_median(self, prior=False, noise=False, simulations=None):
        return self.th_location(prior=prior)

    def th_variance(self, prior=False, noise=False, simulations=None):
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            _, vg, idx = self._mixed(params, space, prior=prior)
            return vg + lik._vars(params)[..., idx] if noise else vg

        return fn

    def th_covariance(self, prior=False, noise=False):
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            xf, idx = self._split(space)
            wr = self.f_mixing.values(params)[0][..., idx, :]  # (..., n, Q)
            if prior:
                covf = to_cov(_stacked_cov(self.f_kernels, params, xf))
                if self._shared_kernel:
                    covf = covf.expand(covf.shape[:-3] + (self.n_latents,) + covf.shape[-2:])
            else:
                covf = self._latent_heads(params, xf, want_cov=True)[2]
            # Cov[g_i, g_j] = sum_q W[p_i, q] W[p_j, q] covf_q[i, j]
            cov = torch.einsum("...iq,...qij,...jq->...ij", wr, covf, wr)
            if noise:
                cov = cov + torch.diag_embed(lik._vars(params)[..., idx])
            return cov

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        """sum_i log N(y_i; mg_i, vg_i + s2_{p_i})."""
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            mg, vg, idx = self._mixed(params, space, prior=prior)
            tot = vg + lik._vars(params)[..., idx]
            return (-0.5 * (LOG2PI + torch.log(tot)) - 0.5 * (vector - mg) ** 2 / tot).sum(dim=-1)

        return fn

    # -- serving -----------------------------------------------------------------------
    def posterior_state(self, params=None):
        """With a shared kernel, the factor of its inducing gram (as the SVP
        family's); with one kernel a latent, none (the Q factors come from
        the params at each query batch)."""
        if self._shared_kernel:
            return super().posterior_state(params)
        return {}

    # -- extras ----------------------------------------------------------------------
    def task_correlations(self, params=None):
        """The learned cross-output latent correlation (P, P): B = W W'
        normalized to a unit diagonal (host numpy)."""
        params = self.params if params is None else params
        w = _np(params[self.f_mixing.w.name]).astype(np.float64) \
            if is_param(self.f_mixing.w) else np.asarray(self.f_mixing.w, np.float64)
        b = w @ w.T
        d = np.sqrt(np.maximum(np.diagonal(b), 1e-12))
        return b / np.outer(d, d)

    def predict_proba(self, params=None, space=None, prior=False):
        raise ValueError("LMCSVP is a regression family (no classes)")

    # -- host-side sampling / quantiles ----------------------------------------------
    def _host_mixed(self, params, space, inputs, outputs, prior, noise):
        params = self.params if params is None else params
        space = self.space if space is None else space
        mg = _np(self.location(params, space, inputs, outputs, prior=prior))
        vg = np.maximum(_np(self.kernel_diag(params, space, inputs, outputs, prior=prior)), 0.0)
        if noise:
            s2 = np.maximum(_np(params[self.f_likelihood.var.name]), 1e-10)
            vg = vg + s2[np.rint(np.asarray(space)[:, -1]).astype(np.int64)]
        return mg, vg

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """(n, samples) mean-field draws of g (``noise=False``) or y
        (``noise=True``) on the host, numpy ``rng`` (default seed 0)."""
        mg, vg = self._host_mixed(params, space, inputs, outputs, prior, noise)
        rng = np.random.default_rng(0) if rng is None else rng
        return mg[:, None] + np.sqrt(vg)[:, None] * rng.standard_normal(
            (len(mg), samples)).astype(settings.floatx)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Analytic normal predictive quantiles a row."""
        from scipy import stats

        mg, vg = self._host_mixed(params, space, inputs, outputs, prior, noise)
        return stats.norm.ppf(q, loc=mg, scale=np.sqrt(np.maximum(vg, 1e-12)))
