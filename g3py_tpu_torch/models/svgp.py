"""The non-conjugate sparse variational GP, q(u) as model parameters (the
PyTorch counterpart of :mod:`g3py_tpu.models.svgp`).

The whitened variational posterior q(w) = N(qm, Lq Lq') over the inducing
values u = loc(z) + Luu w lives in ordinary model parameters (a
:class:`VariationalQ` component registers ``qm`` and ``ql``), and
``loglike`` is the uncollapsed evidence lower bound

    sum_i E_{q(f_i)}[log p(y_i | f_i)] - KL(q(w) || N(0, I)),

a deterministic function of (hypers, q): ``find_MAP``, ``sample_hypers``
and the scores work unchanged and ``predict`` reads q from the params
dict.  One evaluation is one (m, m) gram and one (m, n) cross gram (K1 on
the card), one m x m factorization (K2) and an (m, n) triangular solve.
The likelihood is a :mod:`~g3py_tpu_torch.models.likelihoods` component;
:class:`MulticlassSVP` (softmax over C heads) and
:class:`HeteroscedasticSVP` (signal and log-noise heads) share one kernel
and inducing set over several latent heads.

The moment statistics: ``location``/``kernel_diag`` are the latent f
moments (prior or posterior); ``mean`` the predictive E[y];
``variance``/``std`` Var[f] with ``noise=False``, the predictive Var[y]
with ``noise=True``.  The sampler and quantiles run on the host (numpy).

A params dict of R hyperparameter rows (a sampler's walkers, a datatrace)
gives R bounds and (R, n) moments: the rows' grams are one batched K1
launch each (Kuu and Kuf) and their Kuu factors one batched K2 launch; the
likelihood's elementwise terms run under ``torch.func.vmap`` over the rows.
``mesh=`` waits for ROADMAP item 16.
"""

import numpy as np
import torch

from ..bayesian.advi import _Adam
from ..config import settings, as_tensor, host_statistic
from ..hypers import Hypers, Flat, hval
from ..hypers.kernels import KernelNoise
from ..hypers.means import Zero
from ..ops.guards import to_num, to_cov, to_bounded
from ..ops.linalg import safe_cholesky, solve_lower_triangular
from .elliptical import _contains_kernel_noise
from .likelihoods import (LOG2PI, GaussianLik, Likelihood, BernoulliLik, PoissonLik,
                          OrdinalLik, CategoricalLik, HeteroscedasticLik)
from .sparse import make_inducing, signal_kernel_diag, _index_draws, _guard_loss, _NO_MESH
from .stochastic import StochasticProcess, _statistic

__all__ = ["VariationalQ", "VariationalQHeads", "SparseVariationalProcess", "SVP",
           "MulticlassSVP", "HeteroscedasticSVP"]

#: the serving state: the inducing gram's factor (m, m), so that a query
#: batch needs no factorization
STATE_SVP_LUU = "_state_svp_luu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sum_last(t, k):
    """Sum over the last ``k`` axes."""
    return t.flatten(start_dim=t.ndim - k).sum(dim=-1)


def _logsumexp_w(lp, w):
    """log sum_j w_j exp(lp_j) over the first axis (weights floored at 1e-30)."""
    return torch.logsumexp(lp + torch.log(torch.clamp(w, min=1e-30))[:, None], dim=0)


class VariationalQ(Hypers):
    """The whitened q(w) = N(qm, Lq Lq') as a hyper-bearing component: ``qm``
    (m,) and ``ql`` (m, m), whose strict lower triangle is Lq's and whose
    diagonal is log diag Lq (all zeros: q = the prior, KL = 0).  Flat
    priors: the ELBO's KL is their regularizer."""

    def __init__(self, m, name=None):
        self.m = int(m)
        self.qm = None
        self.ql = None
        super().__init__(name=name if name is not None else "Q")

    def check_hypers(self, parent=""):
        if self.qm is None:
            self.qm = self._param(None, parent + self.name + "_qm", prior=Flat(),
                                  shape=(self.m,))
        if self.ql is None:
            self.ql = self._param(None, parent + self.name + "_ql", prior=Flat(),
                                  shape=(self.m, self.m))

    def default_hypers(self, x=None, y=None):
        return {self.qm: np.zeros((self.m,), settings.floatx),
                self.ql: np.zeros((self.m, self.m), settings.floatx)}

    def factors(self, params):
        """(qm, Lq), Lq = tril(ql, -1) + diag(exp(diag(ql)))."""
        ql = hval(self.ql, params)
        return hval(self.qm, params), torch.tril(ql, -1) + torch.diag_embed(
            torch.exp(torch.diagonal(ql, dim1=-2, dim2=-1)))

    def kl(self, params):
        """KL(q(w) || N(0, I)) = (|qm|^2 + |Lq|_F^2 - 2 sum log diag - m) / 2,
        summed over heads (one a row for a params dict of rows)."""
        qm, lq = self.factors(params)
        ld = torch.diagonal(hval(self.ql, params), dim1=-2, dim2=-1)
        k = 1 + hasattr(self, "heads")  # the event axes of qm: (m,) or (heads, m)
        return 0.5 * (_sum_last(qm * qm, k) + _sum_last(lq * lq, k + 1)
                      - 2.0 * _sum_last(ld, k) - self.m * getattr(self, "heads", 1))


class VariationalQHeads(VariationalQ):
    """``heads`` independent whitened posteriors over one inducing set:
    ``qm`` (heads, m), ``ql`` (heads, m, m), each head's Lq built as
    :class:`VariationalQ` builds it."""

    def __init__(self, m, heads, name=None):
        self.heads = int(heads)
        super().__init__(m, name=name)

    def check_hypers(self, parent=""):
        if self.qm is None:
            self.qm = self._param(None, parent + self.name + "_qm", prior=Flat(),
                                  shape=(self.heads, self.m))
        if self.ql is None:
            self.ql = self._param(None, parent + self.name + "_ql", prior=Flat(),
                                  shape=(self.heads, self.m, self.m))

    def default_hypers(self, x=None, y=None):
        return {self.qm: np.zeros((self.heads, self.m), settings.floatx),
                self.ql: np.zeros((self.heads, self.m, self.m), settings.floatx)}


class SparseVariationalProcess(StochasticProcess):
    """Sparse variational GP with an elementwise likelihood.

    >>> svp = g3t.SVP(space=x, kernel=g3t.SE(x), likelihood=g3t.StudentTLik(),
    ...               inducing=32)
    >>> svp.observed(x, y)
    >>> params, losses = svp.fit_svgp(batch_size=1024, steps=2000)
    >>> pred = svp.predict(params)

    The signal kernel must be noise-free (the noise is the likelihood's);
    ``inducing`` follows the sparse family's conventions."""

    #: the axes of one row's latent mean: (n,) here, (n, heads) for the
    #: multi-head variants; one more leading axis is the hyperparameter rows
    _event_ndim = 1

    def __init__(self, space=None, location=None, kernel=None, likelihood: Likelihood = None,
                 inducing=32, learn_inducing=True, *args, **kwargs):
        self.f_location = location if location is not None else Zero()
        self.f_kernel = kernel
        self.f_likelihood = likelihood if likelihood is not None else GaussianLik()
        self.f_inducing = make_inducing(inducing, learn_inducing)
        self.f_q = self._make_q(self.f_inducing.m)
        if kernel is not None and (_contains_kernel_noise(kernel)
                                   or isinstance(kernel, KernelNoise)):
            raise ValueError(
                "SparseVariationalProcess takes a noise-free signal kernel — observation "
                "noise belongs to the likelihood component")
        kwargs["space"] = space
        kwargs.setdefault("name", "SVP")
        super().__init__(*args, **kwargs)

    def _make_q(self, m):
        """Variational-posterior component factory (subclass hook)."""
        return VariationalQ(m)

    # -- registration ---------------------------------------------------------
    def _components(self):
        return [self.f_location, self.f_kernel, self.f_inducing, self.f_q, self.f_likelihood]

    def _check_hypers(self):
        for comp in (self.f_location, self.f_kernel, self.f_inducing):
            comp.check_dims(self.inputs)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        out = {}
        for comp in self._components():
            out.update(comp.default_hypers_dims(self.inputs, self.outputs))
        return out

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = super().observed(inputs=inputs, outputs=outputs, order=order, index=index,
                               hidden=hidden)
        self.f_inducing.resolve(self._inputs)
        self.f_likelihood.check_targets(self._outputs)
        return out

    # -- core math ------------------------------------------------------------
    def _kernel_diag_only(self, params, x):
        return signal_kernel_diag(self.f_kernel, params, x)

    def _whitened(self, params, xq):
        """(z, v = Luu^{-1} K(z, xq)); Luu from the serving state when one
        rides in ``params``."""
        z = self.f_inducing.value(params)
        luu = params.get(STATE_SVP_LUU)
        if luu is None:
            luu = safe_cholesky(to_cov(self.f_kernel.cov(params, z)))
        return z, solve_lower_triangular(luu, to_num(self.f_kernel.cov(params, z, xq)))

    def _latent(self, params, xq, want_cov=False):
        """Latent q(f) moments at xq: (mf, varf[, covf]), with a leading
        row axis for a params dict of rows."""
        _, v = self._whitened(params, xq)
        qm, lq = self.f_q.factors(params)
        mf = self.f_location(params, xq) + torch.einsum("...mn,...m->...n", v, qm)
        lv = torch.matmul(lq.transpose(-1, -2), v)
        if want_cov:
            covf = (to_cov(self.f_kernel.cov(params, xq)) - torch.matmul(v.transpose(-1, -2), v)
                    + torch.matmul(lv.transpose(-1, -2), lv))
            return mf, torch.diagonal(covf, dim1=-2, dim2=-1), covf
        varf = to_bounded(self._kernel_diag_only(params, xq) - (v * v).sum(dim=-2), 0.0) \
            + (lv * lv).sum(dim=-2)
        return mf, varf

    def _per_row(self, fn, params, *moments):
        """``fn(params, *moments)`` of one row's params and moments; under
        ``torch.func.vmap`` over the rows when the moments carry a row axis
        (the likelihoods' elementwise terms are written for one row)."""
        if moments[0].ndim <= self._event_ndim:
            return fn(params, *moments)
        return torch.func.vmap(fn)(params, *moments)

    def _prior_moments(self, params, space):
        return (self.f_location(params, space),
                to_bounded(self._kernel_diag_only(params, space), 0.0))

    # -- the bound ------------------------------------------------------------
    def _ell(self, params, xb, yb, w=None):
        """The expected log-likelihood summed over a batch of rows (the
        ELBO's data term); ``w`` weights the rows."""
        mf, varf = self._latent(params, xb)
        e = self._per_row(lambda p, m, v: self.f_likelihood.expected_logp(p, yb, m, v),
                          params, mf, varf)
        if w is not None:
            e = e * w
        return e.sum(dim=-1)

    def th_loglike_fn(self):
        """The uncollapsed ELBO (this process's ``loglike``); non-finite
        gives ``settings.logp_guard``."""

        def fn(params, space, inputs, outputs):
            elbo = self._ell(params, inputs, outputs) - self.f_q.kl(params)
            g = settings.logp_guard
            return torch.where(~torch.isfinite(elbo), torch.full_like(elbo, g),
                               to_num(elbo, nan=g, neginf=g))

        return fn

    # -- moment statistics ----------------------------------------------------
    def _moments(self, params, space, prior):
        return self._prior_moments(params, space) if prior else self._latent(params, space)

    def th_location(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            return self._moments(params, space, prior)[0]
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            return self._moments(params, space, prior)[1]
        return fn

    def _predictive(self, params, mf, varf):
        """The likelihood's predictive (mean, variance), one a row."""
        return self._per_row(self.f_likelihood.predictive_moments, params, mf, varf)

    def th_mean(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            return self._predictive(params, *self._moments(params, space, prior))[0]
        return fn

    def th_median(self, prior=False, noise=False, simulations=None):
        # mean == median only for symmetric conditionals
        if isinstance(self.f_likelihood, (BernoulliLik, PoissonLik, OrdinalLik)):
            return None
        return self.th_mean(prior=prior, noise=noise)

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            mf, varf = self._moments(params, space, prior)
            if noise:
                return self._predictive(params, mf, varf)[1]
            return varf
        return fn

    def th_covariance(self, prior=False, noise=False):
        lik = self.f_likelihood
        if noise and type(lik).noise_var is Likelihood.noise_var:
            raise ValueError(
                f"{type(lik).__name__} has no additive-noise decomposition, so a noisy "
                "predictive COVARIANCE has no closed form (the diagonal is available via "
                "variance(noise=True); joint draws via sampler)")

        def fn(params, space, inputs, outputs, vector):
            if prior:
                covf = to_cov(self.f_kernel.cov(params, space))
            else:
                covf = self._latent(params, space, want_cov=True)[2]
            if noise:
                covf = covf + lik.noise_var(params) * torch.eye(
                    covf.shape[0], dtype=covf.dtype, device=covf.device)
            return covf

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        """sum_i log E_{q(f_i)}[p(y_i | f_i)] (a Gauss-Hermite log-sum-exp a
        point): the NLPD numerator of the scores."""
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            def one(params, mf, varf):
                f, w = lik._grid(mf, varf)
                return _logsumexp_w(lik.logp_elem(params, vector[None, :], f), w).sum()

            return self._per_row(one, params, *self._moments(params, space, prior))

        return fn

    location = _statistic("th_location", "Latent location of q(f) (or of the prior).")
    kernel_diag = _statistic("th_kernel_diag", "Latent marginal variance of q(f).")

    # -- serving ---------------------------------------------------------------
    def posterior_state(self, params=None):
        """The variational family has no n-sized factorization: every
        statistic is O(m^2) from (z, q(u)) in the params.  The state is the
        inducing gram's factor alone (m, m), so that a query batch, and an
        exported artifact, needs no factorization."""
        p = self._tensor_params(self.params if params is None else params)
        with torch.no_grad():
            z = self.f_inducing.value(p)
            return {STATE_SVP_LUU: safe_cholesky(to_cov(self.f_kernel.cov(p, z)))}

    def predictor(self, params=None):
        """Serving wrapper: the params and the factor of the inducing gram
        baked into a :class:`~g3py_tpu_torch.models.predictor.Predictor`;
        its ``export`` writes the m-sized arrays only."""
        from .predictor import Predictor

        return Predictor(self, params)

    # -- classification conveniences -------------------------------------------
    def predict_proba(self, params=None, space=None, prior=False):
        """Predictive class probabilities (n, C) for the likelihoods whose
        are analytic under a gaussian q(f): Bernoulli ([P(y=0), P(y=1)]) and
        Ordinal (C ordered levels)."""
        lik = self.f_likelihood
        params = self.params if params is None else params
        mf = self.location(params, space, prior=prior)
        varf = self.kernel_diag(params, space, prior=prior)
        with torch.no_grad():
            if isinstance(lik, BernoulliLik):
                p1 = _np(lik.predictive_moments(params, mf, varf)[0])
                return np.stack([1.0 - p1, p1], axis=-1)
            if isinstance(lik, OrdinalLik):
                return _np(lik.probs(self._tensor_params(params), mf, varf))
        raise ValueError(
            "predict_proba needs a classification likelihood with analytic class "
            f"probabilities (Bernoulli/Ordinal), got {type(lik).__name__}")

    def predict_class(self, params=None, space=None, prior=False):
        """argmax-probability class labels (n,)."""
        return np.argmax(self.predict_proba(params, space, prior=prior), axis=-1)

    # -- host-side sampling / quantiles ---------------------------------------
    def _host_moments(self, params, space, inputs, outputs, prior):
        mf = _np(self.location(params, space, inputs, outputs, prior=prior))
        sd = np.sqrt(np.maximum(_np(self.kernel_diag(params, space, inputs, outputs,
                                                     prior=prior)), 0.0))
        return mf, sd

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """y draws on the host, (n, samples): f ~ q(f) elementwise, then y | f
        through the likelihood (numpy ``rng``, default seed 0)."""
        from .likelihoods import sample_conditional

        params = self.params if params is None else params
        mf, sdf = self._host_moments(params, space, inputs, outputs, prior)
        rng = np.random.default_rng(0) if rng is None else rng
        f = mf[:, None] + sdf[:, None] * rng.standard_normal(
            (len(mf), samples)).astype(settings.floatx)
        if not noise:
            return f
        return sample_conditional(self.f_likelihood, params, f, rng)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Predictive quantiles: the normal's for the gaussian likelihood (or
        the latent's, pushed through a monotone link), Monte Carlo through
        the likelihood otherwise."""
        from scipy import stats

        params = self.params if params is None else params
        lik = self.f_likelihood
        if isinstance(lik, GaussianLik) or not noise:
            mu = _np(self.location(params, space, inputs, outputs, prior=prior))
            var = _np(self.kernel_diag(params, space, inputs, outputs, prior=prior))
            if noise:
                var = var + float(np.maximum(_np(hval(lik.var, params)), 1e-10))
            out = stats.norm.ppf(q, loc=mu, scale=np.sqrt(np.maximum(var, 1e-12)))
            if isinstance(lik, BernoulliLik):
                out = stats.norm.cdf(out)  # monotone probit
            elif isinstance(lik, PoissonLik):
                out = np.exp(np.clip(out, -30, 30))  # monotone log link
            return out
        draws = self.sampler(params, space, inputs, outputs, samples=500, prior=prior,
                             noise=True, rng=np.random.default_rng(7))
        return np.quantile(draws, q, axis=1)

    # -- minibatch training ---------------------------------------------------
    def fit_svgp(self, batch_size=1024, steps=2000, lr=1e-2, start=None, key=0, display=True,
                 mesh=None):
        """Minibatch Adam on the bound over every parameter (hypers and q —
        q lives in the param vector): one value-and-gradient evaluation a
        step, O(|B| m^2).  ``batch_size >= n`` is the deterministic full
        batch; ``key`` as for the sparse family's ``fit_svgp`` (a seed, a
        ``torch.Generator`` or a (steps, |B|) array of the draws).  Returns
        ``(params, losses)``."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        reg = self.active
        if start is None:
            start = self.params_default
        u = as_tensor(reg.dict_to_array(start))
        x_all, y_all = self._device_data("inputs"), self._device_data("outputs")
        n = x_all.shape[0]
        bs = int(min(batch_size, n))
        scale = n / bs
        draw = None if bs >= n else _index_draws(key, steps, bs, n, x_all.device)
        prior_pure = self._logp_pure(prior=True)
        opt = _Adam(u, lr)
        losses = torch.empty(int(steps), dtype=u.dtype, device=u.device)
        for i in range(int(steps)):
            if draw is None:
                xb, yb = x_all, y_all
            else:
                idx = draw(i)
                xb, yb = x_all[idx], y_all[idx]
            with torch.enable_grad():
                uu = u.detach().requires_grad_(True)
                p = reg.array_to_dict_tensor(uu)
                loss = _guard_loss(scale * self._ell(p, xb, yb) - self.f_q.kl(p)
                                   + prior_pure(p, xb, xb, yb))
                (g,) = torch.autograd.grad(loss, uu)
            losses[i] = loss.detach()
            u = opt.step(u, g)
        losses = losses.cpu().numpy()
        if display:
            print(f"SVP fit_svgp: {steps} steps, -elbo {losses[0]:.1f} -> "
                  f"{losses[-1]:.1f} (batch {bs}, n {n})")
        return reg.array_to_dict(u.detach().cpu().numpy()), losses

    def _fit_svgp_sharded(self, mesh, **kwargs):
        raise NotImplementedError(_NO_MESH)


def _whitened_head_moments(kernel, kdiag_fn, params, z, xq, qm, lq, want_cov=False,
                           luu=None):
    """Zero-mean whitened-head q(f) moments of H latent GPs over one kernel
    and inducing set: mf (n, H), varf (n, H) [, covf (H, n, n)] — one Kuu
    factorization and one cross solve, the heads batched products."""
    if luu is None:
        luu = safe_cholesky(to_cov(kernel.cov(params, z)))
    v = solve_lower_triangular(luu, to_num(kernel.cov(params, z, xq)))
    mf = torch.einsum("...mn,...cm->...nc", v, qm)
    lv = torch.einsum("...cji,...jn->...cin", lq, v)
    if want_cov:
        base = to_cov(kernel.cov(params, xq)) - torch.matmul(v.transpose(-1, -2), v)
        covf = base[..., None, :, :] + torch.einsum("...cin,...cip->...cnp", lv, lv)
        return mf, torch.diagonal(covf, dim1=-2, dim2=-1).transpose(-1, -2), covf
    base = to_bounded(kdiag_fn(params, xq) - (v * v).sum(dim=-2), 0.0)
    return mf, base[..., None] + (lv * lv).sum(dim=-2).transpose(-1, -2)


class _MultiHeadLatent:
    """Shared algebra of the SVP variants with ``n_heads`` latent GPs over
    one kernel and inducing set; q(u) is :class:`VariationalQHeads`."""

    n_heads = None  # set by the subclass before StochasticProcess.__init__
    _event_ndim = 2

    def _make_q(self, m):
        return VariationalQHeads(m, self.n_heads)

    def _latent(self, params, xq, want_cov=False):
        """Per-head latent moments at xq: mf (n, H), varf (n, H) [, covf
        (H, n, n)]."""
        qm, lq = self.f_q.factors(params)
        out = _whitened_head_moments(self.f_kernel, self._kernel_diag_only, params,
                                     self.f_inducing.value(params), xq, qm, lq,
                                     want_cov=want_cov, luu=params.get(STATE_SVP_LUU))
        loc = self.f_location(params, xq)[..., None]
        return (loc + out[0],) + tuple(out[1:])

    def _moments(self, params, space, prior):
        """(mf, varf), both (n, H); the prior is the scalar GP prior a head."""
        if prior:
            mf0, var0 = self._prior_moments(params, space)
            shp = mf0.shape + (self.n_heads,)
            return mf0[..., None].expand(shp), var0[..., None].expand(shp)
        return self._latent(params, space)


class MulticlassSVP(_MultiHeadLatent, SparseVariationalProcess):
    """Sparse variational softmax classification over C classes: one latent
    GP a class sharing the kernel hypers and the inducing set, C
    independent whitened heads, the analytic Jensen softmax bound
    (:class:`~g3py_tpu_torch.models.likelihoods.CategoricalLik`).  The
    statistics carry a trailing class axis: ``mean`` is the class
    probability matrix (n, C), ``variance(noise=True)`` its Bernoulli
    variances."""

    def __init__(self, space=None, location=None, kernel=None, classes=3, inducing=32,
                 learn_inducing=True, *args, **kwargs):
        self.n_classes = self.n_heads = int(classes)
        kwargs.setdefault("name", "SVC")
        super().__init__(space=space, location=location, kernel=kernel,
                         likelihood=CategoricalLik(classes), inducing=inducing,
                         learn_inducing=learn_inducing, *args, **kwargs)

    def th_mean(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            return self._per_row(self.f_likelihood.probs, params,
                                 *self._moments(params, space, prior))
        return fn

    def th_median(self, prior=False, noise=False, simulations=None):
        return None

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            mf, varf = self._moments(params, space, prior)
            if noise:
                return self.f_likelihood.predictive_moments(params, mf, varf)[1]
            return varf
        return fn

    def th_covariance(self, prior=False, noise=False):
        if noise:
            raise ValueError(
                "categorical observations have no additive-noise covariance; the "
                "class-probability variances are available via variance(noise=True)")

        def fn(params, space, inputs, outputs, vector):
            if prior:
                covf = to_cov(self.f_kernel.cov(params, space))
                return covf[None].expand((self.n_classes,) + covf.shape)
            return self._latent(params, space, want_cov=True)[2]

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        """sum_i log E_q[softmax(f_i)_{y_i}] (fixed common-random-number MC)."""
        def fn(params, space, inputs, outputs, vector):
            def one(params, mf, varf):
                return self.f_likelihood.log_predictive(params, vector, mf, varf).sum()

            return self._per_row(one, params, *self._moments(params, space, prior))
        return fn

    def predict_proba(self, params=None, space=None, prior=False):
        """Predictive class probabilities (n, C); rows sum to 1."""
        return _np(self.mean(params, space, prior=prior))

    def predict_class(self, params=None, space=None, prior=False):
        return np.argmax(self.predict_proba(params, space, prior=prior), axis=-1)

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """``noise=False``: latent draws (n, C, samples) from the mean-field
        q; ``noise=True``: class labels (n, samples) through the softmax."""
        rng = np.random.default_rng(0) if rng is None else rng
        mf, sd = self._host_moments(self.params if params is None else params, space,
                                    inputs, outputs, prior)
        f = mf[:, :, None] + sd[:, :, None] * rng.standard_normal(
            mf.shape + (samples,)).astype(settings.floatx)
        if not noise:
            return f
        e = np.exp(f - f.max(axis=1, keepdims=True))
        cum = np.cumsum(e / e.sum(axis=1, keepdims=True), axis=1)
        u = rng.uniform(size=(f.shape[0], 1, samples))
        # against the C-1 interior boundaries: the float32 cumsum's last
        # entry can land just below 1
        return (u > cum[:, :-1, :]).sum(axis=1).astype(settings.floatx)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Per-class probability quantiles (n, C), Monte Carlo through the
        softmax."""
        f = self.sampler(params, space, inputs, outputs, samples=400, prior=prior,
                         noise=False, rng=np.random.default_rng(7))
        e = np.exp(f - f.max(axis=1, keepdims=True))
        return np.quantile(e / e.sum(axis=1, keepdims=True), q, axis=-1)

    def scores(self, params=None, space=None, hidden=None, inputs=None, outputs=None,
               logp=False, logpred=False, bias=True, variance=False, median=False, *args,
               **kwargs):
        """Classification metrics: ``_accuracy``/``_brier`` (bias),
        ``_nlpd`` (logpred), ``_logp``/``_loglike``/``_logprior`` (logp),
        ``_mean_prob_var`` (variance)."""
        from ..utils import DictObj

        if hidden is None:
            hidden = self.hidden
        if hidden is None:
            hidden = self.outputs
        y = np.asarray(hidden).astype(np.int64)
        probs = self.predict_proba(params, space)
        out = DictObj()
        if bias:
            out["_accuracy"] = float(np.mean(np.argmax(probs, -1) == y))
            onehot = np.eye(probs.shape[1], dtype=np.float64)[y]
            out["_brier"] = float(np.mean(np.sum((probs - onehot) ** 2, -1)))
        if variance:
            out["_mean_prob_var"] = float(np.mean(_np(
                self.variance(params, space, inputs, outputs, noise=True))))
        if logp:
            out["_logp"] = self.logp(params)
            out["_loglike"] = self.loglike(params)
            out["_logprior"] = self.logp(params, prior=True)
        if logpred:
            out["_nlpd"] = -float(self.logpredictive(
                params, space, inputs, outputs, vector=np.asarray(y, settings.floatx))) / len(y)
        return out


class HeteroscedasticSVP(_MultiHeadLatent, SparseVariationalProcess):
    """Sparse variational heteroscedastic regression: y ~ N(f1, exp(f2 + b)),
    f1 the signal and f2 the log-noise shape over one kernel and inducing
    set, ``b`` the likelihood's trainable level
    (:class:`~g3py_tpu_torch.models.likelihoods.HeteroscedasticLik`, an
    analytic ELBO).  Scalar statistics keep (n,) shapes;
    :meth:`noise_field` is the learned noise variance."""

    n_heads = 2

    def __init__(self, space=None, location=None, kernel=None, inducing=32,
                 learn_inducing=True, *args, **kwargs):
        kwargs.setdefault("name", "HET")
        super().__init__(space=space, location=location, kernel=kernel,
                         likelihood=HeteroscedasticLik(), inducing=inducing,
                         learn_inducing=learn_inducing, *args, **kwargs)

    def th_mean(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            return self._predictive(params, *self._moments(params, space, prior))[0]
        return fn

    def th_median(self, prior=False, noise=False, simulations=None):
        return self.th_mean(prior=prior, noise=noise)

    def th_variance(self, prior=False, noise=False, simulations=None):
        def fn(params, space, inputs, outputs, vector):
            mf, varf = self._moments(params, space, prior)
            if noise:
                return self._predictive(params, mf, varf)[1]
            return varf[..., 0]
        return fn

    def th_covariance(self, prior=False, noise=False):
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            if prior:
                covf = to_cov(self.f_kernel.cov(params, space))
                if not noise:
                    return covf
                mf, varf = self._moments(params, space, True)
            else:
                mf, varf, covs = self._latent(params, space, want_cov=True)
                covf = covs[0]
            if noise:
                covf = covf + torch.diag(lik.noise_mean(params, mf, varf))
            return covf

        return fn

    def th_logpredictive(self, prior=False, noise=False):
        """sum_i log E_q[N(y_i; f1, exp(f2 + b))]: analytic in f1 given f2,
        one Gauss-Hermite quadrature over the log-noise head."""
        lik = self.f_likelihood

        def fn(params, space, inputs, outputs, vector):
            def one(params, mf, varf):
                m1, m2, v1, v2 = lik._split(mf, varf, params)
                g, w = lik._grid(m2, v2)
                tot = v1[None, :] + torch.exp(torch.clamp(g, -30.0, 30.0))
                lp = -0.5 * (LOG2PI + torch.log(tot)) \
                    - 0.5 * (vector[None, :] - m1[None, :]) ** 2 / tot
                return _logsumexp_w(lp, w).sum()

            return self._per_row(one, params, *self._moments(params, space, prior))

        return fn

    def noise_field(self, params=None, space=None, prior=False):
        """The predictive noise variance E[exp(f2 + b)] at the query points
        (n,), on the host."""
        params = self.params if params is None else params
        mf = self.location(params, space, prior=prior)
        vf = self.kernel_diag(params, space, prior=prior)
        with torch.no_grad():
            return _np(self.f_likelihood.noise_mean(
                self._tensor_params(self.filter_params(params)), mf, vf))

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False, rng=None):
        """(n, samples) y draws: the heads from the mean-field q, then y = f1
        + exp((f2 + b) / 2) xi with ``noise`` (the signal head without)."""
        params = self.params if params is None else params
        rng = np.random.default_rng(0) if rng is None else rng
        mf, sd = self._host_moments(params, space, inputs, outputs, prior)
        f = mf[:, :, None] + sd[:, :, None] * rng.standard_normal(
            mf.shape + (samples,)).astype(settings.floatx)
        if not noise:
            return f[:, 0, :]
        b = float(_np(hval(self.f_likelihood.bias, params)))
        s = np.exp(np.clip(0.5 * (f[:, 1, :] + b), -15.0, 15.0))
        return f[:, 0, :] + s * rng.standard_normal(s.shape).astype(settings.floatx)

    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False, simulations=None):
        """Monte-Carlo predictive quantiles through the scale mixture."""
        draws = self.sampler(params, space, inputs, outputs, samples=500, prior=prior,
                             noise=noise, rng=np.random.default_rng(7))
        return np.quantile(draws, q, axis=-1)


SVP = SparseVariationalProcess
