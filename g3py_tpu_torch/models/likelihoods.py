"""Observation likelihoods of the non-conjugate sparse variational family
(the PyTorch counterpart of :mod:`g3py_tpu.models.likelihoods`).

Each likelihood is an elementwise p(y_i | f_i) over the latent GP value
that :class:`~g3py_tpu_torch.models.svgp.SparseVariationalProcess`
integrates over its gaussian q(f), and a
:class:`~g3py_tpu_torch.hypers.Hypers` component: its parameters (noise
scale, degrees of freedom, cutpoints, dispersion) are ordinary model
hypers.

* :class:`GaussianLik` (analytic expected log-likelihood), :class:`StudentTLik`
  (robust regression), :class:`PoissonLik` (log link; analytic expected
  log-likelihood and moments), :class:`NegBinomialLik` (overdispersed
  counts), :class:`BernoulliLik` (probit; analytic class probability),
  :class:`OrdinalLik` (cumulative probit), :class:`HeteroscedasticLik`
  (two heads: signal and log-noise; analytic) and :class:`CategoricalLik`
  (softmax over a class axis; the analytic Jensen bound).
* :meth:`Likelihood.expected_logp` and :meth:`Likelihood.predictive_moments`
  default to a ``degree``-point Gauss-Hermite sum over the latent gaussian;
  the subclasses override them where the integral is analytic, as the JAX
  package does.
* The special functions: ``torch.special.log_ndtr`` (scipy's accuracy:
  the JAX package's loses ~1e-3 relative in the upper tail 5 < x < 8 in
  float64), :func:`~g3py_tpu_torch.ops.special.ndtr` (the JAX package's
  two-tailed form; torch's own cancels in the lower tail),
  ``torch.lgamma`` and ``torch.logsumexp``.  The constants log 2 pi,
  sqrt 2 and sqrt pi are rounded to float32, as the JAX package writes
  them, in either dtype.
* :func:`sample_conditional` draws y | f on the host (numpy/scipy).
"""

import math

import numpy as np
import torch

from ..config import settings, as_tensor
from ..hypers import Hypers, Flat, FlatExp, hval, is_param
from ..ops.quadrature import hermgauss
from ..ops.special import ndtr

__all__ = ["Likelihood", "GaussianLik", "StudentTLik", "BernoulliLik",
           "PoissonLik", "NegBinomialLik", "OrdinalLik", "CategoricalLik",
           "HeteroscedasticLik", "sample_conditional"]

# float32-rounded, as the JAX package's module constants are
LOG2PI = float(np.float32(np.log(2.0 * np.pi)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_SQRTPI = float(np.float32(np.sqrt(np.pi)))


def _labels(y, device):
    """Class labels as an int64 tensor on ``device``."""
    if isinstance(y, torch.Tensor):
        return y.to(device=device).long()
    return torch.as_tensor(np.asarray(y), device=device).long()


def _host(h, params):
    """A hyper's value on the host as a float64 array (``params`` holds
    numpy arrays or tensors)."""
    v = params[h.name] if is_param(h) else h
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


class Likelihood(Hypers):
    """Elementwise observation model p(y | f) over the latent value f.

    Subclasses implement :meth:`logp_elem`, :meth:`cond_mean` and
    :meth:`cond_var`; the base class integrates them over f ~ N(mu, var)
    with a ``degree``-point Gauss-Hermite rule (:meth:`expected_logp`, the
    ELBO's data term, and :meth:`predictive_moments`, through the law of
    total variance)."""

    degree = 20

    def logp_elem(self, params, y, f):
        raise NotImplementedError

    def cond_mean(self, params, f):
        raise NotImplementedError

    def cond_var(self, params, f):
        raise NotImplementedError

    def _grid(self, mu, var):
        """``(f, w)``: the (degree, n) quadrature nodes over N(mu, var) and
        their weights over sqrt(pi)."""
        mu, var = as_tensor(mu), as_tensor(var)
        a, w = hermgauss(self.degree, settings.dtype, mu.device)
        sd = torch.sqrt(torch.clamp(var, min=1e-12))
        f = mu[None, :] + _SQRT2 * sd[None, :] * a[:, None]
        return f, w / _SQRTPI

    def expected_logp(self, params, y, mu, var):
        f, w = self._grid(mu, var)
        lp = self.logp_elem(params, as_tensor(y)[None, :], f)
        return torch.matmul(w, lp)

    def predictive_moments(self, params, mu, var):
        f, w = self._grid(mu, var)
        cm = self.cond_mean(params, f)
        m = torch.matmul(w, cm)
        e2 = torch.matmul(w, self.cond_var(params, f) + cm * cm)
        return m, torch.clamp(e2 - m * m, min=0.0)

    def noise_var(self, params):
        """Marginal observation-noise variance (f-independent), or None
        where no additive-noise decomposition exists (Bernoulli, counts)."""
        return None

    def check_targets(self, y):
        """Host-side validation of observed targets (subclass hook)."""
        return None

    def latent_guess(self, y):
        """Host map of targets into latent space (identity here)."""
        return np.asarray(y, settings.floatx)


class GaussianLik(Likelihood):
    """y = f + eps, eps ~ N(0, var): the conjugate baseline, analytic."""

    def __init__(self, x=None, var=None, name=None):
        self.var = var
        super().__init__(x=x, name=name if name is not None else "GaussLik")

    def check_hypers(self, parent=""):
        self.var = self._param(self.var, parent + self.name + "_var", FlatExp())

    def default_hypers(self, x=None, y=None):
        if is_param(self.var) and y is not None:
            return {self.var: np.asarray(np.var(y) / 10.0 + 1e-6, settings.floatx)}
        return {}

    def _var(self, params):
        return torch.clamp(hval(self.var, params), min=1e-10)

    def logp_elem(self, params, y, f):
        s2 = self._var(params)
        return -0.5 * (LOG2PI + torch.log(s2)) - (y - f) ** 2 / (2.0 * s2)

    def cond_mean(self, params, f):
        return f

    def cond_var(self, params, f):
        return self._var(params).expand(f.shape)

    def expected_logp(self, params, y, mu, var):
        s2 = self._var(params)
        return -0.5 * (LOG2PI + torch.log(s2)) - ((as_tensor(y) - mu) ** 2 + var) / (2.0 * s2)

    def predictive_moments(self, params, mu, var):
        return mu, var + self._var(params)

    def noise_var(self, params):
        return self._var(params)


class StudentTLik(Likelihood):
    """y = f + eps, eps ~ t_nu(0, scale): robust regression.  ``var`` is
    the squared scale, ``nu`` the degrees of freedom (default 4)."""

    def __init__(self, x=None, var=None, nu=None, name=None):
        self.var = var
        self.nu = nu
        super().__init__(x=x, name=name if name is not None else "StudentTLik")

    def check_hypers(self, parent=""):
        self.var = self._param(self.var, parent + self.name + "_var", FlatExp())
        self.nu = self._param(self.nu, parent + self.name + "_nu", FlatExp())

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.var) and y is not None:
            out[self.var] = np.asarray(np.var(y) / 10.0 + 1e-6, settings.floatx)
        if is_param(self.nu):
            out[self.nu] = np.asarray(4.0, settings.floatx)
        return out

    def _var_nu(self, params):
        return (torch.clamp(hval(self.var, params), min=1e-10),
                torch.clamp(hval(self.nu, params), min=1.0))

    def logp_elem(self, params, y, f):
        s2, nu = self._var_nu(params)
        r2 = (y - f) ** 2 / s2
        return (torch.lgamma((nu + 1.0) / 2.0) - torch.lgamma(nu / 2.0)
                - 0.5 * torch.log(nu * math.pi * s2)
                - (nu + 1.0) / 2.0 * torch.log1p(r2 / nu))

    def cond_mean(self, params, f):
        return f

    def cond_var(self, params, f):
        # the reported variance is clamped at nu_eff = max(nu, 2.05): the
        # Student-t variance is infinite for nu <= 2 (the logp stays exact)
        s2, nu = self._var_nu(params)
        nu_eff = torch.clamp(nu, min=2.05)
        return (s2 * nu_eff / (nu_eff - 2.0)).expand(f.shape)

    def noise_var(self, params):
        return self.cond_var(params, torch.zeros((), dtype=settings.dtype,
                                                 device=settings.device))


class PoissonLik(Likelihood):
    """Counts with a log link, y ~ Poisson(exp(f)): the expected
    log-likelihood and the predictive moments are analytic (lognormal
    moments).  No hypers."""

    def __init__(self, x=None, name=None):
        super().__init__(x=x, name=name if name is not None else "PoisLik")

    def logp_elem(self, params, y, f):
        y = as_tensor(y)
        return y * f - torch.exp(f) - torch.lgamma(y + 1.0)

    def cond_mean(self, params, f):
        return torch.exp(f)

    def cond_var(self, params, f):
        return torch.exp(f)

    def expected_logp(self, params, y, mu, var):
        y, mu = as_tensor(y), as_tensor(mu)
        rate = torch.exp(mu + 0.5 * as_tensor(var))
        return y * mu - rate - torch.lgamma(y + 1.0)

    def predictive_moments(self, params, mu, var):
        mu, var = as_tensor(mu), as_tensor(var)
        m = torch.exp(mu + 0.5 * var)
        v = m + m * m * torch.expm1(var)
        return m, torch.clamp(v, min=0.0)

    def check_targets(self, y):
        ya = np.asarray(y)
        if np.any(ya < 0) or not np.allclose(ya, np.round(ya), atol=1e-6):
            raise ValueError("PoissonLik targets must be non-negative integer counts")

    def latent_guess(self, y):
        """Counts -> log rate, log(y + 0.5)."""
        return np.log(np.asarray(y, settings.floatx) + 0.5)


class NegBinomialLik(PoissonLik):
    """Overdispersed counts with a log link: mean exp(f), concentration
    ``dispersion`` r, Var[y | f] = m + m^2 / r.  The expected
    log-likelihood is the base class's quadrature; the predictive moments
    are analytic."""

    def __init__(self, x=None, dispersion=None, name=None):
        self.dispersion = dispersion
        Likelihood.__init__(self, x=x, name=name if name is not None else "NegBinLik")

    def check_hypers(self, parent=""):
        self.dispersion = self._param(self.dispersion, parent + self.name + "_dispersion",
                                      FlatExp())

    def default_hypers(self, x=None, y=None):
        """Method-of-moments concentration r = m^2 / (s^2 - m), clipped to
        [0.1, 100] (100 where the data show no overdispersion)."""
        if is_param(self.dispersion) and y is not None:
            ya = np.asarray(y, np.float64)
            m, v = float(ya.mean()), float(ya.var())
            r0 = m * m / (v - m) if v > m + 1e-6 and m > 0 else 100.0
            return {self.dispersion: np.asarray(np.clip(r0, 0.1, 100.0), settings.floatx)}
        return {}

    def _r(self, params):
        return torch.clamp(hval(self.dispersion, params), min=1e-3)

    def logp_elem(self, params, y, f):
        r = self._r(params)
        y = as_tensor(y)
        lse = torch.logaddexp(torch.log(r), f)  # log(r + e^f), stable both tails
        return (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
                + r * torch.log(r) + y * f - (y + r) * lse)

    def cond_var(self, params, f):
        m = torch.exp(f)
        return m + m * m / self._r(params)

    expected_logp = Likelihood.expected_logp

    def predictive_moments(self, params, mu, var):
        mu, var = as_tensor(mu), as_tensor(var)
        m = torch.exp(mu + 0.5 * var)
        e2 = torch.exp(2.0 * mu + 2.0 * var)
        v = m + e2 / self._r(params) + (e2 - m * m)
        return m, torch.clamp(v, min=0.0)

    def check_targets(self, y):
        ya = np.asarray(y)
        if np.any(ya < 0) or not np.allclose(ya, np.round(ya), atol=1e-6):
            raise ValueError("NegBinomialLik targets must be non-negative integer counts")


class BernoulliLik(Likelihood):
    """Probit classification, p(y=1 | f) = Phi(f), y in {0, 1}; the
    predictive probability is Phi(mu / sqrt(1 + var)).  No hypers."""

    def __init__(self, x=None, name=None):
        super().__init__(x=x, name=name if name is not None else "BernLik")

    def logp_elem(self, params, y, f):
        sign = 2.0 * as_tensor(y) - 1.0
        return torch.special.log_ndtr(sign * f)

    def check_targets(self, y):
        vals = np.unique(np.asarray(y))
        if not np.all(np.isin(vals, [0.0, 1.0])):
            raise ValueError(
                "BernoulliLik targets must be in {0, 1} (got values "
                f"{vals[:6]}...); map {{-1,+1}} labels with (y+1)/2")

    def cond_mean(self, params, f):
        return ndtr(f)

    def cond_var(self, params, f):
        p = ndtr(f)
        return p * (1.0 - p)

    def predictive_moments(self, params, mu, var):
        p = ndtr(as_tensor(mu) / torch.sqrt(1.0 + as_tensor(var)))
        return p, torch.clamp(p * (1.0 - p), min=0.0)

    def latent_guess(self, y):
        return 2.0 * np.asarray(y, settings.floatx) - 1.0


def _pad_cdf(cdf):
    """[0, cdf, 1] along the last axis."""
    return (torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1),
            torch.cat([cdf, torch.ones_like(cdf[..., :1])], dim=-1))


class OrdinalLik(Likelihood):
    """Cumulative-probit ordinal regression over C ordered levels:
    p(y=k | f) = Phi(b_{k+1} - f) - Phi(b_k - f).  ``cut`` is b_1 and
    ``logdelta`` the C-2 log-spacings; the class probabilities under a
    gaussian q(f) are analytic (:meth:`probs`)."""

    def __init__(self, classes, x=None, cut=None, logdelta=None, name=None):
        self.classes = int(classes)
        if self.classes < 2:
            raise ValueError("OrdinalLik needs classes >= 2")
        self.cut = cut
        self.logdelta = logdelta
        super().__init__(x=x, name=name if name is not None else "OrdLik")

    def check_hypers(self, parent=""):
        self.cut = self._param(self.cut, parent + self.name + "_cut", Flat())
        if self.classes > 2:
            self.logdelta = self._param(self.logdelta, parent + self.name + "_logdelta",
                                        Flat(), shape=(self.classes - 2,))

    def default_hypers(self, x=None, y=None):
        out = {}
        if is_param(self.cut):
            out[self.cut] = np.asarray(-(self.classes - 2) / 2.0, settings.floatx)
        if self.classes > 2 and is_param(self.logdelta):
            out[self.logdelta] = np.zeros((self.classes - 2,), settings.floatx)
        return out

    def _cuts(self, params):
        """The C-1 finite cutpoints b_1, b_1 + e^d_1, ..."""
        b1 = hval(self.cut, params).reshape(1)
        if self.classes == 2:
            return b1
        d = torch.exp(hval(self.logdelta, params))
        return torch.cat([b1, b1 + torch.cumsum(d, dim=0)])

    def _bin_probs(self, params, f):
        """p(y=k | f) for every k, (..., C)."""
        cdf = ndtr(self._cuts(params) - f[..., None])
        lo, hi = _pad_cdf(cdf)
        return torch.clamp(hi - lo, min=1e-30)

    def logp_elem(self, params, y, f):
        f = as_tensor(f)
        p = self._bin_probs(params, f)
        yb = _labels(y, f.device).expand(f.shape)
        return torch.log(torch.take_along_dim(p, yb[..., None], dim=-1)[..., 0])

    def probs(self, params, mu, var):
        """P(y* = k) under N(mu, var): (n, C)."""
        mu = as_tensor(mu)
        sd = torch.sqrt(1.0 + as_tensor(var))
        cdf = ndtr((self._cuts(params)[None, :] - mu[:, None]) / sd[:, None])
        lo, hi = _pad_cdf(cdf)
        return torch.clamp(hi - lo, min=0.0)

    def _levels(self):
        return torch.arange(self.classes, dtype=settings.dtype, device=settings.device)

    def cond_mean(self, params, f):
        return (self._bin_probs(params, as_tensor(f)) * self._levels()).sum(dim=-1)

    def cond_var(self, params, f):
        p = self._bin_probs(params, as_tensor(f))
        k = self._levels()
        m = (p * k).sum(dim=-1)
        return torch.clamp((p * k * k).sum(dim=-1) - m * m, min=0.0)

    def predictive_moments(self, params, mu, var):
        p = self.probs(params, mu, var)
        k = self._levels()
        m = (p * k).sum(dim=-1)
        return m, torch.clamp((p * k * k).sum(dim=-1) - m * m, min=0.0)

    def check_targets(self, y):
        ya = np.asarray(y)
        if not np.allclose(ya, np.round(ya), atol=1e-6):
            raise ValueError("OrdinalLik targets must be integer ordinal levels")
        if np.any(ya < 0) or np.any(ya > self.classes - 1):
            raise ValueError(f"OrdinalLik targets must lie in [0, {self.classes - 1}]")


class HeteroscedasticLik(Likelihood):
    """Input-dependent gaussian noise from a second latent head:
    y = f1 + eps, eps ~ N(0, exp(f2 + b)), ``b`` a trainable log-noise
    offset.  The expected log-likelihood and the moments are analytic
    (lognormal moments); ``mu``/``var`` carry the heads axis (n, 2)."""

    def __init__(self, x=None, bias=None, name=None):
        self.bias = bias
        super().__init__(x=x, name=name if name is not None else "HetLik")

    def check_hypers(self, parent=""):
        self.bias = self._param(self.bias, parent + self.name + "_bias", Flat())

    def default_hypers(self, x=None, y=None):
        if is_param(self.bias) and y is not None:
            return {self.bias: np.asarray(np.log(np.var(y) / 10.0 + 1e-6), settings.floatx)}
        return {}

    def _b(self, params):
        return hval(self.bias, params)

    def _split(self, mu, var, params):
        mu, var = as_tensor(mu), as_tensor(var)
        return mu[..., 0], mu[..., 1] + self._b(params), var[..., 0], var[..., 1]

    def logp_elem(self, params, y, f):
        lv = f[..., 1] + self._b(params)
        return -0.5 * (LOG2PI + lv) - 0.5 * (y - f[..., 0]) ** 2 * torch.exp(-lv)

    def expected_logp(self, params, y, mu, var):
        m1, m2, v1, v2 = self._split(mu, var, params)
        prec = torch.exp(torch.clamp(-m2 + 0.5 * v2, -30.0, 30.0))
        return -0.5 * (LOG2PI + m2) - 0.5 * ((as_tensor(y) - m1) ** 2 + v1) * prec

    def cond_mean(self, params, f):
        return f[..., 0]

    def cond_var(self, params, f):
        return torch.exp(f[..., 1] + self._b(params))

    def predictive_moments(self, params, mu, var):
        m1, m2, v1, v2 = self._split(mu, var, params)
        ev = torch.exp(torch.clamp(m2 + 0.5 * v2, -30.0, 30.0))
        return m1, torch.clamp(v1 + ev, min=0.0)

    def noise_mean(self, params, mu, var):
        """E[exp(f2 + b)] per row: the predictive noise-variance field."""
        _, m2, _, v2 = self._split(mu, var, params)
        return torch.exp(torch.clamp(m2 + 0.5 * v2, -30.0, 30.0))


class CategoricalLik(Likelihood):
    """Softmax classification over C classes, f in R^C per input: the
    moment arguments carry a trailing class axis (n, C).  The ELBO data
    term is the analytic Jensen bound mu_y - logsumexp(mu + var / 2); the
    predictive probabilities are a fixed common-random-number Monte Carlo
    over ``mc`` gaussian draws (numpy seed 20260817, as in the JAX
    package).  No hypers."""

    mc = 128

    def __init__(self, classes, x=None, name=None):
        self.classes = int(classes)
        if self.classes < 2:
            raise ValueError("CategoricalLik needs classes >= 2")
        super().__init__(x=x, name=name if name is not None else "CatLik")

    def _eps(self):
        """The fixed (mc, 1, C) standard normals of the estimator."""
        rng = np.random.default_rng(20260817)
        return as_tensor(rng.standard_normal((self.mc, 1, self.classes)))

    @staticmethod
    def _take_y(arr, y):
        return torch.take_along_dim(arr, _labels(y, arr.device)[..., None], dim=-1)[..., 0]

    def logp_elem(self, params, y, f):
        """log softmax(f)_y; ``f`` has a trailing class axis."""
        return self._take_y(f, y) - torch.logsumexp(f, dim=-1)

    def expected_logp(self, params, y, mu, var):
        """The per-row Jensen lower bound on E_q[log p(y | f)]."""
        mu, var = as_tensor(mu), as_tensor(var)
        return self._take_y(mu, y) - torch.logsumexp(mu + 0.5 * var, dim=-1)

    def _draws(self, mu, var):
        sd = torch.sqrt(torch.clamp(as_tensor(var), min=0.0))
        return as_tensor(mu)[None, :, :] + sd[None, :, :] * self._eps()

    def probs(self, params, mu, var):
        """E[softmax(f)] under the mean-field q, (n, C)."""
        return torch.softmax(self._draws(mu, var), dim=-1).mean(dim=0)

    def log_predictive(self, params, y, mu, var):
        """Per-row log E_q[softmax(f)_y]."""
        lp = self.logp_elem(params, _labels(y, settings.device)[None, :], self._draws(mu, var))
        return torch.logsumexp(lp, dim=0) - math.log(self.mc)

    def cond_mean(self, params, f):
        return torch.softmax(f, dim=-1)

    def cond_var(self, params, f):
        p = torch.softmax(f, dim=-1)
        return p * (1.0 - p)

    def predictive_moments(self, params, mu, var):
        p = self.probs(params, mu, var)
        return p, torch.clamp(p * (1.0 - p), min=0.0)

    def check_targets(self, y):
        ya = np.asarray(y)
        if not np.allclose(ya, np.round(ya), atol=1e-6):
            raise ValueError("CategoricalLik targets must be integer class labels")
        if np.any(ya < 0) or np.any(ya > self.classes - 1):
            raise ValueError(
                f"CategoricalLik targets must lie in [0, {self.classes - 1}]"
                f" (got range [{ya.min()}, {ya.max()}]); pass classes="
                f"{int(ya.max()) + 1} if you have more classes")


def sample_conditional(lik, params, f, rng):
    """Draw y | f through a likelihood, elementwise over a host array of
    latent draws ``f`` with the numpy Generator ``rng`` (the JAX package's
    draws, in its order).  Raises for a likelihood with no conditional
    sampler."""
    from scipy import stats

    f = np.asarray(f)
    if isinstance(lik, BernoulliLik):
        p = stats.norm.cdf(f)
        return (rng.uniform(size=f.shape) < p).astype(settings.floatx)
    if isinstance(lik, NegBinomialLik):
        r = float(np.maximum(_host(lik.dispersion, params), 1e-3))
        m = np.exp(np.clip(f, -30.0, 30.0))
        return rng.negative_binomial(r, r / (r + m)).astype(settings.floatx)
    if isinstance(lik, PoissonLik):
        return rng.poisson(np.exp(np.clip(f, -30, 30))).astype(settings.floatx)
    if isinstance(lik, OrdinalLik):
        pj = {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in params.items()}
        b = lik._cuts(pj).cpu().numpy()
        g = f + rng.standard_normal(f.shape).astype(settings.floatx)
        return np.sum(g[..., None] > b, axis=-1).astype(settings.floatx)
    if isinstance(lik, StudentTLik):
        s2 = float(np.maximum(_host(lik.var, params), 1e-10))
        nu = float(np.maximum(_host(lik.nu, params), 1.0))
        return f + np.sqrt(s2) * stats.t.rvs(nu, size=f.shape,
                                             random_state=rng).astype(settings.floatx)
    if not isinstance(lik, GaussianLik):
        raise ValueError(
            f"no conditional sampler for {type(lik).__name__}; draw latent paths with "
            "noise=False and push through the likelihood")
    s2 = float(np.maximum(_host(lik.var, params), 1e-10))
    return f + np.sqrt(s2) * rng.standard_normal(f.shape).astype(settings.floatx)
