"""Kernel density estimates and Gaussian mixtures on the host, in numpy.

The JAX package fits these with scikit-learn (``KernelDensity``,
``GaussianMixture``, ``BayesianGaussianMixture``) inside its datatrace
toolkit (:mod:`g3py_tpu.bayesian.average`).  The port keeps no scikit-learn
dependency, so it carries its own copy of the algorithms it uses, step for
step as scikit-learn takes them, so that the same data and the same numpy
``RandomState`` give the same densities, draws, clusters and labels:

* :class:`KernelDensity` — ``score_samples`` for the six kernels (the exact
  sum that scikit-learn's tree reaches with ``atol=rtol=0``) and ``sample``
  for the gaussian and tophat kernels (scikit-learn samples no other);
* :func:`kmeans` — k-means++ seeding (greedy local trials) and Lloyd's
  iterations on the centred data, as scikit-learn's ``KMeans`` (the
  inducing inputs' and the mixtures' initialisation);
* :class:`GaussianMixture` (full covariances, EM) and
  :class:`BayesianGaussianMixture` (full covariances, variational EM with
  Dirichlet-process weights and scikit-learn's default priors), both
  initialised from the k-means labels, ``n_init`` restarts, ``tol`` on the
  lower bound's change.

A ``random_state`` of None is numpy's global ``RandomState``, as
scikit-learn's ``check_random_state(None)``.  Everything runs in float64.
"""

import math

import numpy as np
from scipy.special import betaln, digamma, gammainc, gammaln, logsumexp

__all__ = ["KernelDensity", "GaussianMixture", "BayesianGaussianMixture", "kmeans"]

_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2.0 * math.pi)
_KERNELS = ("gaussian", "tophat", "epanechnikov", "exponential", "linear", "cosine")


def check_random_state(seed):
    """numpy's global ``RandomState`` for None, a new one for an int, the
    instance itself otherwise."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    return seed


# ---------------------------------------------------------------------------
# kernel density
# ---------------------------------------------------------------------------


def _log_vn(n):
    return 0.5 * n * _LOG_PI - math.lgamma(0.5 * n + 1)


def _log_sn(n):
    return _LOG_2PI + _log_vn(n - 1)


def _log_kernel_norm(h, d, kernel):
    """log of the kernel's normalization (K(0) = 1 unnormalized)."""
    if kernel == "gaussian":
        factor = 0.5 * d * _LOG_2PI
    elif kernel == "tophat":
        factor = _log_vn(d)
    elif kernel == "epanechnikov":
        factor = _log_vn(d) + math.log(2.0 / (d + 2.0))
    elif kernel == "exponential":
        factor = _log_sn(d - 1) + math.lgamma(d)
    elif kernel == "linear":
        factor = _log_vn(d) - math.log(d + 1.0)
    else:  # cosine
        factor, tmp = 0.0, 2.0 / math.pi
        for k in range(1, d + 1, 2):
            factor += tmp
            tmp *= -(d - k) * (d - k - 1) * (2.0 / math.pi) ** 2
        with np.errstate(invalid="ignore"):  # NaN where the series goes negative, as there
            factor = float(np.log(factor)) + _log_sn(d - 1)
    return -factor - d * math.log(h)


def _log_kernel(dist, h, kernel):
    """The unnormalized log kernel of distances ``dist`` (-inf outside a
    compact kernel's support)."""
    if kernel == "gaussian":
        return -0.5 * (dist * dist) / (h * h)
    if kernel == "exponential":
        return -dist / h
    inside = dist < h
    with np.errstate(divide="ignore"):
        if kernel == "tophat":
            val = np.zeros_like(dist)
        elif kernel == "epanechnikov":
            val = np.log(np.where(inside, 1.0 - (dist * dist) / (h * h), 1.0))
        elif kernel == "linear":
            val = np.log(np.where(inside, 1.0 - dist / h, 1.0))
        else:  # cosine
            val = np.log(np.where(inside, np.cos(0.5 * math.pi * dist / h), 1.0))
    return np.where(inside, val, -np.inf)


class KernelDensity:
    """Kernel density estimate over the rows of a matrix (scikit-learn's
    ``KernelDensity`` with the euclidean metric, a float bandwidth and no
    sample weights)."""

    def __init__(self, kernel="gaussian", bandwidth=1.0):
        if kernel not in _KERNELS:
            raise ValueError(f"kernel {kernel!r} not in {_KERNELS}")
        self.kernel = kernel
        self.bandwidth = float(bandwidth)
        self.bandwidth_ = self.bandwidth

    def fit(self, X):
        self.data_ = np.array(X, dtype=np.float64, order="C", ndmin=2)
        return self

    def score_samples(self, X, chunk=256):
        """log density at each row of ``X``: the log-sum-exp of the kernel
        over every fitted row, normalized, minus log N.  A row with no fitted
        row inside a compact kernel's support has density 0 (log -inf);
        scikit-learn's tree reports a floor near 1e-15 there instead."""
        X = np.array(X, dtype=np.float64, ndmin=2)
        n, d = self.data_.shape
        log_norm = _log_kernel_norm(self.bandwidth_, d, self.kernel)
        out = np.empty(len(X))
        for lo in range(0, len(X), chunk):
            q = X[lo:lo + chunk]
            sq = np.zeros((len(q), n))
            for k in range(d):
                sq += (q[:, k, None] - self.data_[None, :, k]) ** 2
            lk = _log_kernel(np.sqrt(sq), self.bandwidth_, self.kernel)
            out[lo:lo + chunk] = logsumexp(lk, axis=1)
        return out + log_norm - np.log(n)

    def sample(self, n_samples=1, random_state=None):
        """``n_samples`` draws (gaussian and tophat kernels only), from the
        fitted rows picked by uniform draws of ``random_state``."""
        if self.kernel not in ("gaussian", "tophat"):
            raise NotImplementedError()
        data = self.data_
        rng = check_random_state(random_state)
        u = rng.uniform(0, 1, size=n_samples)
        i = (u * data.shape[0]).astype(np.int64)
        if self.kernel == "gaussian":
            return np.atleast_2d(rng.normal(data[i], self.bandwidth_))
        dim = data.shape[1]
        X = rng.normal(size=(n_samples, dim))
        s_sq = np.einsum("ij,ij->i", X, X)
        correction = (gammainc(0.5 * dim, 0.5 * s_sq) ** (1.0 / dim)
                      * self.bandwidth_ / np.sqrt(s_sq))
        return data[i] + X * correction[:, np.newaxis]


# ---------------------------------------------------------------------------
# k-means (the mixtures' initialisation)
# ---------------------------------------------------------------------------


def _sq_dists(a, b, b_sq):
    """|a_i - b_j|^2 by the norm expansion, floored at 0."""
    a_sq = np.einsum("ij,ij->i", a, a)[:, None]
    return np.maximum(-2.0 * (a @ b.T) + a_sq + b_sq[None, :], 0.0)


def _kmeans_plusplus(X, k, x_sq, rng):
    n = X.shape[0]
    trials = 2 + int(np.log(k))
    weight = np.ones(n)
    centers = np.empty((k, X.shape[1]))
    first = rng.choice(n, p=weight / weight.sum())
    centers[0] = X[first]
    closest = _sq_dists(centers[0, None], X, x_sq)[0]
    pot = closest @ weight
    for c in range(1, k):
        rand = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = np.minimum(closest, _sq_dists(X[cand], X, x_sq))
        pots = dist @ weight
        best = np.argmin(pots)
        pot, closest = pots[best], dist[best]
        centers[c] = X[cand[best]]
    return centers


def _lloyd_step(X, centers, update=True):
    """Labels of the nearest centers, and the new centers (sums over the
    labels, empty clusters given the farthest points, averaged) with each
    center's shift."""
    c_sq = np.einsum("ij,ij->i", centers, centers)
    labels = np.argmin(c_sq[None, :] - 2.0 * (X @ centers.T), axis=1)
    if not update:
        return labels, centers, None
    k = centers.shape[0]
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.zeros_like(centers)
    np.add.at(sums, labels, X)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        if dist.max() > 0:
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= X[idx]
                sums[new] = X[idx]
                weight[new] = 1.0
                weight[old] -= 1.0
    new_centers = np.where(weight[:, None] > 0,
                           sums * (1.0 / np.maximum(weight, 1e-300))[:, None], centers)
    shift = np.sqrt(((new_centers - centers) ** 2).sum(axis=1))
    return labels, new_centers, shift


def _kmeans_single(X, centers, max_iter, tol):
    """Lloyd's iterations from ``centers`` until the labels stop changing or
    the centers' total squared shift is within ``tol``: the labels, the
    centers and the inertia."""
    labels_old = np.full(X.shape[0], -1)
    strict = False
    for _ in range(max_iter):
        labels, centers, shift = _lloyd_step(X, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _lloyd_step(X, centers, update=False)[0]
    return labels, centers, float(((X - centers[labels]) ** 2).sum())


def _same_clustering(a, b, k):
    """Whether two labellings are one partition up to a relabelling."""
    mapping = np.full(k, -1)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans(X, n_clusters, n_init=1, random_state=None, max_iter=300, tol=1e-4):
    """scikit-learn's ``KMeans(n_clusters, n_init=n_init).fit(X)`` (the
    lloyd algorithm): the data centred, ``n_init`` k-means++ seedings drawn
    in turn from one ``RandomState``, each run until the labels stop
    changing or the centers' total squared shift is within ``tol`` times
    the mean feature variance; the run of least inertia is kept unless it
    is the kept partition relabelled.  Returns the centers and labels."""
    X = np.array(X, dtype=np.float64)
    rng = check_random_state(random_state)
    tol = float(np.mean(np.var(X, axis=0)) * tol)
    mean = X.mean(axis=0)
    X = X - mean
    x_sq = np.einsum("ij,ij->i", X, X)
    best = None
    for _ in range(n_init):
        init = _kmeans_plusplus(X, n_clusters, x_sq, rng)
        labels, centers, inertia = _kmeans_single(X, init, max_iter, tol)
        if best is None or (inertia < best[2]
                            and not _same_clustering(labels, best[0], n_clusters)):
            best = (labels, centers, inertia)
    return best[1] + mean, best[0]


# ---------------------------------------------------------------------------
# gaussian mixtures (full covariances)
# ---------------------------------------------------------------------------


def _gaussian_parameters(X, resp, reg_covar):
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    covs = np.empty((len(nk), X.shape[1], X.shape[1]))
    for k in range(len(nk)):
        diff = X - means[k]
        covs[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        covs[k].flat[::X.shape[1] + 1] += reg_covar
    return nk, means, covs


def _precision_cholesky(covs):
    d = covs.shape[-1]
    out = np.empty_like(covs)
    for k, cov in enumerate(covs):
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            raise ValueError("Fitting the mixture model failed because some components "
                             "have ill-defined empirical covariance") from None
        out[k] = np.linalg.solve(chol, np.eye(d)).T  # solve_triangular(chol, I).T
    return out


def _log_det_cholesky(prec_chol):
    n, d, _ = prec_chol.shape
    return np.sum(np.log(prec_chol.reshape(n, -1)[:, ::d + 1]), axis=1)


def _log_gaussian_prob(X, means, prec_chol):
    n, d = X.shape
    log_prob = np.empty((n, len(means)))
    for k, (mu, pc) in enumerate(zip(means, prec_chol)):
        y = X @ pc - mu @ pc
        log_prob[:, k] = np.sum(np.square(y), axis=1)
    return -0.5 * (d * _LOG_2PI + log_prob) + _log_det_cholesky(prec_chol)


class _Mixture:
    """EM over full-covariance gaussian components (scikit-learn's
    ``BaseMixture.fit_predict``, kmeans initialisation)."""

    def __init__(self, n_components=1, tol=1e-3, reg_covar=1e-6, max_iter=100, n_init=1,
                 random_state=None):
        self.n_components = int(n_components)
        self.tol, self.reg_covar = tol, reg_covar
        self.max_iter, self.n_init = int(max_iter), int(n_init)
        self.random_state = random_state

    def _e_step(self, X):
        weighted = self._estimate_log_prob(X) + self._estimate_log_weights()
        norm = logsumexp(weighted, axis=1)
        return np.mean(norm), weighted - norm[:, None]

    def fit(self, X):
        X = np.array(X, dtype=np.float64, ndmin=2)
        if X.shape[0] < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got n_components = "
                             f"{self.n_components}, n_samples = {X.shape[0]}")
        self._check_parameters(X)
        rng = check_random_state(self.random_state)
        best_bound, best = -np.inf, None
        self.converged_ = False
        for _ in range(self.n_init):
            resp = np.zeros((X.shape[0], self.n_components))
            resp[np.arange(X.shape[0]), kmeans(X, self.n_components, 1, rng)[1]] = 1
            self._initialize(X, resp)
            bound, converged, n_iter = -np.inf, False, 0
            for n_iter in range(1, self.max_iter + 1):
                prev = bound
                log_prob_norm, log_resp = self._e_step(X)
                self._m_step(X, log_resp)
                bound = self._compute_lower_bound(log_resp, log_prob_norm)
                if abs(bound - prev) < self.tol:
                    converged = True
                    break
            if bound > best_bound or best_bound == -np.inf:
                best_bound, best = bound, self._get_parameters()
                self.n_iter_, self.converged_ = n_iter, converged
        self._set_parameters(best)
        self.lower_bound_ = best_bound
        return self

    def predict(self, X):
        X = np.array(X, dtype=np.float64, ndmin=2)
        return np.argmax(self._estimate_log_prob(X) + self._estimate_log_weights(), axis=1)


class GaussianMixture(_Mixture):
    """Maximum-likelihood mixture of full-covariance gaussians."""

    def _check_parameters(self, X):
        pass

    def _initialize(self, X, resp):
        weights, self.means_, self.covariances_ = _gaussian_parameters(X, resp, self.reg_covar)
        self.weights_ = weights / X.shape[0]
        self.precisions_cholesky_ = _precision_cholesky(self.covariances_)

    def _m_step(self, X, log_resp):
        self.weights_, self.means_, self.covariances_ = _gaussian_parameters(
            X, np.exp(log_resp), self.reg_covar)
        self.weights_ = self.weights_ / self.weights_.sum()
        self.precisions_cholesky_ = _precision_cholesky(self.covariances_)

    def _estimate_log_prob(self, X):
        return _log_gaussian_prob(X, self.means_, self.precisions_cholesky_)

    def _estimate_log_weights(self):
        return np.log(self.weights_)

    def _compute_lower_bound(self, _, log_prob_norm):
        return log_prob_norm

    def _get_parameters(self):
        return self.weights_, self.means_, self.covariances_, self.precisions_cholesky_

    def _set_parameters(self, params):
        self.weights_, self.means_, self.covariances_, self.precisions_cholesky_ = params
        self.precisions_ = np.einsum("kij,klj->kil", self.precisions_cholesky_,
                                     self.precisions_cholesky_)


class BayesianGaussianMixture(_Mixture):
    """Variational mixture of full-covariance gaussians with
    Dirichlet-process (stick-breaking) weights and scikit-learn's default
    priors: weight concentration 1 / n_components, mean precision 1, mean
    prior the data mean, n_features degrees of freedom, covariance prior
    the data covariance."""

    def _check_parameters(self, X):
        self.weight_concentration_prior_ = 1.0 / self.n_components
        self.mean_precision_prior_ = 1.0
        self.mean_prior_ = X.mean(axis=0)
        self.degrees_of_freedom_prior_ = X.shape[1]
        self.covariance_prior_ = np.atleast_2d(np.cov(X.T))

    def _estimate(self, X, resp):
        nk, xk, sk = _gaussian_parameters(X, resp, self.reg_covar)
        self.weight_concentration_ = (
            1.0 + nk,
            self.weight_concentration_prior_ + np.hstack((np.cumsum(nk[::-1])[-2::-1], 0)))
        self.mean_precision_ = self.mean_precision_prior_ + nk
        self.means_ = ((self.mean_precision_prior_ * self.mean_prior_ + nk[:, None] * xk)
                       / self.mean_precision_[:, None])
        self.degrees_of_freedom_ = self.degrees_of_freedom_prior_ + nk
        d = xk.shape[1]
        covs = np.empty((self.n_components, d, d))
        for k in range(self.n_components):
            diff = xk[k] - self.mean_prior_
            covs[k] = (self.covariance_prior_ + nk[k] * sk[k]
                       + nk[k] * self.mean_precision_prior_ / self.mean_precision_[k]
                       * np.outer(diff, diff))
        self.covariances_ = covs / self.degrees_of_freedom_[:, None, None]
        self.precisions_cholesky_ = _precision_cholesky(self.covariances_)

    def _initialize(self, X, resp):
        self._estimate(X, resp)

    def _m_step(self, X, log_resp):
        self._estimate(X, np.exp(log_resp))

    def _estimate_log_weights(self):
        a, b = self.weight_concentration_
        dsum = digamma(a + b)
        return digamma(a) - dsum + np.hstack((0, np.cumsum(digamma(b) - dsum)[:-1]))

    def _estimate_log_prob(self, X):
        d = X.shape[1]
        log_gauss = (_log_gaussian_prob(X, self.means_, self.precisions_cholesky_)
                     - 0.5 * d * np.log(self.degrees_of_freedom_))
        log_lambda = d * np.log(2.0) + np.sum(
            digamma(0.5 * (self.degrees_of_freedom_ - np.arange(0, d)[:, None])), 0)
        return log_gauss + 0.5 * (log_lambda - d / self.mean_precision_)

    def _compute_lower_bound(self, log_resp, log_prob_norm):
        d = self.mean_prior_.shape[0]
        log_det = (_log_det_cholesky(self.precisions_cholesky_)
                   - 0.5 * d * np.log(self.degrees_of_freedom_))
        dof = self.degrees_of_freedom_
        log_wishart = np.sum(-(dof * log_det + dof * d * 0.5 * math.log(2.0)
                               + np.sum(gammaln(0.5 * (dof - np.arange(d)[:, None])), 0)))
        log_norm_weight = -np.sum(betaln(*self.weight_concentration_))
        return (-np.sum(np.exp(log_resp) * log_resp) - log_wishart - log_norm_weight
                - 0.5 * d * np.sum(np.log(self.mean_precision_)))

    def _get_parameters(self):
        return (self.weight_concentration_, self.mean_precision_, self.means_,
                self.degrees_of_freedom_, self.covariances_, self.precisions_cholesky_)

    def _set_parameters(self, params):
        (self.weight_concentration_, self.mean_precision_, self.means_,
         self.degrees_of_freedom_, self.covariances_, self.precisions_cholesky_) = params
        a, b = self.weight_concentration_
        weights = a / (a + b) * np.hstack((1, np.cumprod((b / (a + b))[:-1])))
        self.weights_ = weights / np.sum(weights)
        self.precisions_ = np.einsum("kij,klj->kil", self.precisions_cholesky_,
                                     self.precisions_cholesky_)
