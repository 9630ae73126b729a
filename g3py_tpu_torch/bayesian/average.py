"""Datatrace construction and convergence diagnostics (the PyTorch
counterpart of :mod:`g3py_tpu.bayesian.average`, subset).

* :func:`chains_to_datatrace` / :func:`datatrace_to_chains` — chains
  (nchain, niter, ndim) <-> a flat :class:`~g3py_tpu_torch.utils.datatrace.
  Datatrace` with the JAX package's columns: burn-in flag from a
  Gelman-Rubin bisection, outlier flag from ll/param quantiles (numpy's
  linear rule, which is pandas'), transformed param columns.
* :func:`gelman_rubin` (multi-sum, multi-max, uni), :func:`burn_in_samples`,
  :func:`effective_sample_min`, :func:`effective_sample_size` and the mESS
  estimators (mIS, adjusted mIS, batch means).

All host numpy.  The JAX package runs the autocovariance, batch-means and
univariate R-hat cores in C++ (``g3py_tpu/native.py``) with numpy
fallbacks; the port keeps its own copy of the numpy forms.  KDE,
clustering, candidate search and the plots are not ported yet (ROADMAP
Queue 1 item 8).
"""

import numpy as np

from ..utils.datatrace import Datatrace

__all__ = [
    "chains_to_datatrace",
    "datatrace_to_chains",
    "gelman_rubin",
    "burn_in_samples",
    "effective_sample_min",
    "effective_sample_size",
]


def chains_to_datatrace(process, chains, ll=None, transforms=True, burnin_tol=0.01,
                        burnin_method="multi-sum", burnin_dims=None,
                        burnin_default=0.1, outlayer_percentile=0.001,
                        clusters=None):
    """chains (nchain, niter, ndim) -> a Datatrace with per-var columns,
    ``_nchain/_niter/_ll``, the burn-in flag (``_niter > nburn``, nburn from
    the Gelman-Rubin bisection), the outlier flag (inside the
    ``outlayer_percentile`` quantiles of every param and of ``_ll``, and
    finite) and the transformed param columns."""
    if clusters is not None and clusters > 0:
        raise NotImplementedError("datatrace clustering is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    columns = process.active.param_names()
    n_vars = len(columns)
    chains = np.asarray(chains)
    if chains.ndim == 2:
        chains = chains[None, :, :]
    if ll is not None and np.ndim(ll) == 1:
        ll = np.asarray(ll)[None, :]
    nchain, niter, _ = chains.shape
    nburn = None
    if burnin_tol is not None:
        dims = process.active.sampling_dims if burnin_dims is None else burnin_dims
        nburn = burn_in_samples(chains[:, :, dims], tol=burnin_tol, method=burnin_method)
    flat = chains.reshape(nchain * niter, -1)
    dt = Datatrace({c: flat[:, i] for i, c in enumerate(columns)})
    dt["_nchain"] = np.repeat(np.arange(nchain), niter)
    dt["_niter"] = np.tile(np.arange(niter), nchain)
    if burnin_tol is not None:
        dt["_burnin"] = dt["_niter"] > nburn
    if ll is not None:
        dt["_ll"] = np.asarray(ll).reshape(-1)

    if outlayer_percentile is not None and len(dt):
        base = dt[np.isfinite(dt["_ll"])] if ll is not None else dt
        if len(base):
            q = outlayer_percentile
            qcols = columns + (["_ll"] if ll is not None else [])
            # pandas' DataFrame.quantile: linear, NaN skipped
            vals = base[qcols].astype(np.float64)
            lower = np.nanquantile(vals, q, axis=0)
            upper = np.nanquantile(vals, 1 - q, axis=0)
            par = dt[columns]
            bad = ((par > upper[:n_vars]) | (par < lower[:n_vars])).any(axis=1)
            if ll is not None:
                bad |= (dt["_ll"] > upper[-1]) | (dt["_ll"] < lower[-1])
            ok = ~bad
            if ll is not None:
                ok &= np.isfinite(dt["_ll"])
            ok &= np.isfinite(par).all(axis=1)
            dt["_outlayer"] = ok

    if transforms:
        ncolumn = n_vars
        for p in process.active.ordered_params:
            tname = p.prior.transform.name
            if tname == "id":
                continue
            cols = [p.name] if p.size == 1 else [f"{p.name}__{i}" for i in range(p.size)]
            for c in cols:
                dt.insert(ncolumn, c.replace(p.name, f"{p.name}_{tname}_"),
                          p.prior.transform.forward(dt[c]))
                ncolumn += 1
    return dt


def datatrace_to_chains(process, dt, flat=False, burnin=False):
    """Inverse of :func:`chains_to_datatrace`: (nchain, niter, ndim), or the
    (rows, ndim) matrix with ``flat``; ``burnin`` keeps the rows past the
    burn-in (all of them when burn-in never converged)."""
    chain = dt[dt["_burnin"]] if burnin and "_burnin" in dt and dt["_burnin"].any() else dt
    values = chain[process.active.param_names()]
    if flat:
        return values
    nchain = len(np.unique(chain["_nchain"]))
    return values.reshape(nchain, len(chain) // nchain, process.active.ndim)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def _gelman_rubin_uni(chains):
    """max |R-hat - 1| over dims, and the per-dim R-hat."""
    _, n, d = chains.shape
    rhat = np.empty(d, dtype=np.float64)
    for j in range(d):
        x = chains[:, :, j]
        between = n * np.var(np.mean(x, axis=1), axis=0, ddof=1)
        within = np.mean(np.var(x, axis=1, ddof=1), axis=0)
        vhat = within * (n - 1) / n + between / n
        rhat[j] = np.sqrt(vhat / within) if within > 0 else 1.0
    return float(np.max(np.abs(rhat - 1))), rhat


def gelman_rubin(chains, method="multi-sum"):
    """|R-hat - 1| convergence score over (nwalkers, nsamples, ndim) chains."""
    chains = np.asarray(chains, dtype=np.float64)
    nwalkers, nsamples, _ = chains.shape
    if nwalkers == 1:
        return 0.0
    if method in ("multi-sum", "multi-max"):
        between = nsamples * np.cov(np.mean(chains, axis=1).T)
        within = np.zeros_like(np.atleast_2d(between))
        for chain in range(nwalkers):
            within += np.atleast_2d(np.cov(chains[chain, :, :].T))
        within /= nwalkers
        between = np.atleast_2d(between)
        vhat = within * (nsamples - 1) / nsamples + between / nsamples
        eig = np.linalg.eigvals((1 / nsamples) * np.linalg.solve(within, vhat)).real
        top = np.sum(eig) if method == "multi-sum" else np.max(eig)
        return float(np.abs((nsamples - 1) / nsamples + ((nwalkers + 1) / nwalkers) * top - 1))
    return _gelman_rubin_uni(chains)[0]


def burn_in_samples(chains, tol=0.1, method="multi-sum"):
    """Bisection for the smallest prefix window with |R-hat - 1| below tol;
    that count of leading samples is discarded as burn-in (the JAX
    package's rule: ``upper`` is always a window proven below tol)."""
    try:
        score = gelman_rubin(chains, method)
    except (np.linalg.LinAlgError, ValueError, FloatingPointError):
        method = "uni"
        try:
            score = gelman_rubin(chains, method)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            score = np.inf
    if score > tol:
        return chains.shape[1]
    lower = 0
    upper = chains.shape[1]
    while lower + 1 < upper:
        n = lower + (upper - lower) // 2
        if gelman_rubin(chains[:, :n, :], method) < tol:
            upper = n
        else:
            lower = n
    return upper


def effective_sample_min(process, alpha=0.05, error=0.05, p=None):
    """Target minimum mESS (arXiv:1512.07713)."""
    import scipy.special
    import scipy.stats

    if p is None:
        p = process.active.ndim
    return (np.pi * (2 ** (2 / p)) * scipy.stats.chi2.ppf(1 - alpha, p)
            / (((p * scipy.special.gamma(p / 2)) ** (2 / p)) * (error ** 2)))


def effective_sample_size(process, dt, method="mIS", batch_size=None, fixed=True,
                          flat=False, reshape=False, burnin=True):
    """Multivariate effective sample size over datatrace chains."""
    chains = datatrace_to_chains(process, dt, flat=flat, burnin=burnin)
    if fixed:
        dims = process.active.sampling_dims
        chains = chains[:, dims] if flat else chains[:, :, dims]
    dim_sample = 1
    if flat:
        chains = chains[None, :, :]
    elif reshape:
        nwalkers, nsamples, ndim = chains.shape
        chains = np.transpose(chains, axes=[1, 0, 2]).reshape(1, nsamples, nwalkers * ndim)
        dim_sample = nwalkers
    mess = [_mESS(c, method, batch_size) for c in chains]
    return np.floor(dim_sample * np.sum(mess))


def _mESS(chain, method="mIS", batch_size=None):
    """mESS = n (det(cov)/det(Sigma))^(1/d)."""
    nsamples, ndim = chain.shape
    det_cov = np.abs(np.linalg.det(np.atleast_2d(np.cov(chain.T))))
    if det_cov == 0:
        return 1
    if method == "batch" or batch_size is not None:
        sigma_cov = _sigma_batch(chain, batch_size or 1)
    elif method == "adjusted":
        sigma_cov = _sigma_mIS_adj(chain)
    else:
        sigma_cov = _sigma_mIS(chain)
    det_sigma = np.abs(np.linalg.det(np.atleast_2d(sigma_cov)))
    if det_sigma == 0:
        return 1
    return nsamples * (det_cov / det_sigma) ** (1 / ndim)


def _is_positive_definite(m):
    try:
        np.linalg.cholesky(m)
        return True
    except np.linalg.LinAlgError:
        return False


def _autocov_matrix(chain, lag):
    """Lagged autocovariance (1/n) sum_t x_t x_{t+lag}^T of the centred
    chain."""
    x = np.asarray(chain, dtype=np.float64)
    x = x - x.mean(axis=0)
    return (1.0 / len(x)) * (x[: len(x) - lag].T @ x[lag:])


def _autocov_matrix_2(chain, i):
    return _autocov_matrix(chain, 2 * i) + _autocov_matrix(chain, 2 * i + 1)


def _sigma_batch(chain, batch_size):
    """Batch-means Markov-CLT covariance (centred on the grand mean over all
    entries, as the reference did; zero below two batches)."""
    chain = np.asarray(chain, dtype=np.float64)
    n, d = chain.shape
    batch_size = max(int(batch_size), 1)
    a = n // batch_size
    if a < 2:
        return np.zeros((d, d))
    block = chain[: a * batch_size].reshape(a, batch_size, d).mean(axis=1) - chain.mean()
    return (batch_size / (a - 1)) * (block.T @ block)


def _sigma_mIS(chain):
    """mIS estimator (Dai & Jones)."""
    k = int(np.floor(chain.shape[0] / 2 - 1))
    sn = 0
    sigma_cov = _autocov_matrix(chain, lag=0) + 2 * _autocov_matrix(chain, lag=1)
    while sn < k and not _is_positive_definite(sigma_cov):
        sigma_cov += 2 * _autocov_matrix_2(chain, sn + 1)
        sn += 1
    sn -= 1
    m = sn + 1
    sigma_cov_init = sigma_cov
    sigma_cov = sigma_cov + 2 * _autocov_matrix_2(chain, sn + 1)
    while np.linalg.det(sigma_cov_init) < np.linalg.det(sigma_cov) and m < k:
        sigma_cov_init = sigma_cov
        sigma_cov = sigma_cov + 2 * _autocov_matrix_2(chain, m + 1)
        m += 1
    return sigma_cov


def _sigma_mIS_adj(chain):
    """Adjusted mIS estimator: the increments' negative eigenvalues are
    clipped in the returned sum."""
    k = int(np.floor(chain.shape[0] / 2 - 1))
    sn = 0
    sigma_cov = _autocov_matrix(chain, lag=0) + 2 * _autocov_matrix(chain, lag=1)
    while sn < k and not _is_positive_definite(sigma_cov):
        sigma_cov += 2 * _autocov_matrix_2(chain, sn + 1)
        sn += 1
    sn -= 1
    m = sn + 1
    sigma_cov_adj = sigma_cov
    sigma_cov_init = sigma_cov
    sigma_cov = sigma_cov + 2 * _autocov_matrix_2(chain, sn + 1)
    while np.linalg.det(sigma_cov_init) < np.linalg.det(sigma_cov) and m < k:
        sigma_cov_init = sigma_cov
        update = 2 * _autocov_matrix_2(chain, m + 1)
        if not _is_positive_definite(update):
            val, vec = np.linalg.eigh(update)
            update_adj = vec.dot(np.linalg.solve(vec.T, np.diag(np.maximum(val, 0)).T).T)
        else:
            update_adj = update
        sigma_cov = sigma_cov + update
        sigma_cov_adj = sigma_cov_adj + update_adj
        m += 1
    return sigma_cov_adj
