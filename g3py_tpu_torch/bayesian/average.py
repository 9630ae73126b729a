"""The datatrace toolkit: chain post-processing, convergence diagnostics
and posterior analytics (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.average`).

* :func:`chains_to_datatrace` / :func:`datatrace_to_chains` — chains
  (nchain, niter, ndim) <-> a flat :class:`~g3py_tpu_torch.utils.datatrace.
  Datatrace` with the JAX package's columns: burn-in flag from a
  Gelman-Rubin bisection, outlier flag from ll/param quantiles (numpy's
  linear rule, which is pandas'), transformed param columns.
* :func:`gelman_rubin` (multi-sum, multi-max, uni), :func:`burn_in_samples`,
  :func:`effective_sample_min`, :func:`effective_sample_size` and the mESS
  estimators (mIS, adjusted mIS, batch means).

* :func:`datatrace_to_kde` / :func:`kde_to_datatrace` — a kernel density
  over the post-burn-in rows, and rejection-refilled draws from it whose
  logps are one batched ``logp_chain`` call a refill.
* :func:`cluster_datatrace` — a gaussian mixture (maximum likelihood or
  variational with Dirichlet-process weights) over the rows, labels
  relabelled by cluster size (0 the largest), and a ``_cluster`` labeler
  attached to the process.
* :func:`errors_datatrace` — every row's prediction errors (``_l1``,
  ``_l2``, ``_nlpd``, ``_mse``) from one batched evaluation of the
  process's ``th_error_*``/``th_logpredictive`` over all the rows: a
  params dict of R rows with their posterior states, factored together.
* :func:`marginal_datatrace`, :func:`conditional_datatrace`,
  :func:`find_candidates` — column and row filters and the best rows by
  criterion and cluster.

The host parts are numpy.  The JAX package runs the autocovariance,
batch-means and univariate R-hat cores in C++ (``g3py_tpu/native.py``) with
numpy fallbacks, and the densities and mixtures through scikit-learn; the
port keeps its own copy of the numpy forms and of those algorithms
(:mod:`.density`).  The plots draw with matplotlib and seaborn, imported
by the drawing calls only.
"""

import numpy as np
import torch

from ..config import settings, as_tensor
from ..utils.datatrace import Datatrace
from .density import BayesianGaussianMixture, GaussianMixture, KernelDensity

__all__ = [
    "chains_to_datatrace",
    "datatrace_to_chains",
    "datatrace_to_kde",
    "kde_to_datatrace",
    "cluster_datatrace",
    "errors_datatrace",
    "marginal_datatrace",
    "conditional_datatrace",
    "marginal",
    "conditional",
    "find_candidates",
    "gelman_rubin",
    "burn_in_samples",
    "effective_sample_min",
    "effective_sample_size",
    "plot_datatrace",
    "plot_clusters",
    "kde_datatrace",
    "hist_datatrace",
    "scatter_datatrace",
]


def chains_to_datatrace(process, chains, ll=None, transforms=True, burnin_tol=0.01,
                        burnin_method="multi-sum", burnin_dims=None,
                        burnin_default=0.1, outlayer_percentile=0.001,
                        clusters=None):
    """chains (nchain, niter, ndim) -> a Datatrace with per-var columns,
    ``_nchain/_niter/_ll``, the burn-in flag (``_niter > nburn``, nburn from
    the Gelman-Rubin bisection), the outlier flag (inside the
    ``outlayer_percentile`` quantiles of every param and of ``_ll``, and
    finite), the transformed param columns and, with ``clusters``, the
    ``_cluster`` labels of :func:`cluster_datatrace`."""
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
            vals = np.asarray(base[qcols], dtype=np.float64)
            lower = np.nanquantile(vals, q, axis=0)
            upper = np.nanquantile(vals, 1 - q, axis=0)
            par = np.asarray(dt[columns])
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
    if clusters is not None and clusters > 0:
        cluster_datatrace(process, dt, clusters)
    return dt


def datatrace_to_chains(process, dt, flat=False, burnin=False):
    """Inverse of :func:`chains_to_datatrace`: (nchain, niter, ndim), or the
    (rows, ndim) matrix with ``flat``; ``burnin`` keeps the rows past the
    burn-in (all of them when burn-in never converged)."""
    chain = dt[dt["_burnin"]] if burnin and "_burnin" in dt and dt["_burnin"].any() else dt
    values = np.asarray(chain[process.active.param_names()])
    if flat:
        return values
    nchain = len(np.unique(chain["_nchain"]))
    return values.reshape(nchain, len(chain) // nchain, process.active.ndim)


# ---------------------------------------------------------------------------
# posterior analytics
# ---------------------------------------------------------------------------


def datatrace_to_kde(process, dt, kernel="tophat", bandwidth=0.02, min_ll=-1e6):
    """Kernel density over the post-burn-in rows with a finite ``_ll``
    above ``min_ll``; ``min_ll`` of the result is their smallest ``_ll``
    (the refill threshold of :func:`kde_to_datatrace`)."""
    if "_ll" in dt:
        dt = dt[np.isfinite(dt["_ll"])]
        dt = dt[dt["_ll"] > min_ll]
    sel = dt[dt["_burnin"]] if "_burnin" in dt else dt
    kde = KernelDensity(kernel=kernel, bandwidth=bandwidth).fit(
        np.asarray(sel[process.active.param_names()]))
    kde.min_ll = sel["_ll"].min() if "_ll" in sel else -np.inf
    return kde


def kde_to_datatrace(process, kde, nsamples=1000, prior=False):
    """``nsamples`` draws of ``kde`` whose logp exceeds ``kde.min_ll``,
    refilled until there are enough (each refill's logps one batched
    ``logp_chain`` call), as a one-chain datatrace, every row past the
    burn-in (and labelled by the process's ``_cluster`` when one is
    attached)."""
    samples = kde.sample(n_samples=1)
    ll = np.asarray(process.logp_chain(samples, prior=prior))
    keep = ll > kde.min_ll
    samples, ll = samples[keep], ll[keep]
    while len(samples) < nsamples:
        new = kde.sample(n_samples=nsamples - len(samples))
        new_ll = np.asarray(process.logp_chain(new, prior=prior))
        keep = new_ll > kde.min_ll
        samples = np.concatenate([samples, new[keep]])
        ll = np.concatenate([ll, new_ll[keep]])
    kde_dt = chains_to_datatrace(process, samples[None, :, :], ll=ll[None, :])
    if hasattr(process, "_cluster"):
        process._cluster(kde_dt)
    kde_dt["_burnin"] = np.ones(len(kde_dt), dtype=bool)
    return kde_dt


def cluster_datatrace(process, dt, n_components=5, bayesian=True, burnin=True,
                      outlayer=True, n_init=1, max_iter=5000):
    """Fit a full-covariance gaussian mixture (``bayesian``: variational,
    with Dirichlet-process weights) to the rows past the burn-in and inside
    the outlier bounds (all rows when none is), then label every row of
    ``dt`` in a ``_cluster`` column, 0 the most populous cluster of the
    fit.  The labeler is attached to the process as ``_cluster`` and
    returned.  The k-means initialisation draws from numpy's global
    ``RandomState``."""
    cols = process.active.param_names()
    sel = dt
    if burnin and "_burnin" in sel:
        tmp = sel[sel["_burnin"]]
        if len(tmp) > 0:
            sel = tmp
    if outlayer and "_outlayer" in sel:
        tmp = sel[sel["_outlayer"]]
        if len(tmp) > 0:
            sel = tmp
    data = np.asarray(sel[cols])
    method = BayesianGaussianMixture if bayesian else GaussianMixture
    gm = method(n_components=n_components, max_iter=max_iter, n_init=n_init).fit(data)
    labels = gm.predict(data)
    argsort = np.argsort(np.bincount(labels, minlength=n_components))
    argsorted = sorted(np.arange(n_components), reverse=True)

    def _cluster(datatrace):
        pred = gm.predict(np.asarray(datatrace[cols]))
        datatrace["_cluster"] = (pred == argsort[:, None]).T.dot(argsorted)

    _cluster(dt)
    process._cluster = _cluster
    return _cluster


def errors_datatrace(process, dt, inputs=None, outputs=None, space=None, hidden=None,
                     l1=True, l2=True, nlpd=False, mse=False):
    """Every row's prediction errors at ``space`` against ``hidden`` (zeros
    when None, as in the JAX package), as columns ``_l1``, ``_l2``,
    ``_nlpd`` (the negative log predictive density a point) and ``_mse``
    of ``dt`` (float32).  All rows are one params dict of rows: a process
    with posterior states factors them together (one batched K2 launch),
    and each statistic is one batched evaluation of its ``th_*`` builder.
    A row whose params are not finite gives NaN (or the logp guard); a
    structural error raises."""
    reg = process.active
    rows = np.asarray(dt[reg.param_names()], dtype=settings.floatx)
    prior = inputs is None and not process.is_observed
    s, i, o = process._resolve_data(space, inputs, outputs)
    with torch.no_grad():
        if prior or not hasattr(process, "posterior_state_rows"):
            params = reg.array_to_dict_tensor(as_tensor(rows))
        else:
            p, state = process.posterior_state_rows(rows, i, o)
            params = {**p, **state}
        vector = (torch.zeros(s.shape[0], dtype=s.dtype, device=s.device) if hidden is None
                  else process._as_vector(hidden))

        def batch(th_name, **kw):
            out = getattr(process, th_name)(prior=prior, **kw)(params, s, i, o, vector)
            out = np.asarray(out.detach().cpu().numpy(), dtype=np.float32)
            if th_name == "th_error_mse":
                # the targets' own spread: no params, one value for every row
                out = np.broadcast_to(out, (len(rows),)).copy()
            if out.shape != (len(rows),):
                raise ValueError(f"{th_name} gave shape {out.shape} for {len(rows)} rows")
            return out

        if l1:
            dt["_l1"] = batch("th_error_l1")
        if l2:
            dt["_l2"] = batch("th_error_l2")
        if nlpd:
            dt["_nlpd"] = -batch("th_logpredictive", noise=True) / s.shape[0]
        if mse:
            dt["_mse"] = batch("th_error_mse")
    return dt


def marginal_datatrace(dt, items=None, like=None, regex=None, drop=None, samples=None):
    """The columns ``drop`` leaves, filtered by ``items``/``like``/``regex``
    (:meth:`Datatrace.filter`), and ``samples`` random rows of them (drawn
    from numpy's global ``RandomState``) when fewer than all."""
    if drop is not None:
        dt = dt.drop(drop, axis=1)
    if items is None and like is None and regex is None:
        df = dt
    else:
        df = dt.filter(items=items, like=like, regex=regex)
    if samples is None or samples > len(df):
        return df
    return df.sample(samples)


def conditional_datatrace(dt, lambda_df):
    """The rows a boolean array, or a callable of the datatrace returning
    one, selects."""
    out = dt[lambda_df]
    print("#" + str(len(out)) + " (" + str(100 * len(out) / len(dt)) + " %)")
    return out


def marginal(dt, items=None, like=None, regex=None, drop=None, samples=None):
    return marginal_datatrace(dt, items=items, like=like, regex=regex, drop=drop,
                              samples=samples)


def conditional(dt, lambda_df):
    return conditional_datatrace(dt, lambda_df)


def _in_order(values):
    """The distinct values in order of first appearance."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def find_candidates(dt, ll=1, l1=0, l2=0, nlpd=0, mse=0, mean=False, median=False,
                    by_cluster=True, rand=0):
    """The best rows by each criterion (the ``ll`` largest ``_ll``, the
    ``l1``/``l2``/``nlpd``/``mse`` smallest errors), per cluster when the
    datatrace has one, among the rows distinct on the params, with the
    column ``n`` holding each row's label; ``mean``/``median`` add the
    numeric columns' means/medians, ``rand`` random rows.  The result's
    ``index`` names each row (``ll0``, ``l21``, ``mean``, ... or a random
    row's label), sorted by ``_ll`` descending when it has one."""
    dt_full = dt.drop_duplicates(subset=[k for k in dt.columns if not k.startswith("_")])
    clustered = by_cluster and "_cluster" in dt_full
    groups = _in_order(dt_full["_cluster"]) if clustered else [0]
    rows, names = [], []
    for c in groups:
        sel = dt_full[dt_full["_cluster"] == c] if clustered else dt_full
        for crit, count, largest in [("_ll", ll, True), ("_l1", l1, False), ("_l2", l2, False),
                                     ("_nlpd", nlpd, False), ("_mse", mse, False)]:
            if crit in sel and count:
                best = sel.nlargest(count, crit) if largest else sel.nsmallest(count, crit)
                for label, (_, row) in zip(best.index, best.iterrows()):
                    rows.append(dict(row, n=label))
                    names.append(crit.lstrip("_") + str(c))
        if mean:
            rows.append(sel.mean(numeric_only=True))
            names.append("mean")
        if median:
            rows.append(sel.median(numeric_only=True))
            names.append("median")
    if rand:
        extra = dt.sample(rand)
        rows += [row for _, row in extra.iterrows()]
        names += list(extra.index)
    index = np.empty(len(names), dtype=object)
    index[:] = names
    out = Datatrace.from_rows(rows, list(dt.columns) + ["n"], index=index)
    if "_ll" in out:
        out = out.sort_values(by="_ll", ascending=False)
    return out


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


# ---------------------------------------------------------------------------
# plots: matplotlib and seaborn are imported by the drawing calls only; the
# seaborn grids take a pandas frame of the columns (seaborn needs pandas)
# ---------------------------------------------------------------------------


def _frame(dt, columns):
    import pandas as pd

    return pd.DataFrame({c: dt[c] for c in columns})


def _finite(values):
    values = np.asarray(values)
    return values[~np.isnan(values)] if values.dtype.kind == "f" else values


def plot_datatrace(datatrace, varnames=None, burnin=True, outlayer=True, combined=False,
                   figsize=None):
    """A kde and trace panel a variable (pymc3's layout), with the burn-in's
    end marked; the kde over the kept (post burn-in, non-outlier) rows."""
    import seaborn as sb
    from ..utils.plots import pyplot

    plt = pyplot()
    dt = datatrace
    if varnames is None:
        varnames = [c for c in dt.columns if not c.startswith("_")]
    n = len(varnames)
    if n == 0:
        return
    fig, axs = plt.subplots(n, 2, squeeze=False, figsize=figsize or (12, 2.2 * n))
    nburn = None
    if "_burnin" in dt and (~dt["_burnin"]).any():
        nburn = dt["_niter"][~dt["_burnin"]].max()
    sel = dt
    if burnin and "_burnin" in dt and dt["_burnin"].any():
        sel = sel[sel["_burnin"]]
    if outlayer and "_outlayer" in sel and sel["_outlayer"].any():
        sel = sel[sel["_outlayer"]]
    chains = dt["_nchain"]
    for i, v in enumerate(varnames):
        vals = _finite(sel[v])
        try:
            sb.kdeplot(x=vals, ax=axs[i][0], fill=True)
        except (ValueError, np.linalg.LinAlgError):
            axs[i][0].hist(vals, bins=30)
        axs[i][0].set_title(v)
        for c in np.unique(chains):
            axs[i][1].plot(dt["_niter"][chains == c], dt[v][chains == c], alpha=0.4, lw=0.7)
        if nburn is not None:
            axs[i][1].axvline(nburn, color="r", ls="--", alpha=0.6)
        axs[i][1].set_title(v)
    plt.tight_layout()
    return fig


def plot_clusters(process, dt, clusters=None, *args, **kwargs):
    """The best row (by ``_ll``) of each cluster, plotted through the
    process (the clusters are computed first when ``dt`` has none)."""
    from ..utils.plots import show

    if "_cluster" not in dt:
        cluster_datatrace(process, dt, n_components=clusters or 5)
    for c in sorted(np.unique(dt["_cluster"])):
        sel = dt[dt["_cluster"] == c]
        best = sel[np.array([int(np.argmax(sel["_ll"]))])]
        row = next(r for _, r in best.iterrows())
        process.plot(params=process.active.params_serie(row), title=f"cluster {c}", *args,
                     **kwargs)
        show()


def kde_datatrace(dt, varnames=None, size=6):
    """A pair grid of kdes over (the first four) variables."""
    import seaborn as sb

    if varnames is None:
        varnames = [c for c in dt.columns if not c.startswith("_")][:4]
    g = sb.PairGrid(_frame(dt, varnames), height=size / max(len(varnames), 1))
    g.map_diag(sb.kdeplot)
    g.map_offdiag(sb.kdeplot, fill=True)
    return g


def hist_datatrace(dt, varnames=None, bins=50, reference=None, figsize=None):
    """A histogram a variable, three a row, with ``reference`` values
    marked."""
    from ..utils.plots import pyplot

    plt = pyplot()
    if varnames is None:
        varnames = [c for c in dt.columns if not c.startswith("_")]
    n = len(varnames)
    fig, axs = plt.subplots((n + 2) // 3, 3, squeeze=False,
                            figsize=figsize or (12, 2.5 * ((n + 2) // 3)))
    for i, v in enumerate(varnames):
        ax = axs[i // 3][i % 3]
        ax.hist(_finite(dt[v]), bins=bins)
        ax.set_title(v)
        if reference is not None and v in reference:
            ax.axvline(np.asarray(reference[v]).ravel()[0], color="r", ls="--")
    plt.tight_layout()
    return fig


def scatter_datatrace(dt, varnames=None, samples=1000):
    """A pair plot of (the first four) variables over at most ``samples``
    rows, coloured by cluster when there are clusters."""
    import seaborn as sb

    if varnames is None:
        varnames = [c for c in dt.columns if not c.startswith("_")][:4]
    sel = dt if len(dt) <= samples else dt.sample(samples)
    hue = "_cluster" if "_cluster" in sel else None
    return sb.pairplot(_frame(sel, varnames + ([hue] if hue else [])), hue=hue, corner=True)
