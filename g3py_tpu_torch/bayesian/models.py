"""Model scoring and datatrace-wide (batched) evaluation (the PyTorch
counterpart of :class:`g3py_tpu.bayesian.models.PlotModel`), the plots
and the widgets.

:meth:`BatchedModel.scores` is the reference's metric set of one params
point against the true values ``hidden`` at the space.  The reference
evaluated a datatrace by looping ``predict`` once per row.  The JAX package
``vmap``-s the row axis; here the rows are an explicit leading axis:
:meth:`BatchedModel.batch_predict` turns an (R, ndim) matrix of
unconstrained rows into one params dict of rows, factors every row's
posterior in ONE batched call, and evaluates every statistic for all rows
at once.  :meth:`BatchedModel.average` is its mean over the rows, with the
rows' ``_l1``/``_l2`` against ``hidden``; an option the batched form does
not take (``samples``, ``distribution``, ``simulations``) falls back to the
row loop :meth:`BatchedModel._average_loop`, as in the JAX package.
:meth:`BatchedModel.batch_sample` draws one warped posterior sample per
row from one batched factorization of the rows' states and one of their
posterior covariances (per chunk of rows), and :meth:`BatchedModel.particles`
cycles a datatrace's rows through it.
"""

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..utils import DictObj

__all__ = ["BatchedModel"]


def _row_scores(mean_rows, hidden):
    """``_l1``/``_l2`` of (R, m) row means against ``hidden`` (float64,
    over every row and point), or {} when the space is not ``hidden``'s."""
    if hidden is None or mean_rows.shape[-1] != len(hidden):
        return {}
    resid = mean_rows.to(torch.float64) - torch.as_tensor(hidden, dtype=torch.float64,
                                                          device=mean_rows.device)
    return {"_l1": float(resid.abs().mean()), "_l2": float((resid * resid).mean())}


class BatchedModel:
    """Mixin of :class:`~g3py_tpu_torch.models.stochastic.StochasticProcess`:
    needs ``active``, ``predict``, ``hidden`` and the ``_batch_statistics``
    hook of the process family."""

    @host_statistic
    def sample(self, params=None, space=None, inputs=None, outputs=None, samples=1,
               prior=False, noise=False):
        """``samples`` draws of the process at the space, (m, samples)."""
        return self.predict(params=params, space=space, inputs=inputs, outputs=outputs,
                            mean=False, std=False, samples=samples, prior=prior,
                            noise=noise)["samples"]

    def scores(self, params=None, space=None, hidden=None, inputs=None, outputs=None,
               logp=False, logpred=False, bias=True, variance=False, median=False,
               loo=False, *args, **kwargs):
        """The reference's metric set against the true values ``hidden``
        (default: the process's) at the space, Python floats: ``_l1``,
        ``_l2`` (``bias``); ``_mse``, ``_rmse`` (``variance``);
        ``_median_l1``, ``_median_l2`` (``median``); ``_logp``,
        ``_loglike``, ``_logprior`` (``logp``); ``_nlpd``, the negative
        log predictive density a point (``logpred``); ``_loo``, the
        leave-one-out log pseudo-likelihood of the observed data (``loo``,
        processes that have ``loo``)."""
        if hidden is None:
            hidden = self.hidden
        pred = device_statistics(self).predict(params=params, space=space, inputs=inputs,
                                              outputs=outputs, mean=True, var=variance,
                                              median=median, distribution=logpred)
        target = as_tensor(np.asarray(hidden))
        out = DictObj()
        if bias:
            out["_l1"] = float((pred.mean - target).abs().mean())
            out["_l2"] = float(((pred.mean - target) ** 2).mean())
        if variance:
            out["_mse"] = float(((pred.mean - target) ** 2 + pred.variance).mean())
            out["_rmse"] = float(np.sqrt(out["_mse"]))
        if median:
            out["_median_l1"] = float((pred.median - target).abs().mean())
            out["_median_l2"] = float(((pred.median - target) ** 2).mean())
        if logp:
            out["_logp"] = self.logp(params)
            out["_loglike"] = self.loglike(params)
            out["_logprior"] = self.logp(params, prior=True)
        if logpred:
            out["_nlpd"] = -float(pred.logpredictive(hidden)) / len(hidden)
        if loo and hasattr(self, "loo"):
            out["_loo"] = self.loo(params)
        return out

    def eval_params(self, params=None):
        """``params`` with its logp (``_ll``) and :meth:`scores`."""
        r = DictObj(params)
        r["_ll"] = self.logp(self.filter_params(params))
        r.update(self.scores(params))
        return r

    def _datatrace_rows(self, datatrace):
        return np.asarray(datatrace[self.active.param_names()], dtype=settings.floatx)

    def _batch_statistics(self, rows, space, inputs, outputs, prior=False, **flags):
        raise NotImplementedError(f"{type(self).__name__} has no batched predictive")

    def batch_predict(self, rows, space=None, inputs=None, outputs=None, mean=True,
                      std=True, var=False, cov=False, median=False, quantiles=False,
                      quantiles_noise=False, prior=False, noise=False, **extra):
        """Requested statistics for an (R, ndim) matrix of unconstrained
        parameter rows, each a tensor with a leading row axis (the keys of
        ``predict``; ``covariance`` is (R, m, m))."""
        unsupported = sorted(k for k, v in extra.items() if v)
        if unsupported:
            raise NotImplementedError(
                f"batch_predict does not support {unsupported} yet (ROADMAP Queue 1 item 7)")
        if inputs is None and not self.is_observed:
            prior = True
        rows = np.asarray(rows, dtype=settings.floatx)
        if rows.ndim == 1:
            rows = rows[None, :]
        return self._batch_statistics(rows, space, inputs, outputs, mean=mean, std=std,
                                      var=var, cov=cov, median=median, quantiles=quantiles,
                                      quantiles_noise=quantiles_noise, prior=prior,
                                      noise=noise)

    def average(self, datatrace, scores=True, *args, **kwargs):
        """Average predictions over the datatrace's rows (the reference's
        Bayesian model average), every row factored in one batched call;
        float64 tensors on ``settings.device``.  With ``scores``, ``_l1``
        and ``_l2`` of every row's mean against ``hidden`` when the space
        is ``hidden``'s.  Options the batched form does not take go through
        the row loop (:meth:`_average_loop`)."""
        try:
            batch = self.batch_predict(self._datatrace_rows(datatrace), *args, **kwargs)
        except NotImplementedError:
            return self._average_loop(datatrace, scores, *args, **kwargs)
        out = DictObj({k: v.to(torch.float64).mean(dim=0) for k, v in batch.items()})
        if scores:
            mean_rows = batch.get("mean")
            if mean_rows is None:
                flags = {k: kwargs[k] for k in ("space", "inputs", "outputs", "prior", "noise")
                         if k in kwargs}
                mean_rows = self.batch_predict(self._datatrace_rows(datatrace), mean=True,
                                               std=False, **flags)["mean"]
            out.update(_row_scores(mean_rows, self.hidden))
        return out

    def _average_loop(self, datatrace, scores=True, *args, **kwargs):
        """The per-row fallback of :meth:`average`: ``predict`` (and with
        ``scores`` :meth:`scores`) at every row, summed and divided by the
        number of rows, as the JAX package's loop does (tensors in
        float64, scores as floats)."""
        total = None
        for _, row in datatrace.iterrows():
            params = self.active.params_serie(row)
            pred = device_statistics(self).predict(params, *args, **kwargs)
            if scores:
                pred.update(self.scores(params, *args, **kwargs))
            pred = {k: v.to(torch.float64) if isinstance(v, torch.Tensor) else v
                    for k, v in pred.items()}
            if total is None:
                total = DictObj(pred)
            else:
                for key in pred:
                    total[key] = total[key] + pred[key]
        for key in total:
            total[key] = total[key] / len(datatrace)
        return total

    def _batch_latent_rand(self, rows, n, rng, space=None, inputs=None, outputs=None,
                           prior=False, noise=False):
        """Per-row latent innovations (R, n), or None when the family's
        sampler is not a coloured-normal form."""
        return None

    def batch_sample(self, rows, space=None, inputs=None, outputs=None, prior=False,
                     noise=False, rng=None, chunk=None, **extra):
        """One warped posterior draw per row of an (R, ndim) matrix of
        unconstrained rows, (R, m) on ``settings.device``: the innovations
        come from ``rng`` (numpy's Generator, a fresh one when None), and
        each chunk of rows (``chunk``, by default what keeps the (chunk, m,
        m) posterior covariances under ~256 MB at float32) is one batched
        factorization of the rows' states and one of their posterior
        covariances."""
        if extra.pop("samples", 1) not in (None, 1) or any(extra.values()):
            # e.g. samples=3: a per-row-only option, left to the row loop
            raise NotImplementedError(
                f"batch_sample does not support {sorted(extra) or 'samples>1'}")
        if rng is None:
            rng = np.random.default_rng()
        if inputs is None and not self.is_observed:
            prior = True
        rows = np.asarray(rows, dtype=settings.floatx)
        m = len(self.space if space is None else space)
        if chunk is None:
            chunk = max(1, int(2 ** 26 // max(m * m, 1)))
        outs = []
        for lo in range(0, len(rows), chunk):
            sub = rows[lo:lo + chunk]
            rand = self._batch_latent_rand(sub, m, rng, space=space, inputs=inputs,
                                           outputs=outputs, prior=prior, noise=noise)
            if rand is None:
                raise NotImplementedError("no colored-normal sampler form")
            outs.append(self._batch_draws(sub, rand, space, inputs, outputs, prior=prior,
                                          noise=noise))
        return torch.cat(outs, dim=0)

    def particles(self, datatrace, nsamples=None, *args, **kwargs):
        """Posterior sample curves over the datatrace's rows, (m,
        nsamples): the rows cycled to ``nsamples`` (default: one a row)
        through :meth:`batch_sample`, or one ``sample`` a row when the
        batched form does not apply."""
        rows = self._datatrace_rows(datatrace)
        if nsamples is None:
            nsamples = len(rows)
        idx = np.resize(np.arange(len(rows)), nsamples)
        try:
            return self.batch_sample(rows[idx], *args, **kwargs).T
        except NotImplementedError:
            pass
        particles = []
        left = nsamples
        while left > 0:
            for _, row in datatrace.iterrows():
                particles.append(device_statistics(self).sample(self.active.params_serie(row),
                                                                *args, **kwargs))
                left -= 1
                if not left > 0:
                    break
        return torch.cat(particles, dim=1)

    # -- description and plots -----------------------------------------------------
    # matplotlib is imported by the drawing calls only (utils/plots.py)

    #: the params a widget's sliders set (None: the process's own)
    widget_params = None

    @property
    def params_widget(self):
        """The widget's params when a widget set some, else ``params``."""
        wp = getattr(self, "widget_params", None)
        return self.params if wp is None else DictObj(wp)

    def describe(self, title=None, x=None, y=None, text=None):
        """Set the plots' title, axis labels and text."""
        for key, value in (("title", title), ("x", x), ("y", y), ("text", text)):
            if value is not None:
                self.description[key] = value

    def plot_space(self, independent=False, observed=False):
        from ..utils.plots import figure, plot

        space = _host(self.space)
        if independent:
            for i in range(space.shape[1]):
                figure(i)
                plot(self.order, space[:, i])
        else:
            plot(self.order, space)
        if self.index is not None and observed:
            inputs = _host(self.inputs)
            if independent:
                for i in range(space.shape[1]):
                    figure(i)
                    plot(self.index, inputs[:, i], ".k")
            else:
                plot(self.index, inputs, ".k")

    def plot_hidden(self, order=None, hidden=None, big=None):
        from ..utils.plots import plot

        order = self.order if order is None else order
        hidden = self.hidden if hidden is None else hidden
        big = settings.plot_big if big is None else big
        if hidden is None:
            return
        if big:
            plot(order, hidden, "w", alpha=1.0, lw=4, label="")
            plot(order, hidden, "k", alpha=0.9, lw=3, label="Hidden Process")
        else:
            plot(order, hidden, "w", alpha=0.8, lw=3, label="")
            plot(order, hidden, "k", alpha=1.0, lw=2, label="Hidden Process")

    def plot_observations(self, index=None, outputs=None, big=None):
        from ..utils.plots import plot

        index = self.index if index is None else index
        outputs = self.outputs if outputs is None else outputs
        if outputs is None:
            return
        plot(index, outputs, "Xw", ms=12)
        plot(index, outputs, "Xk", ms=10, label="Observations")

    def plot(self, params=None, space=None, inputs=None, outputs=None, hidden=True, order=None,
             mean=True, std=False, cov=False, median=False, quantiles=True, quantiles_noise=True,
             samples=0, palette="Reds", prior=False, noise=False, simulations=None, values=None,
             data=True, logp=True, big=None, plot_space=False, title=None, labels=None,
             loc="best", ncol=3):
        """Predict, then draw the mean, median, bands, samples, the hidden
        process and the observations over ``order``."""
        from ..utils.plots import plot, plot_text, pyplot, show

        plt = pyplot()
        labels = {} if labels is None else labels
        if values is None:
            values = self.predict(params=params, space=space, inputs=inputs, outputs=outputs,
                                  mean=mean, std=std, cov=cov, median=median,
                                  quantiles=quantiles, quantiles_noise=quantiles_noise,
                                  samples=samples, prior=prior, noise=noise,
                                  simulations=simulations)
        values = {k: _host(v) for k, v in values.items()}
        cmap = plt.get_cmap(palette if palette is not None else "Reds")
        order = self.order if order is None else order
        space = _host(self.space if space is None else space)
        if len(order) != len(space):
            if len(space.shape) == 1:
                order = space
            elif space.shape[1] == 1:
                order = space[:, 0]
            else:
                order = np.arange(len(space))
        if samples > 0:
            labels.setdefault("samples", None)
            plot(order, values["samples"][:, 0], color=cmap(0.9), alpha=0.15, lw=1.0,
                 label=labels["samples"])
            plot(order, values["samples"], color=cmap(0.9), alpha=0.15, lw=1.0)
        if mean:
            labels.setdefault("mean", "Mean")
            plot(order, values["mean"], "-w", alpha=1.0, lw=4)
            plot(order, values["mean"], "-", color=cmap(1.0), alpha=0.8, lw=3,
                 label=labels["mean"])
        if median:
            labels.setdefault("median", "Median")
            plot(order, values["median"], "--w", alpha=1.0, lw=4)
            plot(order, values["median"], "--", color=cmap(1.0), alpha=0.8, lw=3,
                 label=labels["median"])
        if quantiles:
            labels.setdefault("quantiles", "95% CI")
            plot(order, values["quantile_up"], "--", color=cmap(1.0), alpha=0.5, lw=2,
                 label=labels["quantiles"])
            plot(order, values["quantile_down"], "--", color=cmap(1.0), alpha=0.5, lw=2)
            plt.fill_between(order, values["quantile_up"], values["quantile_down"],
                             color=cmap(1.0), alpha=0.1)
        if quantiles_noise:
            labels.setdefault("quantiles_noise", "95% CI + Noise")
            plt.fill_between(order, values["noise_up"], values["noise_down"], color=cmap(1.0),
                             alpha=0.1, label=labels["quantiles_noise"])
        if std:
            labels.setdefault("std", "4.0 Std")
            plot(order, values["mean"] + 2.0 * values["std"], "--k", alpha=0.2,
                 label=labels["std"])
            plot(order, values["mean"] - 2.0 * values["std"], "--k", alpha=0.2)
        if data and hidden is not False:
            self.plot_hidden(big=big)
        if data and self.is_observed:
            self.plot_observations(big=big)
        if title is None:
            title = self.description["title"]
        if logp:
            title += " (logp: {0:.3f})".format(float(
                self.logp(self.params if params is None else params)))
        if loc is not None:
            plot_text(title, self.description["x"], self.description["y"], loc=loc, ncol=ncol)
        if plot_space:
            show()
            plot(order, space)
            plot_text("Space X", "Index", "Value", legend=False)

    def plot_datatrace(self, datatrace, overlap=False, limit=10, scores=True, *args, **kwargs):
        """Plot each datatrace row's params (at most ``limit``)."""
        from ..utils.plots import plot_text, show

        for k, v in datatrace.iterrows():
            params = self.active.params_serie(v)
            self.plot(params, *args, **kwargs)
            if not overlap:
                name = (str(k) + " - " + str(self.scores(params, *args, **kwargs)) if scores
                        else str(k))
                plot_text(name, self.description["x"], self.description["y"])
                show()
            if limit is None:
                pass
            elif limit > 1:
                limit -= 1
            else:
                break

    # -- widgets ---------------------------------------------------------------------
    def _widget_intervals(self, params):
        """Each param's slider (min, max, value, step): the widget's layout,
        apart from ipywidgets so that it runs headless."""
        intervals = dict()
        for k, v in params.items():
            v = _host(v)
            v = float(np.squeeze(v)) if np.size(v) == 1 else float(np.mean(v))
            if v > 0.1:
                intervals[k] = (0.0, 2 * v, v, 1e-2)
            elif v < -0.1:
                intervals[k] = (2 * v, 0.0, v, 1e-2)
            else:
                intervals[k] = (-5.0, 5.0, v, 1e-2)
        return intervals

    def widget(self, params=None, model=False, auto=False, *args, **kwargs):
        """Interactive param sliders (needs ipywidgets and a notebook)."""
        from ipywidgets import interact, interact_manual, FloatSlider

        if params is None:
            params = self.params_widget
        intervals = {k: FloatSlider(min=lo, max=hi, value=v, step=st)
                     for k, (lo, hi, v, st) in self._widget_intervals(params).items()}
        self._widget_args = args
        self._widget_kwargs = kwargs
        widget_plot = self._widget_plot_model if model else self._widget_plot
        return (interact if auto else interact_manual)(widget_plot, **intervals)

    def _check_params_dims(self, params):
        spec = self.active.params_spec
        return {k: np.array(v, dtype=settings.floatx).reshape(spec[k].shape)
                for k, v in params.items() if k in spec}

    def _widget_plot(self, **params):
        from ..utils.plots import show

        self.widget_params = self._check_params_dims(params)
        self.plot(params=self.params_widget, *self._widget_args, **self._widget_kwargs)
        show()

    def _widget_plot_model(self, **params):
        from ..utils.plots import show

        self.widget_params = self._check_params_dims(params)
        self.plot_model(params=self.params_widget, indexs=None, kernel=False, mapping=True,
                        marginals=True, bivariate=False)
        show()


def _host(v):
    """A tensor's values on the host (anything else as numpy)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
