"""Serving fast path: factor once, answer query batches with products.

The PyTorch counterpart of :class:`g3py_tpu.models.predictor.Predictor`
and :class:`~g3py_tpu.models.predictor.AveragedPredictor`.  The observed
gram is factored ONCE into ``(L^{-1}, alpha, z)`` device tensors
(``EllipticalProcess.posterior_state``); each query batch then costs one
cross gram ``K(x*, X)`` and one query gram (both through the fused
stationary-gram kernel on the card), one product with ``L^{-1}`` and
elementwise work:

  mean(s)  = T(m(s) + K_sX alpha)                    (GH quadrature for WGP)
  var(s)   = k_ss - colsum((L^{-1} K_Xs)^2)           (+ noise for bands)

and a Student-t process scales the variance by (nu + z'z - 2)/(nu + n - 2)
from the state's whitened residual z and takes Student-t quantiles at
nu + n degrees of freedom (per row for an averaged predictor).

Every requested statistic of a batch shares that one cross gram.  The
averaged predictor holds one state per datatrace row, stacked, factored by
one batched K2 call; its query batch is one batched K1 cross gram, one
batched query gram and batched products for all rows, averaged over the
rows.  The JAX package bakes the state into per-statistic jitted closures
to dodge a TPU runtime's per-argument dispatch cost; eager PyTorch has no
such cost, so these predictors are plain objects holding tensors.

A Predictor also absorbs new observations without refactorizing the old
ones (:meth:`Predictor.updated`, the block-Cholesky identity), draws
posterior paths that are consistent across query batches
(:meth:`Predictor.pathwise_sampler`, random Fourier features and
Matheron's update) and writes itself out as a serving artifact that loads
without model code (:meth:`Predictor.export`, ``torch.export``; loaded by
:func:`g3py_tpu_torch.serving.load_predictor`).

:class:`IterativePredictor` serves training sets too large to factor: one
preconditioned-CG solve, then blocked cross grams only
(:mod:`g3py_tpu_torch.ops.iterative`).
"""

import contextlib
import json
import math
import os

import numpy as np
import torch

from ..config import settings, as_tensor, host_statistic, device_statistics
from ..utils import DictObj
from ..bayesian.models import _row_scores

__all__ = ["Predictor", "AveragedPredictor", "IterativePredictor", "DistributedPredictor",
           "statistics"]


def statistics(proc, p, space, inputs, outputs, mean=True, std=True, var=False, cov=False,
               median=False, quantiles=False, quantiles_noise=False, noise=False,
               prior=False, batch=False, pair=None):
    """Statistics of one query batch from a params dict ``p`` that carries
    a posterior state (same keys as ``process.predict``): ``mean``, ``std``,
    ``variance``, ``covariance`` (m, m), ``median``,
    ``quantile_up``/``quantile_down`` (2.5% and 97.5%) and, with
    ``quantiles_noise``, the observation-noise bands ``noise_std``,
    ``noise_up`` and ``noise_down``; with ``prior`` the prior's.  A dict of
    R rows gives (R, m).  The latent quantile coefficients and the moments
    are the process's own (a Student-t process scales the variance by its
    posterior factor and takes Student-t quantiles); ``batch`` takes the
    coefficients of ``batch_predict``; ``pair`` gives the (up, down)
    coefficients instead (an exported bundle bakes them)."""
    if not hasattr(proc, "_latent_moments"):
        return _th_statistics(proc, p, space, inputs, outputs, mean=mean, std=std, var=var,
                              cov=cov, median=median, quantiles=quantiles or quantiles_noise,
                              noise=noise, prior=prior)
    up, down = (proc._quantile_pair(p, inputs, prior=prior, batch=batch)
                if pair is None and (quantiles or quantiles_noise) else pair or (None, None))
    values = DictObj()

    def bands(var):  # T(loc + z_q sd) at q = 97.5% and 2.5%
        sd = torch.sqrt(var)
        return proc.f_mapping(p, loc + up * sd), proc.f_mapping(p, loc + down * sd)

    with torch.no_grad():
        loc, latent, noise_var = proc._latent_moments(p, space, inputs, outputs, prior=prior)
        moments = proc._moments_fn(p, inputs, outputs, prior=prior)
        lvar = latent + noise_var if noise else latent
        if mean or std or var:
            m, v = moments(loc, lvar)
            if mean:
                values["mean"] = m
            if var:
                values["variance"] = v
            if std:
                values["std"] = torch.sqrt(v)
        if cov:
            cov_fn = proc.th_covariance(prior=prior, noise=noise)
            if cov_fn is None:
                raise ValueError(f"{type(proc).__name__} has no analytic posterior covariance")
            values["covariance"] = cov_fn(p, space, inputs, outputs, None)
        if median:
            values["median"] = proc.f_mapping(p, loc)
        if quantiles:
            values["quantile_up"], values["quantile_down"] = bands(lvar)
        if quantiles_noise:
            nvar = latent + noise_var
            values["noise_std"] = torch.sqrt(moments(loc, nvar)[1])
            values["noise_up"], values["noise_down"] = bands(nvar)
    return values


def _th_statistics(proc, p, space, inputs, outputs, mean=True, std=True, var=False,
                   cov=False, median=False, quantiles=False, noise=False, prior=False):
    """The statistics of a process with no fused latent-moment path (the
    sparse variational family), each from its own ``th_*`` builder, as the
    JAX package's bundle builds them; quantiles need the latent-quantile
    hook such a process lacks."""
    if quantiles:
        raise ValueError(
            f"{type(proc).__name__} has no analytic latent-quantile hook (_quantile_p): "
            "fused/exported quantiles are unavailable — use the process-level quantiler "
            "(Monte Carlo) or export mean/std/var only")
    values = DictObj()
    vector = torch.zeros(space.shape[0], dtype=space.dtype, device=space.device)
    with torch.no_grad():
        for key, th_name, on in (("mean", "th_mean", mean), ("variance", "th_variance", var),
                                 ("std", "th_std", std), ("covariance", "th_covariance", cov),
                                 ("median", "th_median", median)):
            if on:
                fn = getattr(proc, th_name)(prior=prior, noise=noise)
                if fn is None:
                    raise ValueError(f"{type(proc).__name__} has no {key}")
                values[key] = fn(p, space, inputs, outputs, vector)
    return values


class _Bound:
    """A process and its observed data at factorization time; rejects use
    after the data changed."""

    def _bind(self, process):
        self.process = process
        self._inputs_ref = process._inputs
        self._outputs_ref = process._outputs
        self.inputs = process._device_data("inputs")
        self.outputs = process._device_data("outputs")

    def _check(self):
        if (self.process._inputs is not self._inputs_ref
                or self.process._outputs is not self._outputs_ref):
            raise ValueError(
                f"the process's observed data changed after this {type(self).__name__}'s "
                "factorization — rebuild it")
        return self

    def _space(self, space):
        """Query points as a device matrix; the process's space when None."""
        return (self.process._device_data("space") if space is None
                else self.process._as_matrix(space))


class Predictor(_Bound):
    """Bound (process, params, factorized posterior state) for streaming
    prediction.

    >>> pr = gp.predictor(params)          # one O(n^3) factorization
    >>> out = pr(x_query, quantiles=True)  # dict of host arrays for the batch

    The state snapshots the process's observed inputs and outputs;
    changing them later (``observed``) invalidates the predictor, which then
    raises — rebuild it with ``process.predictor(params)``."""

    def __init__(self, process, params=None, _state=None):
        if params is None:
            params = process.params
        self._bind(process)
        self.params = process._tensor_params(process.filter_params(params))
        # _state: a state computed elsewhere (``updated``): no factorization
        self.state = process.posterior_state(self.params) if _state is None else _state
        self._merged = {**self.params, **self.state}

    def __getattr__(self, name):
        """Any other statistic of the process (``mean``, ``std``,
        ``quantiler``, ``sampler``, ...) at this predictor's params, as the
        JAX package's Predictor delegates them; keywords only (the
        process's positional slot is ``params``)."""
        if name.startswith("_") or "process" not in self.__dict__:
            raise AttributeError(name)
        target = getattr(self.process, name)
        if not callable(target):
            raise AttributeError(name)

        def bound(*args, **kwargs):
            self._check()
            return target(self.params, *args, **kwargs)

        bound.__name__ = name
        return bound

    # ------------------------------------------------------------ streaming
    def updated(self, x_new, y_new):
        """Absorb m new observations with no n x n refactorization: the
        state's factor is extended by the block-Cholesky identity
        (``EllipticalProcess._posterior_state_update_pure``: one (m, n)
        cross gram, one m x m gram and one m x m factorization) and a new
        Predictor is returned around it.  The process's observed data
        advance to the concatenation, so this predictor becomes stale (it
        raises) and the returned one takes over."""
        from ..hypers.kernels import WN, KernelNoise
        from .elliptical import _contains_kernel_noise
        self._check()
        proc = self.process
        # the update builds cross grams: a delta kernel (WN, KernelNoise)
        # gives var at coincident points on the square gram a refactorization
        # uses but 0 on a cross gram, so a streamed duplicate would diverge
        if _contains_kernel_noise(proc.f_kernel, (WN, KernelNoise)):
            raise ValueError(
                "Predictor.updated does not support white-noise terms "
                "(WN/KernelNoise) inside the signal kernel: their "
                "cross-covariance semantics differ from the square "
                "gram a full refactorization uses — rebuild with "
                "process.predictor(params) instead")
        x_host = np.asarray(proc._as_matrix(x_new).cpu().numpy(), dtype=settings.floatx)
        y_host = np.asarray(proc._as_vector(y_new).cpu().numpy(), dtype=settings.floatx)
        new_state = proc._posterior_state_update_pure(
            self.params, self.state, self.inputs, proc._as_matrix(x_host),
            proc._as_vector(y_host))
        proc.observed(np.concatenate([proc._inputs, x_host]),
                      np.concatenate([proc._outputs, y_host]))
        return Predictor(proc, self.params, _state=new_state)

    # ------------------------------------------------------------ pathwise
    def pathwise_sampler(self, space=None, samples=1, key=0, n_features=2048, noise=False):
        """Joint posterior draws (len(space), samples) by Matheron's
        pathwise update (Wilson et al. 2020) against this predictor's state:

          f* = m + g_prior + K_sX (K + s2 I)^{-1} (r - g_X - eps)

        with the prior paths g from random Fourier features of the signal
        kernel (SE/MAT32/MAT52/RQ on ARD_L2, sums of them, each over its
        active dims; :func:`g3py_tpu_torch.ops.rff.rff_prior_fn`), the
        update a product pair with the state's L^{-1} and one cross gram
        (K1), pushed through the warping.  A sparse (SGPR) state draws the
        inducing values from q(u) in whitened coordinates instead, eps_s =
        LB~^{-T}(cw + s xi), and f* = m + g(x*) + V_s'(eps_s - Luu^{-1} g(z)):
        O(m^2) a path, nothing n-sized.  ``key`` is a seed (draws from a
        ``torch.Generator`` on ``settings.device``: the same seed gives one
        continuous sample path however the queries are batched), a
        ``torch.Generator``, or a dict of the draws (``parts``: one
        :func:`~g3py_tpu_torch.ops.rff.draw_rff` dict per feature block;
        ``eps`` (n, samples), or for a sparse state ``xi`` (m_u, samples);
        ``noise`` (m, samples) with ``noise``)."""
        from ..hypers import hval
        from ..hypers.kernels import KernelSum, KernelNoise
        from ..ops.guards import to_num
        from ..ops.rff import _generator
        from .elliptical import STATE_OBS_LINV
        from .sparse import STATE_SGP_LBT, STATE_SGP_LUU, STATE_SGP_CW, STATE_SGP_Z, STATE_SGP_S2
        from .studentt import StudentTProcess

        self._check()
        proc, p = self.process, self._merged
        if isinstance(proc, StudentTProcess):
            raise ValueError(
                "pathwise sampling draws gaussian paths; the Student-t "
                "posterior needs the scale-mixture sampler statistic "
                "(pr.sampler / process.sampler) instead")
        xq = self._space(space)
        kn = proc.f_kernel_noise
        nv = (hval(kn.k2.var, p) if isinstance(kn, KernelSum) and isinstance(kn.k2, KernelNoise)
              else torch.zeros((), dtype=settings.dtype, device=settings.device))
        draws = key if isinstance(key, dict) else None
        gen = None if draws is not None else _generator(key)

        def normals(name, shape, like):
            if draws is not None:
                return torch.as_tensor(np.array(draws[name]), dtype=like.dtype,
                                       device=like.device)
            return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)

        sparse = STATE_SGP_LBT in self.state
        x = self.state[STATE_SGP_Z] if sparse else self.inputs
        prior = _rff_prior(proc.f_kernel, p, x, n_features, samples,
                           draws["parts"] if draws is not None else gen)
        with torch.no_grad():
            if sparse:
                # u_s ~ q(u) in whitened coordinates, eps_s = LB~^{-T}(cw + s xi)
                # (covariance s2 B~^{-1}), then f* = g(x*) + V_s'(eps_s - Luu^{-1} g(z)):
                # O(m^2 S), no n-sized work
                st = self.state
                luu, lbt, cw = st[STATE_SGP_LUU], st[STATE_SGP_LBT], st[STATE_SGP_CW]
                xi = normals("xi", (cw.shape[0], samples), cw)
                eps_s = torch.linalg.solve_triangular(
                    lbt.T, cw[:, None] + torch.sqrt(st[STATE_SGP_S2]) * xi, upper=True)
                h = eps_s - torch.linalg.solve_triangular(luu, prior(x), upper=False)
                v_s = torch.linalg.solve_triangular(luu, to_num(proc.f_kernel.cov(p, x, xq)),
                                                    upper=False)
                latent = proc.f_location(p, xq)[..., None] + prior(xq) + torch.matmul(v_s.T, h)
            else:
                resid = proc._latent_obs(p, self.outputs) - proc.f_location(p, x)
                g_x = prior(x)
                eps_std = normals("eps", g_x.shape, g_x)
                linv = self.state[STATE_OBS_LINV]
                a = torch.matmul(linv.T, torch.matmul(linv, resid[:, None] - g_x
                                                      - torch.sqrt(nv) * eps_std))
                cross = to_num(proc.f_kernel.cov(p, xq, x))
                latent = proc.f_location(p, xq)[..., None] + prior(xq) + torch.matmul(cross, a)
            if noise:
                latent = latent + torch.sqrt(nv) * normals("noise", latent.shape, latent)
            return proc.f_mapping(p, latent.reshape(-1)).reshape(latent.shape)

    # ----------------------------------------------------------- AOT export
    def export(self, path, mean=True, std=True, var=False, cov=False, median=False,
               quantiles=False, quantiles_noise=False, noise=False, prior=False, batch=None,
               platforms=("cpu", "cuda")):
        """Write this predictor as a self-contained serving artifact: the
        statistic bundle traced by ``torch.export`` (``path/bundle.pt2``,
        K1 recorded as the operator ``g3py_tpu_torch::stationary_gram``),
        the hypers, state and observed data (``path/state.npz``) and
        ``path/manifest.json`` — loadable with
        :func:`g3py_tpu_torch.serving.load_predictor` with no model code, no
        hypers and no refactorization.  ``batch=None`` traces a symbolic
        query batch (any number of points, one artifact), an int pins it.
        The bundle is traced on ``settings.device``; ``platforms`` lists the
        devices the loader may serve it on (it moves the program there).
        The statistic flags are ``predict``'s; the loaded artifact returns a
        dict with the same keys.  Raises when the bundle cannot be traced."""
        self._check()
        proc = self.process
        flags = dict(mean=mean, std=std, var=var, cov=cov, median=median, quantiles=quantiles,
                     quantiles_noise=quantiles_noise, noise=noise, prior=prior)
        keys = _bundle_keys(**flags)
        if not keys:
            raise ValueError("export needs at least one statistic flag")
        if cov and proc.th_covariance(prior=prior, noise=noise) is None:
            raise ValueError(
                f"{type(proc).__name__} has no analytic posterior covariance (warped "
                "covariances have no closed form); use samples= for an empirical covariance")
        if (quantiles or quantiles_noise) and not hasattr(proc, "_quantile_p"):
            raise ValueError(
                f"{type(proc).__name__} has no analytic latent-quantile hook (_quantile_p): "
                "exported quantiles are unavailable — export mean/std/var only")
        pair = (proc._quantile_pair(self._merged, self.inputs, prior=prior)
                if quantiles or quantiles_noise else None)
        merged = {k: v.detach().contiguous() for k, v in self._merged.items()}
        ndim = int(self.inputs.shape[1])
        m0 = 4 if batch is None else int(batch)
        space = torch.zeros((m0, ndim), dtype=settings.dtype, device=settings.device)
        vector = torch.zeros((m0,), dtype=settings.dtype, device=settings.device)
        if batch is None:
            b = torch.export.Dim("b", min=1)
            dyn = ({k: None for k in merged}, None, None, {0: b}, {0: b})
        else:
            dyn = None
        with torch.no_grad():
            program = torch.export.export(_Bundle(proc, pair, flags),
                                          (merged, self.inputs, self.outputs, space, vector),
                                          dynamic_shapes=dyn)
        os.makedirs(path, exist_ok=True)
        torch.export.save(program, os.path.join(path, "bundle.pt2"))
        flat = {"inputs": self.inputs.cpu().numpy(), "outputs": self.outputs.cpu().numpy()}
        flat.update({"merged/" + k: v.cpu().numpy() for k, v in merged.items()})
        np.savez(os.path.join(path, "state.npz"), **flat)
        with open(os.path.join(path, "manifest.json"), "w") as fh:
            json.dump({"format": 1, "process": type(proc).__name__, "statistics": keys,
                       "platforms": list(platforms), "symbolic_batch": batch is None,
                       "batch": batch, "n_obs": int(self.inputs.shape[0]), "ndim": ndim,
                       "dtype": str(np.dtype(settings.floatx)),
                       "device": torch.device(settings.device).type}, fh, indent=1)
        return path

    @host_statistic
    def predict(self, space=None, mean=True, std=True, var=False, cov=False, median=False,
                quantiles=False, quantiles_noise=False, samples=0, distribution=False,
                prior=False, noise=False, simulations=None, fused=True):
        """Statistics of one query batch (see :func:`statistics`; the
        process's space when ``space`` is None), plus ``samples`` posterior
        draws (m, samples) and, with ``distribution``, ``logpredictive``: a
        function of a vector of values at the space.  ``simulations`` and
        ``fused`` change nothing: the gaussian statistics are analytic and
        always share one cross gram."""
        self._check()
        space = self._space(space)
        values = statistics(self.process, self._merged, space, self.inputs, self.outputs,
                            mean=mean, std=std, var=var, cov=cov, median=median,
                            quantiles=quantiles, quantiles_noise=quantiles_noise,
                            noise=noise, prior=prior)
        if samples > 0:
            values["samples"] = device_statistics(self.process).sampler(
                self._merged, space, samples=samples, prior=prior, noise=noise)
        if distribution:
            values["logpredictive"] = lambda v: self.logpredictive(v, space, prior=prior)
        return values

    __call__ = predict

    @host_statistic
    def median(self, space=None, prior=False):
        """T(location) at the query points."""
        return device_statistics(self).predict(space, mean=False, std=False, median=True,
                                               prior=prior)["median"]

    @host_statistic
    def logpredictive(self, vector, space=None, prior=False):
        """Independent-marginal log predictive density of ``vector`` at the
        query points (noise included), from the factored state."""
        self._check()
        with torch.no_grad():
            return device_statistics(self.process).logpredictive(
                self._merged, self._space(space), vector=vector, prior=prior, noise=True)


def _bundle_keys(mean=True, std=True, var=False, cov=False, median=False, quantiles=False,
                 quantiles_noise=False, noise=False, prior=False):
    """The output keys of :func:`statistics` for these flags, in its order."""
    keys = [k for k, on in (("mean", mean), ("variance", var), ("std", std),
                            ("covariance", cov), ("median", median)) if on]
    if quantiles:
        keys += ["quantile_up", "quantile_down"]
    if quantiles_noise:
        keys += ["noise_std", "noise_up", "noise_down"]
    return keys


class _Bundle(torch.nn.Module):
    """The exported statistic bundle: ``(merged params + state, observed
    inputs and outputs, query space, vector) -> dict of statistics``, with
    the quantile coefficients baked in."""

    def __init__(self, process, pair, flags):
        super().__init__()
        self.process, self.pair, self.flags = process, pair, flags

    def forward(self, merged, inputs, outputs, space, vector):
        return dict(statistics(self.process, merged, space, inputs, outputs, pair=self.pair,
                               **self.flags))


def _rff_prior(kernel, p, x_like, n_features, samples, key):
    """The random-Fourier prior paths of ``kernel``: ``prior(z) ->
    (len(z), samples)``.  SE/MAT32/MAT52/RQ on ARD_L2, a DeepKernel over
    one of them, and sums of these (the spectra add: one feature block a
    part, ``max(n_features // parts, 64)`` features each).  A stationary
    part's block is drawn over its active dims only (a dims-restricted
    kernel would otherwise get frequencies on columns it ignores); a
    DeepKernel's is drawn in feature space, the queries pushed through its
    extractor.  ``key`` is a ``torch.Generator`` (the blocks drawn in
    order) or a list of draws dicts, one a block."""
    from ..hypers import hval, slice_dims
    from ..hypers.features import DeepKernel
    from ..hypers.kernels import SE, MAT32, MAT52, RQ, KernelSum
    from ..hypers.metrics import ARD_L2
    from ..ops.rff import rff_prior_fn

    nu_of = {SE: None, MAT32: 1.5, MAT52: 2.5, RQ: None}

    def check_family(k):
        if type(k) not in nu_of or type(k.metric) is not ARD_L2:
            raise ValueError(
                "pathwise sampling needs SE/MAT32/MAT52/RQ (ARD_L2) signal kernels, sums "
                "of them, or a DeepKernel over one (their spectral densities are what the "
                f"Fourier features draw from); got {type(k).__name__}")

    def flatten_sum(k):
        if isinstance(k, KernelSum):
            return flatten_sum(k.k1) + flatten_sum(k.k2)
        check_family(k.base if isinstance(k, DeepKernel) else k)
        return [k]

    parts = flatten_sum(kernel)
    f_each = max(n_features // len(parts), 64)
    priors = []
    for i, k in enumerate(parts):
        if isinstance(k, DeepKernel):
            inner, ndim = k.base, k.widths[-1]
            transform = (lambda z, kk=k: kk.features(p, z))
        else:
            inner, dims = k, k.metric.dims
            ndim = slice_dims(x_like, dims).shape[1]
            transform = (lambda z, d=dims: slice_dims(z, d))
        rq_alpha = hval(inner.alpha, p) if type(inner) is RQ else None
        part_key = key[i] if isinstance(key, (list, tuple)) else key
        fn = rff_prior_fn(part_key, ndim, f_each, hval(inner.metric.rate, p),
                          hval(inner.var, p), samples, nu=nu_of[type(inner)],
                          rq_alpha=rq_alpha)
        priors.append((fn, transform))

    def prior(z):
        out = None
        for fn, transform in priors:
            term = fn(transform(z))
            out = term if out is None else out + term
        return out

    return prior


class AveragedPredictor(_Bound):
    """Streaming Bayesian model average: one factorization PER DATATRACE
    ROW — all rows in one batched K2 call — then every query batch is
    row-batched products and an average.

    >>> ap = gp.averaged_predictor(dt)       # R factorizations, one batch
    >>> out = ap(x_query, quantiles=True)    # averaged statistics (float64)

    Memory: the stacked state is R x n_obs^2 values (capped by
    ``max_rows``; rows are subsampled evenly beyond it, matching the
    average's Monte-Carlo nature)."""

    def __init__(self, process, datatrace, max_rows=64):
        rows = (process._datatrace_rows(datatrace) if hasattr(datatrace, "columns")
                else np.asarray(datatrace, settings.floatx))
        if rows.ndim == 1:
            rows = rows[None, :]
        if len(rows) > max_rows:
            rows = rows[np.linspace(0, len(rows) - 1, max_rows).astype(int)]
        self._bind(process)
        self.rows = np.asarray(rows, settings.floatx)
        self.params, self.state_rows = process.posterior_state_rows(
            self.rows, self.inputs, self.outputs)
        self._merged = {**self.params, **self.state_rows}

    def batch(self, space=None, **flags):
        """Per-row statistics (leading row axis), like
        ``process.batch_predict``, with the factorizations reused."""
        self._check()
        return statistics(self.process, self._merged, self._space(space), self.inputs,
                          self.outputs, batch=True, **flags)

    @host_statistic
    def predict(self, space=None, scores=False, **flags):
        """Row-averaged statistics (the ``average()`` keys), in float64;
        ``scores=True`` adds ``_l1``/``_l2`` of the rows' means against the
        process's ``hidden`` when the query space is ``hidden``'s."""
        batch = self.batch(space=space, **flags)
        out = DictObj({k: v.to(torch.float64).mean(dim=0) for k, v in batch.items()})
        if scores and "mean" in batch:
            out.update(_row_scores(batch["mean"], self.process.hidden))
        return out

    __call__ = predict


class _LatentStatistics(_Bound):
    """The statistics of a gaussian-family predictor from the latent
    moments ``(mu, sd)`` of a query batch (its ``_moments``): Gauss-Hermite
    moments of the warping, quantiles ``T(mu + z_q sd)``, the median
    ``T(mu)``, and Matheron pathwise draws (:meth:`_pathwise_draws`) over a
    backend's solve and cross product.  The subclass sets ``params``,
    ``stat_params`` (the params of the warping, in ``settings.floatx``),
    ``_noise_var`` and ``_precision()``."""

    def _query(self, space):
        """Query points as a host array (the process's space when None)."""
        if space is None:
            return np.asarray(self.process._space)
        if isinstance(space, torch.Tensor):
            space = space.detach().cpu().numpy()
        space = np.asarray(space)
        return space.reshape(len(space), -1)

    def _moments_memo(self, space, noise=False, **kw):
        """``_moments`` memoized by (space, noise, options): ``predict``
        derives every statistic of a batch from one (mu, sd), so the solve
        runs once a batch, not once a statistic."""
        self._check()
        space = self._query(space)
        key = (space.tobytes(), space.shape, bool(noise), tuple(sorted(kw.items())))
        cache = self.__dict__.setdefault("_mom_cache", {})
        if key not in cache:
            if len(cache) >= 8:
                cache.pop(next(iter(cache)))
            cache[key] = self._moments(space, noise=noise, **kw)
        return cache[key]

    def _is_identity(self):
        from ..hypers.mappings import Identity
        return isinstance(self.process.f_mapping, Identity)

    def _warped(self, mu, sd):
        from ..ops.quadrature import hermite_moments

        mapping, p = self.process.f_mapping, self.stat_params
        with torch.no_grad():
            return hermite_moments(lambda v: mapping(p, v), mu, sd,
                                   settings.quadrature_degree)

    @host_statistic
    def mean(self, space=None, noise=False, **kw):
        mu, sd = self._moments_memo(space, noise=noise, **kw)
        return mu if self._is_identity() else self._warped(mu, sd)[0]

    @host_statistic
    def std(self, space=None, noise=False, **kw):
        mu, sd = self._moments_memo(space, noise=noise, **kw)
        return sd if self._is_identity() else torch.sqrt(self._warped(mu, sd)[1])

    @host_statistic
    def variance(self, space=None, noise=False, **kw):
        return device_statistics(self).std(space, noise=noise, **kw) ** 2

    @host_statistic
    def quantiler(self, space=None, q=0.975, noise=False, **kw):
        mu, sd = self._moments_memo(space, noise=noise, **kw)
        with torch.no_grad():
            return self.process.f_mapping(self.stat_params,
                                          mu + self.process._quantile_p(q) * sd)

    @host_statistic
    def median(self, space=None, **kw):
        mu, _ = self._moments_memo(space, **kw)
        with torch.no_grad():
            return self.process.f_mapping(self.stat_params, mu)

    def logpredictive(self, vector, space=None, **kw):
        """Independent-marginal log predictive density of ``vector`` at the
        query points (noise included): the latent normal density of the
        warping's pullback at (mu, sd) plus the pullback's log-Jacobian."""
        mu, sd = self._moments_memo(space, noise=True, **kw)
        mapping, p = self.process.f_mapping, self.stat_params
        with torch.no_grad():
            v = self.process._as_vector(vector)
            z = (mapping.inv(p, v) - mu) / sd
            return float((-0.5 * math.log(2.0 * math.pi) - torch.log(sd) - 0.5 * z * z).sum()
                         + mapping.logdet_dinv(p, v))

    @host_statistic
    def predict(self, space=None, mean=True, std=True, var=False, median=False,
                quantiles=False, quantiles_noise=False, noise=False, distribution=False,
                samples=0, **kw):
        """The statistics of one query batch (``exact_var`` among ``kw``),
        every one from the same latent moments."""
        dev = device_statistics(self)
        values = DictObj()
        if samples > 0:
            values["samples"] = dev.sampler(space=space, samples=samples, noise=noise)
        if distribution:
            values["logpredictive"] = (lambda v, _s=space, _kw=dict(kw):
                                       self.logpredictive(v, space=_s, **_kw))
        if mean:
            values["mean"] = dev.mean(space, noise=noise, **kw)
        if std:
            values["std"] = dev.std(space, noise=noise, **kw)
        if var:
            values["variance"] = dev.variance(space, noise=noise, **kw)
        if median:
            values["median"] = dev.median(space, **kw)
        if quantiles:
            values["quantile_up"] = dev.quantiler(space, q=0.975, noise=noise, **kw)
            values["quantile_down"] = dev.quantiler(space, q=0.025, noise=noise, **kw)
        if quantiles_noise:
            values["noise_std"] = dev.std(space, noise=True, **kw)
            values["noise_up"] = dev.quantiler(space, q=0.975, noise=True, **kw)
            values["noise_down"] = dev.quantiler(space, q=0.025, noise=True, **kw)
        return values

    __call__ = predict

    def _pathwise_draws(self, space, samples, key, n_features, noise, solve, cross_apply):
        """Matheron's pathwise update over random-Fourier prior paths of the
        signal kernel (:func:`_rff_prior`):

          f*(s) = m(s) + g(s) + K_sX a,   a = solve(resid - g(X) - s eps)

        with the backend's ``solve(rhs (n, S)) -> a`` and ``cross_apply(xq,
        a) -> K_qX a``, pushed through the warping.  ``key`` is a seed, a
        ``torch.Generator``, or a dict of the draws (``parts``, ``eps`` (n,
        samples) and, with ``noise``, ``noise`` (m, samples)), as for
        ``Predictor.pathwise_sampler``."""
        from ..ops.iterative import full_fp32
        from ..ops.rff import _generator

        self._check()
        space = self._query(space)
        proc = self.process
        draws = key if isinstance(key, dict) else None
        with self._precision(), torch.no_grad(), full_fp32():
            p, x = self.params, self.inputs
            gen = None if draws is not None else _generator(key)
            prior = _rff_prior(proc.f_kernel, p, x, n_features, samples,
                               draws["parts"] if draws is not None else gen)
            resid = proc._latent_obs(p, self.outputs) - proc.f_location(p, x)
            g_x = prior(x)  # (n, S)
            eps = (as_tensor(np.array(draws["eps"])) if draws is not None else
                   torch.randn(g_x.shape, generator=gen, dtype=g_x.dtype, device=g_x.device))
            a = solve(resid[:, None] - g_x - torch.sqrt(self._noise_var) * eps)
            xq = proc._as_matrix(space)
            latent = proc.f_location(p, xq)[:, None] + prior(xq) + cross_apply(xq, a)
            if noise:
                e = (as_tensor(np.array(draws["noise"])) if draws is not None else
                     torch.randn(latent.shape, generator=gen, dtype=latent.dtype,
                                 device=latent.device))
                latent = latent + torch.sqrt(self._noise_var) * e
            out = proc.f_mapping(p, latent.reshape(-1)).reshape(latent.shape)
        return out.to(dtype=settings.dtype, device=settings.device)


class IterativePredictor(_LatentStatistics):
    """Streaming serving for training sets too large to factor: no O(n^3)
    factorization and no n x n matrix, ever — the serving counterpart of
    ``find_MAP(engine='iterative')``.

    State (one preconditioned-CG solve and one rank-R pivoted Cholesky):

      alpha = (K + sigma^2 I)^{-1} (T^{-1}y - m)     (PCG, to ``tol``)
      L_R   = rank-R pivoted Cholesky of K           (the preconditioner)

    A query batch costs blocked cross grams:

      mean(s) = T-moment of mu* = m(s) + K_sX alpha
      var(s)  = k_ss - diag(K_sX (K + sigma^2 I)^{-1} K_Xs)

    the variance EXACT by default (``exact_var=True``: one multi-RHS PCG
    solve against the cross gram, every query point a column), or with
    ``exact_var=False`` the rank-R Woodbury sketch k_ss - diag(K_sX P^{-1}
    K_Xs), P = L_R L_R^T + sigma^2 I — a quick look only: in float32 the
    pivoted factors degrade and the sketch can read far above the noise
    floor.  Warped moments are Gauss-Hermite quadratures of T, quantiles
    ``T(mu + z_q sd)``.  ``dtype='float64'`` runs the whole solve pipeline
    (state, matvecs, cross grams) in float64, for near-interpolation grams
    beyond float32 CG's reach; statistics come back in ``settings.floatx``.
    A state whose CG residual is above 5e-2 is refused."""

    def __init__(self, process, params=None, rank=64, block=2048, cg_iters=200, tol=1e-6,
                 dtype=None):
        from ..hypers import hval
        from ..hypers.kernels import KernelSum, KernelNoise
        from ..ops.iterative import (pivoted_cholesky, pcg_solve, woodbury_preconditioner,
                                     _kernel_diag, _kernel_column, full_fp32)
        from .elliptical import _contains_kernel_noise
        from .gaussian import GaussianProcess

        if not isinstance(process, GaussianProcess):
            raise ValueError("IterativePredictor implements the gaussian posterior algebra "
                             "(GP/WGP family); the Student-t posterior needs the dense path")
        if params is None:
            params = process.params
        kn = process.f_kernel_noise
        if not (isinstance(kn, KernelSum) and isinstance(kn.k2, KernelNoise)):
            raise ValueError("IterativePredictor needs the noisy=True "
                             "KernelSum(kernel, KernelNoise) construction")
        if _contains_kernel_noise(process.f_kernel):
            raise ValueError("IterativePredictor does not support KernelNoise terms inside "
                             "the signal kernel (cross-covariances would silently drop it)")
        self.floatx = settings.floatx if dtype is None else np.dtype(dtype).name
        self.rank, self.block, self.cg_iters = rank, block, cg_iters
        self._kernel = process.f_kernel
        # the statistics' params, in settings.floatx
        self.stat_params = process._tensor_params(process.filter_params(params))
        with self._precision():
            self._bind(process)
            self.params = process._tensor_params(process.filter_params(params))
            p, x = self.params, self.inputs
            self._noise_var = hval(kn.k2.var, p)
            with torch.no_grad():
                resid = process._latent_obs(p, self.outputs) - process.f_location(p, x)
                self.l_factor = pivoted_cholesky(_kernel_column(self._kernel, p, x),
                                                 _kernel_diag(self._kernel, p, x, block), rank)
                self._p_inv = woodbury_preconditioner(self.l_factor, self._noise_var)[0]
                self.alpha = pcg_solve(self._mv, resid, self._p_inv, tol=tol,
                                       maxiter=cg_iters)
                with full_fp32():
                    rel = torch.linalg.vector_norm(self._mv(self.alpha) - resid) / torch.clamp(
                        torch.linalg.vector_norm(resid), min=1e-30)
        self.cg_rel_residual = float(rel)
        if not np.isfinite(self.cg_rel_residual) or self.cg_rel_residual > 5e-2:
            # an unconverged solve would serve garbage statistics
            raise ValueError(
                "IterativePredictor: the preconditioned CG solve did not converge (relative "
                f"residual {self.cg_rel_residual:.2e}); raise cg_iters/rank, or check the "
                "hyperparameters — an ill-conditioned gram (near-zero noise or extreme "
                "lengthscales) can exceed float32 CG's reach (dtype='float64' serves it)")

    def _precision(self):
        """``settings.floatx`` switched to the solve's dtype for the block."""
        if self.floatx == settings.floatx:
            return contextlib.nullcontext()
        return _floatx(self.floatx)

    def _mv(self, v):
        from ..ops.iterative import lazy_kernel_matvec
        return (lazy_kernel_matvec(self._kernel, self.params, self.inputs, v, block=self.block)
                + self._noise_var * v)

    def _moments(self, space, noise=False, exact_var=True, chunk=4096):
        """Latent ``(mu, sd)`` at the host query array ``space``, tensors
        in ``settings.dtype``: ``chunk`` query points a cross gram."""
        from ..ops.iterative import pcg_solve, _kernel_diag, full_fp32

        self._check()
        out_dt, out_dev = settings.dtype, settings.device
        if len(space) == 0:
            e = torch.zeros(0, dtype=out_dt, device=out_dev)
            return e, e
        proc, p, x = self.process, self.params, self.inputs
        mus, vs = [], []
        with self._precision(), torch.no_grad(), full_fp32():
            for lo in range(0, len(space), chunk):
                s = proc._as_matrix(space[lo:lo + chunk])
                cross = self._kernel.cov(p, s, x)  # (m, n)
                mu = proc.f_location(p, s) + torch.matmul(cross, self.alpha)
                kss = _kernel_diag(self._kernel, p, s, self.block)
                if exact_var:
                    z = pcg_solve(self._mv, cross, self._p_inv, maxiter=self.cg_iters)
                    var = kss - (cross * z).sum(dim=1)
                else:
                    var = kss - (cross.T * self._p_inv(cross.T)).sum(dim=0)
                mus.append(mu)
                vs.append(torch.clamp(var, min=0.0))
            var = torch.cat(vs)
            if noise:
                var = var + self._noise_var
            sd = torch.sqrt(torch.clamp(var, min=1e-30))
        return (torch.cat(mus).to(dtype=out_dt, device=out_dev),
                sd.to(dtype=out_dt, device=out_dev))

    @host_statistic
    def sampler(self, space=None, samples=1, key=0, n_features=2048, noise=False):
        """Joint posterior draws (len(space), samples) with no factorization:
        Matheron's pathwise update over random-Fourier prior paths of the
        signal kernel (:func:`_rff_prior`), the update one multi-RHS PCG
        solve for every path at once, pushed through the warping.  ``key``
        is a seed, a ``torch.Generator``, or a dict of the draws (``parts``,
        ``eps`` (n, samples) and, with ``noise``, ``noise`` (m, samples)),
        as for ``Predictor.pathwise_sampler``.  A solve whose worst relative
        residual is above 5e-2 raises."""
        from ..ops.iterative import pcg_solve

        def solve(rhs):
            a = pcg_solve(self._mv, rhs.T, self._p_inv, maxiter=self.cg_iters).T
            res = self._mv(a) - rhs
            rel = float((torch.linalg.vector_norm(res, dim=0) / torch.clamp(
                torch.linalg.vector_norm(rhs, dim=0), min=1e-30)).max())
            if not np.isfinite(rel) or rel > 5e-2:
                raise ValueError(
                    "pathwise sampler: the multi-RHS PCG solve did not converge (worst relative "
                    f"residual {rel:.2e}); raise cg_iters (path right-hand sides carry white-"
                    "noise components that need more iterations than the data solve) or rank")
            return a

        def cross_apply(xq, a):
            return torch.cat([torch.matmul(self._kernel.cov(self.params, xq[lo:lo + 4096],
                                                            self.inputs), a)
                              for lo in range(0, xq.shape[0], 4096)])

        return self._pathwise_draws(space, samples, key, n_features, noise, solve, cross_apply)


class DistributedPredictor(_LatentStatistics):
    """Band-sharded serving for a model trained with
    ``find_MAP(engine='distributed')``: the observed gram is factored ONCE
    by the band Cholesky and stays split over the mesh's ranks (each holds
    its (n/D, n) band of L and of alpha); a query batch costs each rank its
    (n/D, m) cross band, a band solve and two psums
    (:func:`~g3py_tpu_torch.parallel.cholesky.distributed_posterior`).
    Neither the n x n gram nor the n x m cross matrix exists whole on a
    rank.  Every rank calls it with the same queries and gets the same
    statistics (the gaussian family's, from the latent moments); the
    pathwise ``sampler`` solves exactly with two band solves and applies the
    cross gram band-wise."""

    def __init__(self, process, params=None, mesh=None, block=None, axis="dp"):
        from ..parallel.cholesky import distributed_posterior
        from .gaussian import GaussianProcess

        if not isinstance(process, GaussianProcess):
            raise ValueError("DistributedPredictor implements the gaussian posterior algebra "
                             "(GP/WGP family)")
        if params is None:
            params = process.params
        self.mesh, self._cov_fn, noise_fn = process._distributed_parts(
            mesh, axis, what="DistributedPredictor")
        self._bind(process)
        self.params = self.stat_params = process._tensor_params(process.filter_params(params))
        state_fn, self._query_fn, self._solve_fn, self._apply_fn = distributed_posterior(
            self._cov_fn, mesh=self.mesh, block=block, axis=axis, noise_fn=noise_fn)
        p, x = self.params, self.inputs
        with torch.no_grad():
            self._noise_var = noise_fn(p)
            resid = process._latent_obs(p, self.outputs) - process.f_location(p, x)
            self.l_band, self.alpha_band = state_fn(p, x, resid)

    def _precision(self):
        return contextlib.nullcontext()

    def _moments(self, space, noise=False, chunk=4096):
        """Latent ``(mu, sd)`` at the host query array ``space``: ``chunk``
        query points a band query."""
        from ..ops.iterative import _kernel_diag

        self._check()
        if len(space) == 0:
            e = torch.zeros(0, dtype=settings.dtype, device=settings.device)
            return e, e
        proc, p, x = self.process, self.params, self.inputs
        mus, vs = [], []
        with torch.no_grad():
            for lo in range(0, len(space), chunk):
                s = proc._as_matrix(space[lo:lo + chunk])
                md, vr = self._query_fn(p, x, self.l_band, self.alpha_band, s)
                mus.append(proc.f_location(p, s) + md)
                vs.append(torch.clamp(_kernel_diag(proc.f_kernel, p, s, chunk) - vr, min=0.0))
            var = torch.cat(vs)
            if noise:
                var = var + self._noise_var
        return torch.cat(mus), torch.sqrt(torch.clamp(var, min=1e-30))

    @host_statistic
    def sampler(self, space=None, samples=1, key=0, n_features=2048, noise=False):
        """Joint posterior draws (len(space), samples) with the gram still
        band-sharded: Matheron's pathwise update (:meth:`_pathwise_draws`,
        ``key`` as there) with the exact solve (two band solves) and the
        band cross product."""
        return self._pathwise_draws(
            space, samples, key, n_features, noise,
            solve=lambda rhs: self._solve_fn(self.l_band, rhs),
            cross_apply=lambda xq, a: torch.cat([
                self._apply_fn(self.params, self.inputs, xq[lo:lo + 4096], a)
                for lo in range(0, xq.shape[0], 4096)]))


@contextlib.contextmanager
def _floatx(name):
    old = settings.floatx
    settings.floatx = name
    try:
        yield
    finally:
        settings.floatx = old
