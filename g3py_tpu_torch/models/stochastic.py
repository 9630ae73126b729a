"""StochasticProcess — the abstract model behind every process family (the
PyTorch counterpart of :mod:`g3py_tpu.models.stochastic`, subset).

Observed data lives on the host as numpy arrays in ``settings.floatx``
(``set_space`` / ``observed``); device copies on ``settings.device`` are
made once per data change and reused.  Every statistic is a ``th_*``
builder returning a function ``fn(params, space, inputs, outputs, vector)``
of tensors — PyTorch runs eagerly, so the builders are called directly
instead of being jitted.  The ``th_*`` functions compute on tensors on
``settings.device``; the public statistics (``predict``, ``mean``, ...)
return host numpy arrays to their caller
(:func:`~g3py_tpu_torch.config.host_statistic`; each family decorates its
overrides), and
``logp`` returns a Python float.

This port carries construction, data (``space``/``hidden``/``order`` for
prediction and scoring, ``inputs``/``outputs``/``index`` for
observations), params, ``logp`` / ``loglike`` (over a params dict or the
flat unconstrained vector), ``dlogp`` (autograd over that vector on the
device), ``find_MAP`` with the reference's scipy BFGS/Powell recipe on the
marginal likelihood or the leave-one-out objective, ``predict`` and the
statistic methods, and the hyperparameter posterior: ``logp_chain`` over
(R, ndim) rows and ``sample_hypers(method='ensemble')``, plain or
parallel-tempered, into a datatrace.  The rows of a batched call are an
explicit leading axis (the JAX package's ``vmap``): one batched K1 and one
batched K2 call a logp evaluation of all rows.  ``fix_vars`` pins dims to a
chain's rows: the ``fixed_*`` logps (and ``dlogp``, through the batched
analytic backward) are one batched evaluation over those rows, used by
``find_MAP`` and ``sample_hypers``; ``sample_hypers(reparam='noncentered')``
samples the amplitude hypers relative to the data scale.  The gradient
samplers (``sample_hypers(method='nuts' | 'neutra' | 'advi')``) and
``find_MAP(engine='jax')`` differentiate the batched sampling log densities
with torch autograd: a batched value-and-gradient evaluation of all chains,
MC rows or starts is one batched K1 and K2 call and one batched analytic
backward.  ``find_MAP(engine='iterative')`` (GP family) trains through the
matrix-free NLL, ``find_MAP(engine='distributed')`` (GP and Student-t
families) through the band-sharded exact NLL over the ranks of a
``torch.distributed`` mesh.  ``file=`` loads the process saved there (or
saves a new one), device-agnostically.
"""

import os
import pickle

import numpy as np
import torch

from ..config import settings, asarray_x, as_tensor, host_statistic, device_statistics
from ..utils import DictObj, save_datatrace, load_datatrace, save_pkl, load_pkl
from ..ops.guards import to_num
from ..bayesian.registry import GraphicalModel
from ..bayesian.selection import optimize
from ..bayesian.models import BatchedModel
from ..bayesian.samplers import mcmc_ensemble
from ..bayesian.nuts import nuts_sampler
from ..bayesian.neutra import neutra_nuts
from ..bayesian.advi import fit_advi, advi_draws
from ..bayesian.optimize_jax import lbfgs_maximize
from ..bayesian.average import chains_to_datatrace, plot_datatrace

__all__ = ["StochasticProcess"]


def _prep_matrix(x):
    x = asarray_x(np.asarray(x))
    if x.ndim < 2:
        x = x.reshape(len(x), 1)
    return x


def _prep_vector(y):
    y = asarray_x(np.asarray(y))
    if y.ndim > 1:
        y = y.reshape(len(y))
    return y


def _map_rows(fn, arr):
    """``fn`` (a map of (R, ndim) tensors) over the last axis of a host
    array of any leading shape; host array in ``settings.floatx``."""
    arr = np.asarray(arr, dtype=settings.floatx)
    with torch.no_grad():
        out = fn(as_tensor(arr.reshape(-1, arr.shape[-1])))
    return out.cpu().numpy().reshape(arr.shape).astype(settings.floatx)


def _statistic(th_name, doc):
    """A public statistic method evaluating ``th_name`` (the JAX package
    binds the same methods at construction); extra keywords go to the
    ``th_*`` builder."""

    def method(self, params=None, space=None, inputs=None, outputs=None,
               vector=None, prior=False, noise=False, array=False, **kwargs):
        return self._call_method(th_name, params=params, space=space, inputs=inputs,
                                 outputs=outputs, vector=vector, prior=prior,
                                 noise=noise, array=array, **kwargs)

    method.__name__ = th_name[3:]
    method.__doc__ = doc
    return host_statistic(method)


class _RowsLogp(torch.autograd.Function):
    """A batched log density of (..., ndim) rows whose forward is one
    value-and-gradient evaluation ``value_and_grad(u) -> (value, grad)``
    and whose backward scales the saved gradients by the cotangent: autograd
    through it (a shear, a flow, an ELBO) costs no second evaluation."""

    @staticmethod
    def forward(ctx, u, value_and_grad):
        value, grad = value_and_grad(u.detach())
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[..., None] * grad, None


def _differentiable(value, value_and_grad):
    """A batched log density: ``value(u)`` on rows that need no gradient,
    :class:`_RowsLogp` over ``value_and_grad`` on rows that require grad
    under grad mode."""

    def f(u):
        if torch.is_grad_enabled() and u.requires_grad:
            return _RowsLogp.apply(u, value_and_grad)
        return value(u)

    return f


class StochasticProcess(BatchedModel):
    """Abstract stochastic-process model (see module docstring).

    ``active`` is the :class:`GraphicalModel` to join; True joins the
    active registry (``GraphicalModel.active``, created when None); False
    (or None) makes a fresh one named ``"GM_" + name``, which becomes the
    active one.  ``precompile`` and ``compile_logp`` are the JAX package's
    compile controls and change nothing here (PyTorch runs eagerly):
    ``compiles`` stays an empty dict.  ``distribution`` is kept as given,
    until the family's ``th_define_process`` names its own."""

    #: whether th_loglike_fn takes a params dict of R rows (the GP and
    #: Student-t families); the others evaluate a (R, ndim) matrix row by row
    _batched_rows = True
    #: whether the statistics are Monte-Carlo over draws (``predict`` then
    #: draws once for all of them)
    _mc_moments = False

    def __init__(self, space=None, order=None, inputs=None, outputs=None, hidden=None,
                 index=None, name="SP", distribution=None, active=False, precompile=False,
                 file=None, load=True, compile_logp=True):
        if file is not None and load:  # load-or-create: an existing file wins
            try:
                loaded = load_pkl(file)
            except (OSError, EOFError, pickle.UnpicklingError, AttributeError, TypeError):
                print("Model Not Found in " + str(file))
            else:
                self.__dict__.update(loaded.__dict__)
                print("Loaded model " + file)
                self.set_space(space=space, hidden=hidden, order=order, inputs=inputs,
                               outputs=outputs, index=index)
                return
        ndim = 1
        if space is not None:
            if hasattr(space, "shape"):
                if len(space.shape) > 1:
                    ndim = space.shape[1]
            else:
                ndim = int(space)
        self.nspace = ndim
        self.name = name
        self.description = {"title": name, "x": "x", "y": "y"}
        self.distribution = distribution
        self.precompile = precompile
        self.compiles = DictObj()

        default_mat = np.array([[0.0, 1.0]] * self.nspace, dtype=settings.floatx).T
        self._space = default_mat.copy()
        self._inputs = default_mat.copy()
        self._outputs = np.array([0.0, 1.0], dtype=settings.floatx)
        self._order = self._outputs.copy()
        self._index = self._outputs.copy()
        self.np_hidden = None
        self.is_observed = False
        self._device_copies = {}

        if active is True:
            active = GraphicalModel.active or GraphicalModel("GM_" + self.name)
        self.active = active if active else GraphicalModel("GM_" + self.name)
        self.active.add_component(self)

        self._check_hypers()
        self._register_params()
        self.th_define_process()
        self.set_space(space=space, hidden=hidden, order=order, inputs=inputs,
                       outputs=outputs, index=index)
        if file is not None:
            self.file = file
            self.save()

    # ------------------------------------------------------------- persistence
    def save(self, path=None, params=None):
        """Pickle the process (its registry and data) to ``path`` (the
        constructor's ``file`` by default), after ``set_params(params)``
        when given; tensors are stored device-agnostically (a file saved on
        the card loads on the CPU, and the reverse).  An error is printed,
        not raised, as in the JAX package."""
        if path is None:
            path = self.file
        if params is not None:
            self.set_params(params)
        try:
            if os.path.isfile(path):
                os.remove(path)
            save_pkl(self, path)
            print("Model saved on " + path)
        except (OSError, pickle.PicklingError, TypeError, AttributeError) as details:
            print("Error saving model " + str(path), details)

    def __getstate__(self):
        """Pickled state: the device copies of the data (rebuilt on use) and
        the cluster labeler (a closure) are left out, tensors go to the
        CPU."""
        from ..bayesian.registry import _to_cpu

        state = self.__dict__.copy()
        state["_device_copies"] = {}
        state.pop("_cluster", None)
        return _to_cpu(state)

    # ------------------------------------------------------------------ hooks
    def _components(self):
        """Hypers-bearing components of this process (subclass hook)."""
        return []

    def _check_hypers(self):
        pass

    def th_define_process(self):
        """Family hook run at construction (names ``distribution``)."""

    def default_hypers(self):
        return {}

    def _register_params(self):
        for comp in self._components():
            for p in comp.hypers:
                self.active.register_param(p)
            if comp.has_potential():
                self.active.register_potential(f"{self.name}_{comp.name}_potential",
                                               comp.potential_logp)

    # ----------------------------------------------------------------- params
    def set_params(self, params=None):
        return self.active.set_params(params)

    def params_random(self, *args, **kwargs):
        return self.active.params_random(*args, **kwargs)

    def params_datatrace(self, *args, **kwargs):
        return self.active.params_datatrace(*args, **kwargs)

    def transform_params(self, *args, **kwargs):
        return self.active.transform_params(*args, **kwargs)

    def params_process(self, process=None, params=None, current=None, fixed=False):
        """Another process's params mapped onto this one by name prefix: the
        keys of ``params`` (``process.params`` by default) with
        ``process.name`` replaced by this process's name, where ``current``
        (this process's params by default) has them, and ``current``'s
        values for the rest."""
        if process is None:
            process = self
        if params is None:
            params = process.params
        if current is None:
            current = self.params
        renamed = {k.replace(process.name, self.name, 1): v for k, v in params.items()}
        out = DictObj({k: v for k, v in renamed.items() if k in current})
        out.update({k: v for k, v in current.items() if k not in renamed})
        return out

    @property
    def model(self):
        return self.active

    @property
    def params(self):
        return self.active.params

    @property
    def params_default(self):
        return self.active.params_default

    @property
    def params_test(self):
        return self.active.params_test

    @property
    def ndim(self):
        return self.active.ndim

    @property
    def transformations(self):
        return self.active.original_to_transformed_names

    @property
    def potentials(self):
        return self.active.potentials

    def filter_params(self, params):
        return DictObj({p.name: params[p.name] for p in self.active.ordered_params
                        if p.name in params})

    def _tensor_params(self, params):
        """This process's hypers as tensors on ``settings.device``; reserved
        ``_state_*`` keys (a precomputed posterior factorization) pass
        through untouched."""
        out = {k: as_tensor(v) for k, v in self.filter_params(params).items()}
        out.update({k: v for k, v in params.items()
                    if isinstance(k, str) and k.startswith("_state_")})
        return out

    # ------------------------------------------------------------------- data
    def set_space(self, space=None, hidden=None, order=None, inputs=None, outputs=None,
                  index=None):
        """Assign domain/data arrays (host numpy in ``settings.floatx``), in
        the JAX package's argument order: the prediction ``space``, its true
        values ``hidden`` (what ``scores`` compares with) and plotting
        ``order``; the observed ``inputs``/``outputs`` and their ``index``.
        A 1-D space (inputs) is its own order (index); otherwise they
        default to 0, 1, ..."""
        if space is not None:
            self._space = _prep_matrix(space)
        if hidden is not None:
            self.hidden = _prep_vector(hidden)
        if order is not None:
            self._order = _prep_vector(order)
        elif self.nspace == 1 and space is not None:
            self._order = self._space.reshape(len(self._space))
        if inputs is not None:
            self._inputs = _prep_matrix(inputs)
        if outputs is not None:
            self._outputs = _prep_vector(outputs)
        if index is not None:
            self._index = _prep_vector(index)
        elif self.nspace == 1 and inputs is not None:
            self._index = self._inputs.reshape(len(self._inputs))
        if len(self._order) != len(self._space):
            self._order = np.arange(len(self._space), dtype=settings.floatx)
        if len(self._index) != len(self._inputs):
            self._index = np.arange(len(self._inputs), dtype=settings.floatx)

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        """Assign observations; computes nothing until asked."""
        self.set_space(inputs=inputs, outputs=outputs, order=order, index=index,
                       hidden=hidden)
        self.is_observed = not (inputs is None and outputs is None)

    @property
    def space(self):
        return self._space

    @space.setter
    def space(self, value):
        self.set_space(space=value)

    @property
    def hidden(self):
        return self.np_hidden

    @hidden.setter
    def hidden(self, value):
        self.np_hidden = value

    @property
    def inputs(self):
        return self._inputs

    @inputs.setter
    def inputs(self, value):
        self.set_space(inputs=value)

    @property
    def outputs(self):
        return self._outputs

    @outputs.setter
    def outputs(self, value):
        self.set_space(outputs=value)

    @property
    def order(self):
        return self._order

    @order.setter
    def order(self, value):
        self._order = _prep_vector(value)

    @property
    def index(self):
        return self._index

    @index.setter
    def index(self, value):
        self._index = _prep_vector(value)

    def _device_data(self, name):
        """Device copy of ``self._<name>``, made once per data change."""
        arr = getattr(self, "_" + name)
        key = (name, settings.device, settings.floatx)
        hit = self._device_copies.get(key)
        if hit is None or hit[0] is not arr:
            hit = (arr, as_tensor(arr))
            self._device_copies[key] = hit
        return hit[1]

    @staticmethod
    def _as_matrix(x):
        if isinstance(x, torch.Tensor):
            x = x.to(dtype=settings.dtype, device=settings.device)
            return x.reshape(-1, 1) if x.ndim < 2 else x
        return as_tensor(_prep_matrix(x))

    @staticmethod
    def _as_vector(y):
        if isinstance(y, torch.Tensor):
            return y.to(dtype=settings.dtype, device=settings.device).reshape(-1)
        return as_tensor(_prep_vector(y))

    def _resolve_data(self, space, inputs, outputs):
        space = self._device_data("space") if space is None else self._as_matrix(space)
        inputs = self._device_data("inputs") if inputs is None else self._as_matrix(inputs)
        outputs = self._device_data("outputs") if outputs is None else self._as_vector(outputs)
        return space, inputs, outputs

    # ---------------------------------------------------------------- th_* API
    # Each th_* returns fn(params, space, inputs, outputs, vector) -> tensor,
    # or None when the quantity is undefined for the class.

    def th_median(self, prior=False, noise=False, simulations=None):
        return None

    def th_mean(self, prior=False, noise=False, simulations=None):
        return None

    def th_variance(self, prior=False, noise=False, simulations=None):
        return None

    def th_covariance(self, prior=False, noise=False):
        return None

    def th_logpredictive(self, prior=False, noise=False):
        return None

    def th_cross_mean(self, prior=False, noise=False, cross_kernel=None):
        return None

    def th_std(self, *args, **kwargs):
        var_fn = self.th_variance(*args, **kwargs)
        if var_fn is None:
            return None

        def fn(params, space, inputs, outputs, vector):
            return torch.sqrt(var_fn(params, space, inputs, outputs, vector))

        return fn

    def th_loglike_fn(self):
        """Observed-data loglikelihood ``fn(params, space, inputs, outputs)``
        of THIS process (subclass hook)."""
        return None

    def th_error_l1(self, prior=False, noise=False):
        """Mean absolute error of the process mean against ``vector`` (one
        a row for a params dict of rows that carries their posterior
        states)."""
        mean_fn = self.th_mean(prior=prior, noise=noise)
        if mean_fn is None:
            return None

        def fn(params, space, inputs, outputs, vector):
            return torch.mean(torch.abs(vector - mean_fn(params, space, inputs, outputs, vector)),
                              dim=-1)

        return fn

    def th_error_l2(self, prior=False, noise=False):
        """Mean squared error of the process mean against ``vector``."""
        mean_fn = self.th_mean(prior=prior, noise=noise)
        if mean_fn is None:
            return None

        def fn(params, space, inputs, outputs, vector):
            return torch.mean((vector - mean_fn(params, space, inputs, outputs, vector)) ** 2,
                              dim=-1)

        return fn

    def th_error_mse(self, prior=False, noise=False):
        """mean(a)^2 + var(a) of a = |vector - outputs| (the reference's
        ``mse``)."""
        def fn(params, space, inputs, outputs, vector):
            a = torch.abs(vector - outputs)
            return torch.mean(a, dim=-1) ** 2 + torch.var(a, dim=-1, unbiased=False)

        return fn

    def _call_method(self, th_name, params=None, space=None, inputs=None,
                     outputs=None, vector=None, prior=False, noise=False, array=False,
                     **kwargs):
        """Evaluate the statistic ``th_name`` at ``params`` (a params dict,
        or with ``array`` the flat unconstrained vector) on ``space``."""
        if array:
            reg = self.active
            params = reg.array_to_dict_tensor(as_tensor(np.asarray(
                reg.dict_to_array(self.params) if params is None else params)))
        else:
            params = self._tensor_params(self.params if params is None else params)
        if inputs is None and not self.is_observed:
            prior = True
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        if vector is None:
            vector = torch.zeros(space.shape[0], dtype=settings.dtype, device=space.device)
        else:
            vector = self._as_vector(vector)
        fn = getattr(self, th_name)(prior=prior, noise=noise, **kwargs)
        if fn is None:
            raise NotImplementedError(f"{type(self).__name__} has no {th_name[3:]}")
        return fn(params, space, inputs, outputs, vector)

    mean = _statistic("th_mean", "Mean of the (warped) process.")
    median = _statistic("th_median", "Median of the (warped) process.")
    variance = _statistic("th_variance", "Marginal variance of the (warped) process.")
    std = _statistic("th_std", "Marginal standard deviation of the (warped) process.")
    covariance = _statistic("th_covariance", "Covariance of the process over ``space``.")
    logpredictive = _statistic(
        "th_logpredictive", "Log predictive density of ``vector`` at ``space`` "
        "(independent marginals).")
    cross_mean = _statistic("th_cross_mean", "Posterior mean at ``space`` through "
                            "``cross_kernel`` (the process's own kernel by default).")
    error_l1 = _statistic("th_error_l1", "Mean absolute error of the mean against ``vector``.")
    error_l2 = _statistic("th_error_l2", "Mean squared error of the mean against ``vector``.")
    error_mse = _statistic("th_error_mse", "mean(a)^2 + var(a), a = |vector - outputs|.")

    # ----------------------------------------------------------------- logp
    def _logp_pure(self, prior=False, like_only=False):
        """logp over natural-space params dicts: prior terms + potentials
        (+ every component's observed loglike unless ``prior``); with
        ``like_only`` the loglikes alone."""
        reg = self.active
        like_fns = []
        if not prior:
            for comp in reg.components.values():
                fn = comp.th_loglike_fn()
                if fn is not None:
                    like_fns.append((fn, comp))

        def fn(params, space, inputs, outputs):
            if like_only:
                total = torch.zeros((), dtype=settings.dtype, device=settings.device)
            else:
                total = reg.logp_prior_dict(params) + reg.logp_potentials(params)
            for like_fn, comp in like_fns:
                if comp is self:
                    total = total + like_fn(params, space, inputs, outputs)
                else:  # another process of the graphical model: its own data
                    total = total + like_fn(params, *comp._resolve_data(None, None, None))
            return total

        return fn

    def _eval_params(self, params, array):
        """Natural-space dict of device tensors from a params dict, or from
        the flat unconstrained vector when ``array``."""
        reg = self.active
        if params is None:
            params = reg.dict_to_array(self.params) if array else self.params
        if array:
            return reg.array_to_dict_tensor(as_tensor(np.asarray(params)))
        return {k: as_tensor(v) for k, v in params.items()}

    def logp(self, params=None, space=None, inputs=None, outputs=None, prior=False,
             array=False, **kwargs):
        """Posterior (or, with ``prior``, prior) log density at ``params`` —
        a natural-space dict, or with ``array`` the flat unconstrained
        vector."""
        p = self._eval_params(params, array)
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        with torch.no_grad():
            return float(self._logp_pure(prior=prior)(p, space, inputs, outputs))

    def loglike(self, params=None, space=None, inputs=None, outputs=None, array=False,
                **kwargs):
        """Observed-data loglikelihood of every process of the graphical
        model (no prior terms or potentials)."""
        p = self._eval_params(params, array)
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        with torch.no_grad():
            return float(self._logp_pure(like_only=True)(p, space, inputs, outputs))

    def dlogp(self, params=None, space=None, inputs=None, outputs=None, prior=False,
              array=True, **kwargs):
        """Gradient of logp with respect to the flat unconstrained vector
        (host float array in ``settings.floatx``): autograd on the device
        through the analytic ``mvn_quad_logdet`` backward, NaN/Inf guarded
        by ``to_num``."""
        if params is None:
            params = self.params
        return self._array_grad(self._logp_pure(prior=prior), params, space, inputs, outputs)

    def _array_grad(self, pure, params, space=None, inputs=None, outputs=None):
        """Gradient of ``pure(params dict, space, inputs, outputs)`` with
        respect to the flat unconstrained vector of ``params`` (a dict or
        that vector; or a (R, ndim) matrix of rows, each row's gradient of
        its own value), on the host in ``settings.floatx``."""
        if isinstance(params, dict):
            params = self.active.dict_to_array(params)
        u = as_tensor(params if isinstance(params, torch.Tensor) else np.asarray(params))
        _, grad = self._value_and_grad(pure, u, space, inputs, outputs)
        return grad.cpu().numpy()

    def _value_and_grad(self, pure, u, space=None, inputs=None, outputs=None):
        """``pure``'s value at the unconstrained rows ``u`` ((ndim,) or (R,
        ndim) tensor) and its gradient with respect to each row, both on the
        device: one (batched) forward and one backward through the batched
        analytic ``mvn_quad_logdet``; NaN/Inf gradients guarded by
        ``to_num`` (a failed row's gradient is 0).  One row at a time for a
        family without a row axis (``_batched_rows``)."""
        if not self._batched_rows and u.ndim == 2:
            pairs = [self._value_and_grad(pure, row, space, inputs, outputs) for row in u]
            return torch.stack([v for v, _ in pairs]), torch.stack([g for _, g in pairs])
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        u = u.detach().requires_grad_(True)
        with torch.enable_grad():
            total = pure(self.active.array_to_dict_tensor(u), space, inputs, outputs)
            if total.requires_grad:
                (grad,) = torch.autograd.grad(total.sum(), u)
            else:
                grad = torch.zeros_like(u)
        return total.detach().expand(u.shape[:-1]), to_num(grad)

    def _rows_value_and_grad(self, u, prior=False, like_only=False):
        """logp (prior / loglike) of each row of a (R, ndim) tensor of
        unconstrained rows and its gradient with respect to its own row:
        ``(R,)`` and ``(R, ndim)`` tensors on the device, from one batched
        forward and one backward (the JAX package's ``vmap`` of
        ``value_and_grad``)."""
        return self._value_and_grad(self._logp_pure(prior=prior, like_only=like_only),
                                    as_tensor(u))

    def _logp_rows(self, u, prior=False, like_only=False):
        """logp (prior / loglike) of a (R, ndim) tensor of unconstrained
        rows: a (R,) tensor, every row's gram in one batched call (one row
        at a time for a family without a row axis, ``_batched_rows``)."""
        if not self._batched_rows and u.ndim == 2:
            return torch.stack([self._logp_rows(row, prior=prior, like_only=like_only)
                                for row in u])
        space, inputs, outputs = self._resolve_data(None, None, None)
        with torch.no_grad():
            out = self._logp_pure(prior=prior, like_only=like_only)(
                self.active.array_to_dict_tensor(u), space, inputs, outputs)
        return out.expand(u.shape[:-1])

    def logp_chain(self, chain, prior=False):
        """logp of every row of an (R, ndim) matrix of unconstrained rows
        (host array, ``settings.floatx``), from one batched evaluation (the
        JAX package ``vmap``-s the rows)."""
        u = as_tensor(np.asarray(chain, dtype=settings.floatx))
        return self._logp_rows(u, prior=prior).cpu().numpy()

    def _rows_grad(self, u, prior=False, like_only=False):
        """Gradient of the logp (prior / loglike) of each row of a (R,
        ndim) tensor of unconstrained rows with respect to its own row,
        (R, ndim) on the host (:meth:`_rows_value_and_grad`)."""
        return self._rows_value_and_grad(u, prior=prior, like_only=like_only)[1].cpu().numpy()

    # ------------------------------------------------ fixed (marginalized)
    def _fixed_eval(self, kind, sampling_params, return_array):
        """``kind`` (logp, dlogp, loglike, logprior) at ``sampling_params``
        for every row of the fixed chain, from one batched evaluation: the
        row values (``return_array``) or their mean."""
        reg = self.active
        chain = reg.fixed_chain.copy()
        chain[:, reg.sampling_dims] = np.asarray(sampling_params, dtype=settings.floatx)
        u = as_tensor(chain)
        flags = dict(prior=kind == "logprior", like_only=kind == "loglike")
        if kind == "dlogp":
            r = self._rows_grad(u)[:, reg.sampling_dims]
        else:
            r = self._logp_rows(u, **flags).cpu().numpy()
        if return_array:
            return r
        return np.mean(r, axis=0)

    def fixed_logp(self, sampling_params, return_array=False):
        """Posterior logp at the sampling dims ``sampling_params``, averaged
        over the rows of the chain that ``fix_vars`` pinned (the
        Rao-Blackwellized logp); ``return_array`` gives every row's."""
        return self._fixed_eval("logp", sampling_params, return_array)

    def fixed_dlogp(self, sampling_params, return_array=False):
        """Gradient of :meth:`fixed_logp` over the sampling dims."""
        return self._fixed_eval("dlogp", sampling_params, return_array)

    def fixed_loglike(self, sampling_params, return_array=False):
        return self._fixed_eval("loglike", sampling_params, return_array)

    def fixed_logprior(self, sampling_params, return_array=False):
        return self._fixed_eval("logprior", sampling_params, return_array)

    def _sampling_logps(self, prior=False, tempered=False):
        """Batched (logp | loglike, logprior) of (R, nsampling) rows over
        the sampling dims; under ``fix_vars`` each row's value is the mean
        over the fixed chain's C rows, all R x C rows in one batched
        evaluation.  Each is differentiable by torch autograd: called on
        rows that require grad under grad mode it makes one batched
        value-and-gradient evaluation (:meth:`_rows_value_and_grad`; under
        ``fix_vars`` the gradient is the mean of the C rows' gradients at
        the sampling dims), so a gradient sampler's ``backward`` costs no
        second evaluation; otherwise one value-only evaluation."""
        reg = self.active
        if reg.fixed_datatrace is None:
            def mk(flags):
                return _differentiable(lambda u: self._logp_rows(u, **flags),
                                       lambda u: self._rows_value_and_grad(u, **flags))
        else:
            chain = as_tensor(reg.fixed_chain)
            dims = torch.as_tensor(reg.sampling_dims, device=chain.device)

            def rows(flat):  # (R, nsampling) -> (R * C, ndim)
                out = chain.expand((flat.shape[0],) + chain.shape).clone()
                out[:, :, dims] = flat[:, None, :].to(chain.dtype)
                return out.reshape(-1, chain.shape[-1])

            def mk(flags):
                def value(u):
                    flat = u.reshape(-1, u.shape[-1])
                    vals = self._logp_rows(rows(flat), **flags)
                    return vals.reshape(flat.shape[0], -1).mean(dim=-1).reshape(u.shape[:-1])

                def value_and_grad(u):
                    flat = u.reshape(-1, u.shape[-1])
                    vals, grads = self._rows_value_and_grad(rows(flat), **flags)
                    vals = vals.reshape(flat.shape[0], -1).mean(dim=-1)
                    grads = grads.reshape(flat.shape[0], chain.shape[0], -1)[:, :, dims]
                    return vals.reshape(u.shape[:-1]), grads.mean(dim=1).reshape(u.shape)

                return _differentiable(value, value_and_grad)

        logp = mk(dict(prior=prior))
        logprior = mk(dict(prior=True))
        like = mk(dict(like_only=True))

        def loglike(u):
            if prior:
                return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
            return like(u)

        if not tempered:
            return logp, None, None
        return None, loglike, logprior

    def _noncentered_sampling_shear(self):
        """``(shear, unshear)`` of the non-centered reparameterization over
        the sampling-dims vector, or None when it does not apply (the
        elliptical families override it)."""
        return None

    def sample_hypers(self, start=None, samples=1000, chains=None, ntemps=None,
                      raw=False, noise_mult=0.1, noise_sum=0.01, burnin_tol=0.001,
                      burnin_method="multi-sum", outlayer_percentile=0.0005,
                      clusters=None, prior=False, parallel=False, threads=1,
                      plot=False, file=None, load=True, seed=0, method="ensemble",
                      nuts_warmup=200, max_depth=8, target_accept=0.8,
                      nuts_mass="diag", nuts_chunk=25, neutra_warmup=500,
                      advi_steps=2000, advi_mc=8, advi_lr=0.02,
                      advi_full_rank=True, reparam=None):
        """MCMC over the hyperparameter posterior.  ``method='ensemble'``
        (default) is the affine-invariant ensemble sampler (parallel-tempered
        when ``ntemps``): ``chains`` walkers (default 2 ndim) jittered around
        ``start`` (default: the ``find_MAP`` point), ``samples``
        iterations, every half-ensemble's logp one batched evaluation on the
        device.  ``method='nuts'`` runs the No-U-Turn sampler
        (:func:`~g3py_tpu_torch.bayesian.nuts.nuts_sampler`: ``chains``
        chains from the start jittered by ``noise_mult``, ``nuts_warmup``
        warmup iterations, ``max_depth``, ``target_accept``,
        ``nuts_mass`` 'diag' or 'dense'), every chain's leaf one batched
        value-and-gradient evaluation; ``nuts_chunk`` is accepted and
        changes nothing.  ``method='neutra'`` runs NUTS through a transport
        fitted to the second half of ``neutra_warmup`` ensemble iterations
        (:func:`~g3py_tpu_torch.bayesian.neutra.neutra_nuts`).
        ``method='advi'`` fits a Gaussian variational approximation
        (``advi_steps``, ``advi_mc``, ``advi_lr``, ``advi_full_rank``) and
        fills the chain with iid draws from it.  Returns a
        :class:`~g3py_tpu_torch.utils.datatrace.Datatrace` (burn-in from the
        Gelman-Rubin bisection at ``burnin_tol``, outliers at
        ``outlayer_percentile``, ``clusters`` mixture components labelled
        by :func:`~g3py_tpu_torch.bayesian.average.cluster_datatrace`), or
        with ``raw`` the ``(chain, lnprob)`` arrays.  With ``file`` (an
        ``.npz`` path) the datatrace is written there, and with ``load`` a
        datatrace already there of ``chains`` x ``samples`` rows is
        returned instead of sampling.  ``parallel`` and ``threads`` are
        accepted and change nothing (the walkers of a half-ensemble, and
        the chains of a gradient sampler, already share one batched call).
        ``reparam='noncentered'`` (elliptical families) samples every
        amplitude (``*_var``) hyper relative to the data scale ``log
        Var[g^{-1}(y)]``, a unit-Jacobian shear of the log density, with
        every method; the chain is mapped back to the model's
        parameterization.  Under ``fix_vars`` the chains move over the
        sampling dims against the logp averaged over the fixed chain, and
        the fixed dims of the result hold the fixed chain's mean."""
        if method not in ("ensemble", "nuts", "neutra", "advi"):
            raise ValueError(f"unknown method {method!r}")
        if reparam not in (None, "noncentered"):
            raise ValueError(f"unknown reparam {reparam!r} (None | 'noncentered')")
        reg = self.active
        ndim = len(reg.sampling_dims)
        if chains is None:
            chains = 2 * ndim
        if file is not None and load:
            datatrace = load_datatrace(file)
            if (datatrace is not None and datatrace["_niter"].max() == samples - 1
                    and datatrace["_nchain"].max() == chains - 1):
                if plot:
                    plot_datatrace(datatrace)
                return datatrace
        if start is None:
            start = self.find_MAP(display=False)
        if isinstance(start, dict):
            start = reg.dict_to_array(start)
        start = np.asarray(start, dtype=settings.floatx)[..., reg.sampling_dims]
        logp, loglike, logprior = self._sampling_logps(prior=prior,
                                                       tempered=ntemps is not None)
        shear = None
        if reparam == "noncentered":
            pair = self._noncentered_sampling_shear()
            if pair is None:
                raise ValueError(
                    f"{type(self).__name__} has no amplitude hyper in the "
                    "sampling dims — reparam='noncentered' does not apply")
            shear, unshear = pair
            logp, loglike, logprior = (None if f is None else (lambda v, _f=f: _f(shear(v)))
                                       for f in (logp, loglike, logprior))
            start = _map_rows(unshear, start)
        if method != "ensemble" and logp is None:
            logp = (lambda v: loglike(v) + logprior(v))
        if method == "advi":
            center = start if start.ndim == 1 else np.mean(start.reshape(-1, ndim), axis=0)
            fit = fit_advi(logp, center, steps=advi_steps, mc=advi_mc, lr=advi_lr,
                           full_rank=advi_full_rank, seed=seed)
            if not fit.converged:
                print("sample_hypers(method='advi'): ELBO still improving "
                      "at the last decile — consider more advi_steps")
            echain = advi_draws(fit, chains, samples, seed=seed + 1)
            with torch.no_grad():
                lnprob = logp(as_tensor(echain.reshape(-1, ndim))).reshape(
                    echain.shape[:2]).cpu().numpy()
        elif method == "neutra":
            n_walk = max(2 * ndim, 16)
            n_walk += n_walk % 2
            wstart = start if start.ndim == 2 else np.tile(start[None, :], (n_walk, 1))
            _, wchain = mcmc_ensemble(ndim, samples=neutra_warmup, chains=n_walk, start=wstart,
                                      logp=logp, noise_mult=noise_mult, noise_sum=noise_sum,
                                      seed=seed)
            draws = wchain[:, neutra_warmup // 2:, :].reshape(-1, ndim)
            echain, lnprob, _ = neutra_nuts(
                logp, draws, samples, chains=chains, warmup=nuts_warmup, key=seed,
                max_depth=max_depth, target_accept=target_accept,
                adapt_mass="dense" if nuts_mass == "dense" else True)
        elif method == "nuts":
            jitter = np.random.default_rng(seed)
            z0 = start if start.ndim == 2 else (
                start[None, :] * (1 + noise_mult * jitter.standard_normal((chains, ndim))
                                  ).astype(settings.floatx))
            echain, lnprob, _ = nuts_sampler(
                logp, z0, samples, warmup=nuts_warmup, key=seed, max_depth=max_depth,
                chains=chains, target_accept=target_accept,
                adapt_mass="dense" if nuts_mass == "dense" else True, chunk=nuts_chunk)
        else:
            lnprob, echain = mcmc_ensemble(
                ndim, samples=samples, chains=chains, ntemps=ntemps, start=start, logp=logp,
                loglike=loglike, logprior=logprior, noise_mult=noise_mult,
                noise_sum=noise_sum, threads=threads, parallel=parallel, seed=seed)
        if shear is not None:  # back to the model's parameterization
            echain = _map_rows(shear, echain)
        complete_chain = np.empty(echain.shape[:2] + (reg.ndim,), dtype=settings.floatx)
        complete_chain[:, :, reg.sampling_dims] = echain
        if reg.fixed_datatrace is not None:
            complete_chain[:, :, reg.fixed_dims] = reg.fixed_chain[:, reg.fixed_dims].mean(axis=0)
        if raw:
            return complete_chain, lnprob
        datatrace = chains_to_datatrace(
            self, complete_chain, ll=lnprob, burnin_tol=burnin_tol,
            burnin_method=burnin_method, burnin_dims=reg.sampling_dims,
            outlayer_percentile=outlayer_percentile, clusters=clusters)
        if file is not None:
            save_datatrace(datatrace, file)
        if plot:
            plot_datatrace(datatrace)
        return datatrace

    def _array_logp_sampling(self, p):
        """logp over the sampling dims (every dim when nothing is fixed; the
        fixed chain's mean under ``fix_vars``)."""
        if self.active.fixed_datatrace is not None:
            return float(self.fixed_logp(p))
        return self.logp(np.asarray(p, dtype=settings.floatx), array=True)

    def _array_dlogp_sampling(self, p):
        if self.active.fixed_datatrace is not None:
            return self.fixed_dlogp(p)
        return self.dlogp(np.asarray(p, dtype=settings.floatx))

    def _loo_objective_pure(self):
        """The LOO objective ``fn(params, space, inputs, outputs)``: this
        process's leave-one-out log pseudo-likelihood (``th_loo_fn``, the
        GP family) in place of its marginal loglike, plus prior terms,
        potentials and every other process's loglike."""
        if not hasattr(self, "th_loo_fn"):
            raise NotImplementedError(f"{type(self).__name__} has no th_loo_fn; "
                                      "objective='loo' needs the GP family")
        reg = self.active
        loo_fn = self.th_loo_fn()
        others = [(fn, comp) for comp in reg.components.values() if comp is not self
                  for fn in (comp.th_loglike_fn(),) if fn is not None]

        def fn(params, space, inputs, outputs):
            total = (reg.logp_prior_dict(params) + reg.logp_potentials(params)
                     + loo_fn(params, space, inputs, outputs))
            for like_fn, comp in others:
                total = total + like_fn(params, *comp._resolve_data(None, None, None))
            return total

        return fn

    def _sampling_loo_objective(self):
        """The LOO objective over (R, nsampling) rows, batched and
        differentiable as :meth:`_sampling_logps` (one batched
        value-and-gradient evaluation of the rows): the ``engine='jax'``
        counterpart of ``objective='loo'``.  Refused under ``fix_vars``, as
        in the JAX package."""
        if self.active.fixed_datatrace is not None:
            raise ValueError("objective='loo' does not compose with "
                             "fix_vars/fixed chains")
        pure = self._loo_objective_pure()

        def value(u):
            u = as_tensor(u)
            with torch.no_grad():
                out = pure(self.active.array_to_dict_tensor(u),
                           *self._resolve_data(None, None, None))
            return out.expand(u.shape[:-1])

        return _differentiable(value, lambda u: self._value_and_grad(pure, as_tensor(u)))

    def _array_loo_sampling(self, p):
        return float(self._sampling_loo_objective()(as_tensor(np.asarray(p,
                                                                         dtype=settings.floatx))))

    def _array_dloo_sampling(self, p):
        return self._array_grad(self._loo_objective_pure(),
                                np.asarray(p, dtype=settings.floatx))

    # ----------------------------------------------------------------- find_MAP
    def find_MAP(self, start=None, points=1, return_points=False, plot=False,
                 display=True, powell=True, bfgs=True, init="bfgs", max_time=None,
                 engine="scipy", max_iters=200, objective="logp", **kwargs):
        """Multi-start MAP search with the reference recipe: alternating
        BFGS (with its gradient) and Powell through scipy, hardened
        objectives (:func:`~g3py_tpu_torch.bayesian.selection.optimize`).
        ``start`` is a params dict or a list of them; ``points`` is the
        number of optimizer runs; returns the best params dict (and, with
        ``return_points``, every ``(name, objective, params)`` visited).
        ``objective='loo'`` (GP family) maximizes the leave-one-out log
        pseudo-likelihood (GPML §5.4.2) in place of this process's marginal
        loglike; prior terms, potentials and the other processes' loglikes
        stay.  ``engine='jax'`` optimizes every start at once with the
        batched L-BFGS of :func:`~g3py_tpu_torch.bayesian.optimize_jax.
        lbfgs_maximize` (``max_iters`` iterations at most): ``points``
        starts, the first ``start`` and jittered copies of it, each
        evaluation of the objective one batched call over the starts.
        ``engine='iterative'`` (GP family) trains through the matrix-free
        NLL of ``nll_iterative`` (``_find_map_iterative`` takes its solver
        keywords: ``rank``, ``block``, ``cg_iters``, ``probes``,
        ``lanczos_iters``, ``seed``, ``loop`` and ``linesearch_steps``).
        ``engine='distributed'`` (families with ``nll_distributed``) trains
        through the band-sharded exact NLL, every rank of the mesh calling
        it alike (``_find_map_distributed`` takes ``mesh``, ``block`` and
        ``axis``)."""
        if objective not in ("logp", "loo"):
            raise ValueError(f"unknown objective {objective!r}")
        if engine == "jax":
            return self._find_map_jax(start=start, points=points, return_points=return_points,
                                      display=display, max_iters=max_iters,
                                      objective=objective, **kwargs)
        if objective == "loo" and engine not in ("scipy", "jax"):
            raise ValueError("objective='loo' is wired into the scipy and jax engines only")
        if engine == "iterative":
            if not hasattr(self, "_find_map_iterative"):
                raise ValueError(f"engine='iterative' needs the GP family, not "
                                 f"{type(self).__name__}")
            return self._find_map_iterative(start=start, points=points,
                                            return_points=return_points, display=display,
                                            max_iters=max_iters, **kwargs)
        if engine == "distributed":
            if not hasattr(self, "nll_distributed"):
                raise ValueError(f"engine='distributed' needs a family with nll_distributed, "
                                 f"not {type(self).__name__}")
            return self._find_map_distributed(start=start, points=points,
                                              return_points=return_points, display=display,
                                              max_iters=max_iters, **kwargs)
        if engine != "scipy":
            raise ValueError(f"unknown engine {engine!r}")
        if kwargs:
            raise TypeError(f"find_MAP(engine={engine!r}) got unexpected keyword arguments "
                            f"{sorted(kwargs)}")
        if not self.is_observed:
            print("For find_MAP it is necessary to have observations")
            return start
        reg = self.active
        if start is None:
            start = self.params
        if objective == "loo":
            if reg.fixed_datatrace is not None:
                raise ValueError("objective='loo' does not compose with "
                                 "fix_vars marginalization")
            logp, dlogp = self._array_loo_sampling, self._array_dloo_sampling
        else:
            logp, dlogp = self._array_logp_sampling, self._array_dlogp_sampling
        try:
            dlogp(reg.sampling_params(start if not isinstance(start, list) else start[0]))
        except Exception as m:
            print(m)
            dlogp = None

        points_list = []
        if isinstance(start, list):
            for i, s in enumerate(start, start=1):
                points_list.append(("start" + str(i), logp(reg.sampling_params(s)), s))
        else:
            points_list.append(("start", logp(reg.sampling_params(start)), start))
        n_starts = len(points_list)
        if display:
            print("Starting function value (-logp): " + str(-points_list[0][1]))
        if plot:
            self._plot_point(0, points_list[0][2], "start")
        check = 0 if init == "bfgs" else 1
        i = -1
        points -= 1
        while i < points:
            i += 1
            idx = i // 2 if powell else i
            if idx >= len(points_list):
                break  # no fresh start/refinement left to visit
            name, _, start_i = points_list[idx]
            if (i % 2 == check or not powell) and bfgs:
                if name.endswith("_bfgs"):
                    if i > n_starts:
                        points += 1
                    continue
                name += "_bfgs"
                if display:
                    print(name)
                new = optimize(logp=logp, start=reg.sampling_params(start_i),
                               dlogp=dlogp, fmin="bfgs", max_time=max_time,
                               disp=display)
            else:
                if name.endswith("_powell"):
                    if i > n_starts:
                        points += 1
                    continue
                name += "_powell"
                if display:
                    print(name)
                new = optimize(logp=logp, start=reg.sampling_params(start_i),
                               fmin="powell", max_time=max_time, disp=display)
            points_list.append((name, logp(new), reg.dict_from_sampling_array(new)))
            if plot:
                self._plot_point(i + 1, points_list[-1][2], name)

        optimal = points_list[0]
        for test in points_list:
            if test[1] > optimal[1]:
                optimal = test
        params = DictObj(optimal[2])
        if display:
            print("find_MAP", params)
        if return_points is False:
            return params
        return params, points_list

    def _find_map_distributed(self, start=None, points=1, return_points=False, display=True,
                              max_iters=200, mesh=None, block=None, axis="dp", **_):
        """MAP search on the band-sharded exact NLL plus the hyper priors
        (``find_MAP(engine='distributed')``): scipy's L-BFGS-B on every rank
        of the mesh, each objective and gradient one band-sharded
        evaluation whose value and gradient are all-reduced, so bit-equal on
        every rank — the ranks' iterates stay in lockstep, and every
        decision (the non-finite guard, the best start) is made from those
        replicated values.  ``display`` evaluates each start on every rank
        (an evaluation is a collective) and only the mesh's rank 0 prints.
        The starts are
        ``start`` (``params_default`` when None; a list of them) and, up to
        ``points``, ``params_random`` around the first (sigma 0.15, from
        ``np.random.default_rng(0)``)."""
        import scipy.optimize as spo
        from ..parallel.cholesky import _resolve_mesh

        reg = self.active
        mesh = _resolve_mesh(mesh, axis)
        speak = display and mesh.rank == 0
        if start is None:
            start = self.params_default
        starts = list(start) if isinstance(start, list) else [start]
        rng = np.random.default_rng(0)
        while len(starts) < points:
            starts.append(self.params_random(mean=starts[0], sigma=0.15, prop=True, rng=rng))
        prior_pure = self._logp_pure(prior=True)
        space, inputs, outputs = self._resolve_data(None, None, None)

        def f_and_g(u):
            ut = torch.as_tensor(u, dtype=settings.dtype,
                                 device=settings.device).requires_grad_(True)
            with torch.enable_grad():
                p = reg.array_to_dict_tensor(ut)
                v = (self.nll_distributed(p, mesh=mesh, block=block, axis=axis)
                     - prior_pure(p, space, inputs, outputs))
                (g,) = torch.autograd.grad(v, ut)
            v, g = float(v.detach()), g.detach().cpu().numpy().astype(np.float64)
            if not np.isfinite(v) or not np.all(np.isfinite(g)):
                # an overshoot into a dead region reads as very bad
                return 1e10, np.zeros_like(g)
            return v, g

        results = []
        for i, s in enumerate(starts, start=1):
            u0 = np.asarray(reg.dict_to_array(s), np.float64)
            if display:
                v0 = f_and_g(u0)[0]
                if speak:
                    print(f"start{i} (-logp): {v0:.6g}")
            res = spo.minimize(f_and_g, u0, jac=True, method="L-BFGS-B",
                               options={"maxiter": max_iters})
            results.append((f"distributed{i}", float(res.fun),
                            reg.array_to_dict(np.asarray(res.x, settings.floatx))))
            if speak:
                print(f"start{i} done (-logp): {res.fun:.6g}")
        results.sort(key=lambda t: t[1])
        best = DictObj(results[0][2])
        if return_points:
            return best, [(n_, -v, p) for n_, v, p in results]
        return best

    def _plot_point(self, fig, params, title):
        """``find_MAP(plot=True)``: one figure a visited point."""
        from ..utils.plots import figure, show

        figure(fig)
        self.plot(params=params, title=title)
        show()

    def _find_map_jax(self, start=None, points=1, return_points=False, display=True,
                      max_iters=200, objective="logp"):
        """Every start optimized at once on the device (the JAX package's
        ``_find_map_jax``): the starts are ``start`` (a params dict, a flat
        vector or a list of them) and, up to ``points``, copies of the first
        jittered by 20% from ``np.random.default_rng(0)``."""
        reg = self.active
        if start is None:
            start = self.params
        starts = start if isinstance(start, list) else [start]
        starts = [reg.sampling_params(s) if isinstance(s, dict) else
                  np.asarray(s)[reg.sampling_dims] if np.ndim(s) == 1 and
                  len(s) == reg.ndim else np.asarray(s) for s in starts]
        rng = np.random.default_rng(0)
        while len(starts) < points:
            starts.append(starts[0] * (1 + 0.2 * rng.standard_normal(
                len(starts[0]))).astype(settings.floatx))
        if objective == "loo":
            logp = self._sampling_loo_objective()
        else:
            logp, _, _ = self._sampling_logps(prior=False)
        pts, vals = lbfgs_maximize(logp, np.stack(starts), max_iters=max_iters)
        best = int(np.argmax(vals))
        params = DictObj(reg.dict_from_sampling_array(pts[best]))
        if display:
            print("find_MAP(jax)", {"logp": float(vals[best])})
        if return_points:
            plist = [(f"start{i}_lbfgs", float(vals[i]), reg.dict_from_sampling_array(pts[i]))
                     for i in range(len(vals))]
            return params, plist
        return params

    # ----------------------------------------------------------------- predict
    @host_statistic
    def quantiler(self, params=None, space=None, inputs=None, outputs=None, q=0.975,
                  prior=False, noise=False):
        return None

    @host_statistic
    def sampler(self, params=None, space=None, inputs=None, outputs=None, samples=1,
                prior=False, noise=False):
        return None

    @host_statistic
    def predict(self, params=None, space=None, inputs=None, outputs=None, mean=True,
                std=True, var=False, cov=False, median=False, quantiles=False,
                quantiles_noise=False, samples=0, distribution=False, prior=False,
                noise=False, simulations=None, rng=None):
        """Dict of the requested statistics (host arrays), each evaluated on
        its own as in the JAX package; :meth:`predictor` serves query batches
        from one factorization instead.  ``samples`` adds that many
        posterior draws (``samples``, (m, samples)); ``distribution`` adds
        ``logpredictive``, a function of a vector of values at ``space``.
        For the Monte-Carlo families (transport, copula) an int
        ``simulations`` draws once, from ``rng`` (a numpy Generator; a
        fresh one when None), for every statistic that reads draws, and the
        noise bands draw their own, as in the JAX package; the gaussian and
        Student-t statistics are analytic and ignore both."""
        dev = device_statistics(self)
        if params is None:
            params = self.params
        if not self.is_observed:
            prior = True
        kw = dict(space=space, inputs=inputs, outputs=outputs, prior=prior)
        mc = dict(rng=rng) if self._mc_moments else {}
        n_simulations = 1
        if self._mc_moments and isinstance(simulations, int):
            n_simulations = simulations
            simulations = dev.sampler(params, samples=simulations, noise=noise, rng=rng,
                                       **kw)
        values = DictObj()
        if mean:
            values["mean"] = dev.mean(params, noise=noise, simulations=simulations, **mc, **kw)
        if var:
            values["variance"] = dev.variance(params, noise=noise, simulations=simulations,
                                               **mc, **kw)
        if std:
            values["std"] = dev.std(params, noise=noise, simulations=simulations, **mc, **kw)
        if cov:
            if self.th_covariance() is None:
                raise ValueError(
                    f"{type(self).__name__} has no analytic posterior covariance (warped "
                    "covariances have no closed form); use samples= for an empirical "
                    "covariance")
            values["covariance"] = dev.covariance(params, noise=noise, **kw)
        if median:
            values["median"] = dev.median(params, noise=noise, simulations=simulations,
                                           **mc, **kw)
        if quantiles:
            for key, q in (("quantile_up", 0.975), ("quantile_down", 0.025)):
                values[key] = dev.quantiler(params, q=q, noise=noise, simulations=simulations,
                                             **mc, **kw)
        if quantiles_noise:
            sims_noise = (dev.sampler(params, samples=n_simulations, noise=True, rng=rng, **kw)
                          if self._mc_moments else simulations)
            values["noise_std"] = dev.std(params, noise=True, simulations=sims_noise, **mc,
                                           **kw)
            sims_noise = n_simulations if self._mc_moments else simulations
            for key, q in (("noise_up", 0.975), ("noise_down", 0.025)):
                values[key] = dev.quantiler(params, q=q, noise=True, simulations=sims_noise,
                                             **mc, **kw)
        if samples > 0:
            values["samples"] = dev.sampler(params, samples=samples, noise=noise, **kw)
        if distribution:
            values["logpredictive"] = lambda x: self.logpredictive(params, vector=x,
                                                                   noise=True, **kw)
        return values

