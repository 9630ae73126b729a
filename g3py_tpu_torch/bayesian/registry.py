"""Graphical-model parameter registry (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.registry`): an ordered table of
:class:`~g3py_tpu_torch.hypers.Param` descriptors shared by one or more
processes.  It owns the dict <-> flat-array bijection (natural-space
name-keyed dicts on the user side, an unconstrained vector on the sampler
side), the prior logp, the potentials, and ``params_default`` assembled from
every component's data-driven defaults.

``GraphicalModel.active`` is the process-wide active registry, as in the
JAX package: every new registry becomes it (:meth:`GraphicalModel.activate`),
a process built with ``active=True`` joins it (or creates it when it is
None), and :func:`get_model` returns it.  Several processes joined in one
registry share hyperparameters (the same :class:`Param` is registered once)
and sum their loglikes in one logp.  Reset it (``GraphicalModel.active =
None``) before building a model that must not join an earlier one.

The tensor side takes rows: :meth:`GraphicalModel.array_to_dict_tensor`
maps an (R, ndim) matrix of unconstrained rows to a dict whose values lead
with the row axis, and the prior and the potentials of such a dict are (R,)
— the counterpart of the JAX package's ``vmap`` over parameter rows.

A registry pickles (:meth:`GraphicalModel.save`, :meth:`GraphicalModel.load`,
``GraphicalModel(file=)``) with every tensor moved to the CPU, so that a
registry saved on the card loads on a host without one.
"""

import warnings

import numpy as np
import torch

from ..config import settings, asarray_x, as_tensor
from ..utils import DictObj, save_pkl, load_pkl
from ..hypers import Param, row_shape

__all__ = ["GraphicalModel", "Model", "get_model"]


class GraphicalModel:
    """Shared parameter registry + model container."""

    active = None  # the class-level active registry

    def __init__(self, name="GM", description=None, file=None, reset=False):
        if file is not None and not reset:
            try:
                self.reset(file)
                self.activate()
                return
            except Exception:
                print("Not found model in " + str(file))
        self.name = name
        self.description = description if description is not None else ""
        self.components = DictObj()
        self.params_spec = {}  # name -> Param, insertion-ordered
        self.potentials = DictObj()  # name -> callable(params_dict) -> scalar
        self.current_params = None
        # fix_vars: dims pinned to a datatrace's rows (none by default)
        self.fixed_keys = []
        self.fixed_datatrace = None
        self.fixed_chain = None
        self.fixed_dims = []
        if file is not None:
            self.file = file
            try:
                self.save()
            except Exception:
                print("Error in file " + str(file))
        self.activate()

    def activate(self):
        """Make this registry the active one."""
        type(self).active = self

    def add_component(self, component):
        self.components[component.name] = component

    # -- registration ---------------------------------------------------------
    def register_param(self, p: Param):
        existing = self.params_spec.get(p.name)
        if existing is not None and existing is not p:
            if existing.shape != p.shape:
                raise ValueError(
                    f"conflicting shapes for shared hyper {p.name}: "
                    f"{existing.shape} vs {p.shape}")
            return existing
        self.params_spec[p.name] = p
        return p

    def register_potential(self, name, fn):
        self.potentials[name] = fn

    # -- layout ---------------------------------------------------------------
    @property
    def ordered_params(self):
        return list(self.params_spec.values())

    @property
    def ndim(self):
        return sum(p.size for p in self.ordered_params)

    def slices(self):
        out = {}
        start = 0
        for p in self.ordered_params:
            out[p.name] = (start, start + p.size, p.shape)
            start += p.size
        return out

    def param_names(self):
        """Flat-array column names, one per scalar dim (vector params get
        __0, __1, ... suffixes)."""
        names = []
        for p in self.ordered_params:
            if p.size == 1:
                names.append(p.name)
            else:
                names.extend(f"{p.name}__{i}" for i in range(p.size))
        return names

    # -- bijection ------------------------------------------------------------
    def dict_to_array(self, params):
        """Natural-space dict -> unconstrained flat host array."""
        if not isinstance(params, dict):
            return np.asarray(params, dtype=settings.floatx)
        u = np.empty(self.ndim, dtype=settings.floatx)
        start = 0
        for p in self.ordered_params:
            v = params.get(p.name)
            if v is None:
                v = p.testval()
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            u[start:start + p.size] = np.ravel(p.prior.transform.forward(np.asarray(v)))
            start += p.size
        return u

    def array_to_dict_tensor(self, u):
        """Unconstrained flat tensor -> natural-space dict of tensors, a
        differentiable map (the counterpart of ``array_to_dict_jax``).  A
        (R, ndim) matrix of rows gives values of shape (R,) + Param.shape."""
        out = {}
        start = 0
        for p in self.ordered_params:
            seg = u[..., start:start + p.size].reshape(u.shape[:-1] + p.shape)
            out[p.name] = p.prior.transform.backward(seg)
            start += p.size
        return out

    def array_to_dict(self, u):
        """Unconstrained flat host array -> natural-space dict of host arrays."""
        u = np.asarray(u, dtype=settings.floatx)
        out = DictObj()
        start = 0
        for p in self.ordered_params:
            seg = torch.as_tensor(u[start:start + p.size].reshape(p.shape))
            out[p.name] = p.prior.transform.backward(seg).numpy()
            start += p.size
        return out

    # -- prior logp -----------------------------------------------------------
    def logp_prior_array(self, u):
        """Sum of the per-param prior terms in unconstrained space, from the
        flat vector (one sum a row for a (R, ndim) matrix of rows)."""
        total = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
        start = 0
        for p in self.ordered_params:
            total = total + p.prior.logp(u[..., start:start + p.size])
            start += p.size
        return total

    def logp_prior_dict(self, params):
        """Sum of per-param prior terms from a natural-space dict (one sum
        a row for a dict of rows)."""
        total = torch.zeros((), dtype=settings.dtype, device=settings.device)
        for p in self.ordered_params:
            v = as_tensor(params[p.name])
            total = total + p.prior.logp_natural(v.reshape(row_shape(p, v) + (-1,)))
        return total

    def logp_potentials(self, params):
        """Sum of the potentials (one sum a row for a dict of rows)."""
        total = torch.zeros((), dtype=settings.dtype, device=settings.device)
        for fn in self.potentials.values():
            term = fn(params)
            if term is not None:  # e.g. a substr matching no hyper
                total = total + term
        return total

    # -- params ---------------------------------------------------------------
    def set_params(self, params=None):
        """Make ``params`` the current params (None restores the defaults)."""
        self.current_params = None if params is None else DictObj(params)

    @property
    def params(self):
        """The params a process uses when given none: the current params
        when set, else the defaults."""
        if self.current_params is not None:
            return self.current_params.copy()
        return self.params_default

    @property
    def params_test(self):
        """Prior test values."""
        return DictObj({p.name: p.testval() for p in self.ordered_params})

    @property
    def params_default(self):
        """Test values overridden by each component's data-driven defaults."""
        default = self.params_test
        for name, component in self.components.items():
            try:
                d = component.default_hypers()
            except Exception as e:  # degrade loudly, keep the test values
                warnings.warn(
                    f"default_hypers failed for component {name!r} "
                    f"({type(e).__name__}: {e}); falling back to test "
                    "values for its params")
                d = {}
            for param, v in d.items():
                key = param.name if isinstance(param, Param) else param
                if key in self.params_spec:
                    default[key] = asarray_x(
                        np.reshape(np.asarray(v), self.params_spec[key].shape))
        return default

    def params_random(self, mean=None, sigma=0.1, prop=True, rng=None):
        """Random perturbation of a params dict (the defaults when None):
        ``v (1 + sigma e)`` with ``prop``, else ``v + sigma e``, e standard
        normal draws of ``rng`` (numpy's Generator; a fresh one when None)."""
        if mean is None:
            mean = self.params_default
        if rng is None:
            rng = np.random.default_rng()
        out = DictObj(mean)
        for k, v in out.items():
            v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            noise = rng.standard_normal(v.size).reshape(v.shape)
            out[k] = asarray_x(v * (1 + sigma * noise) if prop else v + sigma * noise)
        return out

    def params_datatrace(self, dt, loc=None, iloc=None):
        """A datatrace row (``loc`` or ``iloc``: a row position of the
        numpy datatrace, which has no row labels) or, with neither, the
        mean of its rows -> natural-space params dict."""
        values = np.asarray(dt[self.param_names()])
        pos = loc if loc is not None else iloc
        row = values[pos] if pos is not None else values.astype(np.float64).mean(axis=0)
        return self.array_to_dict(np.asarray(row, dtype=settings.floatx))

    def params_serie(self, serie):
        """One datatrace row (a mapping of column name -> value, as
        :meth:`Datatrace.iterrows` yields) -> natural-space params dict."""
        return self.array_to_dict(np.asarray([serie[c] for c in self.param_names()],
                                             dtype=settings.floatx))

    # -- transformed views ------------------------------------------------------
    @property
    def original_to_transformed_names(self):
        return {p.name: f"{p.name}_{p.prior.transform.name}_" for p in self.ordered_params
                if p.prior.transform.name != "id"}

    @property
    def transformed_to_original_names(self):
        return {v: k for k, v in self.original_to_transformed_names.items()}

    def transform_params(self, params, to_dict=True, to_transformed=True, complete=False):
        """Natural <-> transformed (unconstrained) views of a params dict
        (or of the flat vector): a transformed hyper takes the name
        ``<name>_<transform>_``; ``complete`` starts from the current params;
        ``to_dict=False`` returns the flat unconstrained vector."""
        if not isinstance(params, dict):
            params = self.array_to_dict(params)
        r = DictObj(self.params) if (complete or not to_dict) else DictObj()
        fwd = self.original_to_transformed_names
        bwd = self.transformed_to_original_names
        for k, v in params.items():
            if to_transformed and k in fwd:
                r[fwd[k]] = np.asarray(self.params_spec[k].prior.transform.forward(
                    np.asarray(v)))
            elif not to_transformed and k in bwd:
                orig = bwd[k]
                back = self.params_spec[orig].prior.transform.backward(
                    torch.as_tensor(np.asarray(v)))
                r[orig] = np.asarray(back)
            else:
                r[k] = v
        if not to_dict:
            r = self.dict_to_array(r)
        return r

    # -- fix_vars: dims pinned to a datatrace ------------------------------------
    def fix_vars(self, datatrace=None, keys=None):
        """Pin the ``keys`` columns to a datatrace's rows: the other dims are
        then optimized and sampled against the logp averaged over those rows
        (the Rao-Blackwellized ``fixed_*`` logps).  None for either
        argument unpins every dim."""
        if datatrace is None or keys is None:
            self.fixed_keys = []
            self.fixed_datatrace = None
            self.fixed_chain = None
            self.fixed_dims = []
        else:
            cols = self.param_names()
            self.fixed_keys = list(keys)
            self.fixed_datatrace = datatrace.copy()
            self.fixed_chain = np.asarray(self.fixed_datatrace[cols],
                                          dtype=settings.floatx).copy()
            self.fixed_dims = sorted(cols.index(k) for k in keys)

    # -- sampling view ----------------------------------------------------------
    @property
    def sampling_dims(self):
        return sorted(set(range(self.ndim)) - set(self.fixed_dims))

    def sampling_params(self, params):
        """Flat unconstrained host array of the sampling dims."""
        if isinstance(params, dict):
            return self.dict_to_array(params)[self.sampling_dims]
        return np.asarray(params)[self.sampling_dims]

    def dict_from_sampling_array(self, params):
        """Params dict of a vector over the sampling dims (the fixed dims at
        the current params)."""
        if self.fixed_datatrace is None:
            return self.array_to_dict(params)
        r = self.dict_to_array(self.params)
        r[self.sampling_dims] = params
        return self.array_to_dict(r)

    # -- persistence ------------------------------------------------------------
    def __getstate__(self):
        """Pickled state with every tensor on the CPU (a registry saved on
        the card loads on a CPU host)."""
        return _to_cpu(dict(self.__dict__))

    @classmethod
    def load(cls, path):
        r = load_pkl(path)
        print("Loaded model " + path)
        r.activate()
        return r

    def reset(self, path=None):
        if path is None:
            path = self.file
        load = self.load(path)
        self.__dict__.update(load.__dict__)
        self.activate()
        return self

    def save(self, path=None):
        if path is None:
            path = self.file
        try:
            save_pkl(self, path)
            print("Saved model " + path)
        except Exception as details:
            print("Error saving model " + str(path), details)


def _to_cpu(obj):
    """``obj`` with the tensors of its dicts, lists and tuples on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, DictObj):
        return DictObj({k: _to_cpu(v) for k, v in obj.items()})
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


Model = GraphicalModel


def get_model():
    """The active registry, or a new one (which becomes active)."""
    if GraphicalModel.active is not None:
        return GraphicalModel.active
    return GraphicalModel()
