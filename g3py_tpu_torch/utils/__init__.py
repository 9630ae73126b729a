"""Containers and cross-package helpers.

* :class:`DictObj` — dict with attribute access (as in :mod:`g3py_tpu.utils`).
* :class:`MaxTime` and :func:`nan_to_high` — the optimizer's wall-clock
  budget and NaN/Inf hardening (as in :mod:`g3py_tpu.utils`).
* :func:`params_from_jax` — carry a natural-space params dict from the JAX
  package (numpy arrays keyed by hyper name) into this package's dict of
  tensors on ``settings.device``, checked against the process's registry.
  It takes plain numpy input and imports nothing of JAX.
* :func:`flow_from_jax` — carry a NeuTra flow's params from the JAX package
  into this package's :class:`~g3py_tpu_torch.bayesian.neutra.Flow`, with
  the same checks.
"""

import time

import numpy as np

__all__ = ["DictObj", "MaxTime", "nan_to_high", "params_from_jax", "flow_from_jax"]


class DictObj(dict):
    """dict with attribute access."""

    def __init__(self, data=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if data is not None:
            for k, v in data.items():
                self[k] = v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError("No such attribute: " + name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        if name in self:
            del self[name]
        else:
            raise AttributeError("No such attribute: " + name)

    def copy(self):
        return DictObj(data=self)


class MaxTime:
    """Optimizer callback raising ``TimeoutError`` once a wall-clock budget
    of ``max_sec`` seconds is spent."""

    def __init__(self, max_sec=60):
        self.max_sec = max_sec + time.time()

    def __call__(self, xk=None):
        if time.time() > self.max_sec:
            raise TimeoutError("Terminating: time limit reached")


def nan_to_high(x):
    """Replace non-finite entries with 1e100 so scipy optimizers never see
    NaN/Inf."""
    return np.where(np.isfinite(x), x, 1.0e100)


def params_from_jax(process, params):
    """Natural-space params of the JAX package -> this package's tensors.

    ``params`` maps every hyper name of ``process``'s registry to an array
    (numpy, or anything ``np.asarray`` takes) of that hyper's shape.  Raises
    ``KeyError`` on a missing or extra name and ``ValueError`` on a wrongly
    shaped value; returns a :class:`DictObj` of tensors in
    ``settings.floatx`` on ``settings.device``, in registry order."""
    from ..config import as_tensor

    spec = process.active.params_spec
    missing = [k for k in spec if k not in params]
    extra = [k for k in params if k not in spec]
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing}, unexpected {extra}")
    out = DictObj()
    for name, p in spec.items():
        v = np.asarray(params[name])
        if v.shape != p.shape:
            raise ValueError(f"params_from_jax: {name} has shape {v.shape}, "
                             f"expected {p.shape}")
        out[name] = as_tensor(v)
    return out


def flow_from_jax(params):
    """The JAX package's flow params (``mean``, ``chol``, ``masks`` and a
    list of ``layers``, each ``w1``/``b1``/``w2``/``b2``; numpy arrays or
    anything ``np.asarray`` takes) -> a :class:`Flow` on
    ``settings.device`` in ``settings.floatx``.  Raises ``KeyError`` on a
    missing or extra name and ``ValueError`` on a wrongly shaped value, as
    :func:`params_from_jax` does."""
    from ..bayesian.neutra import Coupling, Flow
    from ..config import as_tensor

    top = {"mean", "chol", "masks", "layers"}
    missing, extra = sorted(top - set(params)), sorted(set(params) - top)
    if missing or extra:
        raise KeyError(f"flow_from_jax: missing {missing}, unexpected {extra}")
    mean = np.asarray(params["mean"])
    if mean.ndim != 1:
        raise ValueError(f"flow_from_jax: mean has shape {mean.shape}, expected (ndim,)")
    ndim, layers = mean.shape[0], list(params["layers"])
    shapes = {"chol": (ndim, ndim), "masks": (len(layers), ndim)}
    for name, shape in shapes.items():
        if np.shape(params[name]) != shape:
            raise ValueError(f"flow_from_jax: {name} has shape {np.shape(params[name])}, "
                             f"expected {shape}")
    couplings = []
    for i, layer in enumerate(layers):
        names = {"w1", "b1", "w2", "b2"}
        missing, extra = sorted(names - set(layer)), sorted(set(layer) - names)
        if missing or extra:
            raise KeyError(f"flow_from_jax: layers[{i}] missing {missing}, unexpected {extra}")
        hidden = np.shape(layer["w1"])[-1]
        want = {"w1": (ndim, hidden), "b1": (hidden,), "w2": (hidden, 2 * ndim),
                "b2": (2 * ndim,)}
        for name, shape in want.items():
            if np.shape(layer[name]) != shape:
                raise ValueError(f"flow_from_jax: layers[{i}].{name} has shape "
                                 f"{np.shape(layer[name])}, expected {shape}")
        couplings.append(Coupling(*(as_tensor(layer[k]) for k in ("w1", "b1", "w2", "b2"))))
    flow = Flow(as_tensor(mean), as_tensor(params["chol"]), as_tensor(params["masks"]), couplings)
    return flow.requires_grad_(False)
