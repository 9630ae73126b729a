"""Model-free serving of an exported predictor.

:meth:`g3py_tpu_torch.models.predictor.Predictor.export` writes a
directory with ``bundle.pt2`` (the statistic bundle traced by
``torch.export``, with a symbolic or a fixed query batch), ``state.npz``
(hypers, factorized posterior state and observed data) and
``manifest.json``.  :func:`load_predictor` serves it with no model code,
no hypers and no refactorization: this module imports the registration
of the one operator the bundle records, the stationary gram K1
(``g3py_tpu_torch::stationary_gram``, the CUDA kernel on the card), and
nothing of ``models``, ``hypers`` or ``bayesian``.

>>> pr.export("/models/gp_v3", quantiles=True)        # on the card
>>> ep = load_predictor("/models/gp_v3")              # any process with torch
>>> out = ep(x_query)                                  # dict of statistics
>>> mu = ep.mean(x_query)
"""

import json
import os

import numpy as np
import torch
import torch.export.passes

from .config import settings
from .ops import stationary_gram as _k1  # noqa: F401  (registers the K1 operator)
from .utils import DictObj

__all__ = ["ExportedPredictor", "load_predictor"]


class ExportedPredictor:
    """A serving artifact written by ``Predictor.export``, reloaded onto
    ``device`` (``settings.device`` when None; one of the manifest's
    ``platforms``): every exported statistic of a query batch from one call
    of the loaded program.  A fixed-batch artifact raises on another batch
    size.  ``ep.mean(x)`` (any exported statistic) runs the same call and
    selects the key."""

    def __init__(self, path, device=None):
        with open(os.path.join(path, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        device = torch.device(settings.device if device is None else device)
        if device.type not in self.manifest["platforms"]:
            raise ValueError(f"this artifact was exported for {self.manifest['platforms']}, "
                             f"not {device.type}")
        program = torch.export.load(os.path.join(path, "bundle.pt2"))
        if device.type != self.manifest["device"]:
            program = torch.export.passes.move_to_device_pass(program, device)
        self._call = program.module()
        self.dtype = getattr(torch, self.manifest["dtype"])
        self.device = device
        data = np.load(os.path.join(path, "state.npz"))

        def tensor(a):
            return torch.as_tensor(a, device=device)

        self._merged = {k[len("merged/"):]: tensor(data[k]) for k in data.files
                        if k.startswith("merged/")}
        self._inputs = tensor(data["inputs"])
        self._outputs = tensor(data["outputs"])
        self.statistics = list(self.manifest["statistics"])
        self.path = path

    def predict(self, space, vector=None):
        """Every exported statistic at the query points ``space`` (m, d),
        a dict of tensors on the serving device."""
        space = torch.as_tensor(np.asarray(space) if not isinstance(space, torch.Tensor)
                                else space, dtype=self.dtype, device=self.device)
        if space.ndim < 2:
            space = space.reshape(-1, 1)
        if vector is None:
            vector = torch.zeros(space.shape[0], dtype=self.dtype, device=self.device)
        else:
            vector = torch.as_tensor(vector, dtype=self.dtype, device=self.device).reshape(-1)
        with torch.no_grad():
            out = self._call(self._merged, self._inputs, self._outputs, space, vector)
        return DictObj(out)

    __call__ = predict

    def __getattr__(self, name):
        if name.startswith("_") or name not in self.__dict__.get("statistics", ()):
            raise AttributeError(name)

        def stat(space, vector=None, _k=name):
            return self.predict(space, vector=vector)[_k]

        stat.__name__ = name
        return stat


def load_predictor(path, device=None):
    """Load a serving artifact written by ``Predictor.export`` onto
    ``device`` (``settings.device`` when None)."""
    return ExportedPredictor(path, device=device)
