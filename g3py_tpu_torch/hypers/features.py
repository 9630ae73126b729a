"""Deep kernel learning: a trainable MLP feature extractor composed with any
base kernel of the catalogue (Wilson, Hu, Salakhutdinov & Xing, AISTATS
2016) — the PyTorch counterpart of :mod:`g3py_tpu.hypers.features`.

* The extractor's weight matrices and biases are ordinary array-valued
  hypers (``Param`` of shape ``(d_i, d_{i+1})`` and ``(d_{i+1},)``, flat
  priors), so ``find_MAP``, ``sample_hypers`` and ``fit_svgp`` train them
  jointly with the kernel hypers through the one flat unconstrained vector.
* ``cov(params, x1, x2)`` pushes both row sets through the extractor and
  hands the features to the base kernel: for SE/MAT32/MAT52/RQ on ARD_L2
  that is one launch of the fused stationary gram (K1), whose backward
  reaches the weights through both of its inputs.  The feature matmuls are
  ``torch.matmul`` (full float32: the config pins TF32 off).
* ``default_hypers`` draws the LeCun-normal weights from the same seeded
  numpy Generator as the JAX package (so the defaults agree), then computes
  the base kernel's data-driven defaults on the initial features.
* A params dict of R rows gives (R, n, width) features and (R, m, n) grams.
"""

import numpy as np
import torch

from . import Flat, Hypers, hval, is_param, slice_dims
from ..config import settings, as_tensor
from .kernels import Kernel, SE

__all__ = ["DeepKernel"]

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "softplus": lambda h: torch.logaddexp(h, torch.zeros_like(h)),
    "elu": lambda h: torch.where(h > 0.0, h, torch.expm1(h)),
}


class DeepKernel(Kernel):
    """``k(x, x') = base(phi_w(x), phi_w(x'))`` with ``phi_w`` a trainable
    MLP.

    ``base`` is a Kernel class (instantiated over the feature width) or an
    instance; ``x`` the input spec, as for any kernel; ``widths`` the layer
    output widths, the last the feature dimension (hidden layers take
    ``activation``: tanh, relu, softplus or elu; the output layer is
    linear)."""

    def __init__(self, base=SE, x=None, widths=(32, 32, 2), activation="tanh", name=None):
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} not in {sorted(_ACTIVATIONS)}")
        self.widths = tuple(int(w) for w in widths)
        if not self.widths:
            raise ValueError("widths must name at least the feature dim")
        self.activation = activation
        self.act = _ACTIVATIONS[activation]
        if isinstance(base, type):
            base = base(self.widths[-1])
        self.base = base
        self.w = None
        self.b = None
        # the extractor replaces Kernel's metric and amplitude
        self.metric = None
        self.var = None
        Hypers.__init__(self, x, name)

    # -- dims / hypers ----------------------------------------------------------
    def _d_in(self):
        if isinstance(self.dims, np.ndarray):
            return int(self.dims.size)
        if isinstance(self.shape, tuple):
            return int(np.prod(self.shape))
        if self.shape is None:
            raise ValueError("DeepKernel needs an input spec before check_hypers: pass x at "
                             "construction or let the model call check_dims first")
        return int(self.shape)

    def check_dims(self, x=None):
        Hypers.check_dims(self, x)
        self.base.check_dims(int(self.widths[-1]))

    def check_hypers(self, parent=""):
        if self.w is None:
            sizes = (self._d_in(),) + self.widths
            self.w = [self._param(None, f"{parent}{self.name}_w{i}", Flat(),
                                  shape=(sizes[i], sizes[i + 1]))
                      for i in range(len(self.widths))]
            self.b = [self._param(None, f"{parent}{self.name}_b{i}", Flat(),
                                  shape=(sizes[i + 1],))
                      for i in range(len(self.widths))]
        self.base.check_hypers(parent + self.name + "_")
        self.hypers += self.base.hypers

    # -- defaults ---------------------------------------------------------------
    def _init_weights(self, d_in):
        """Deterministic LeCun-normal weights and zero biases (the seed is
        Wilson et al.'s submission id, as in the JAX package)."""
        rng = np.random.default_rng(20160216)
        sizes = (d_in,) + self.widths
        ws = [(rng.standard_normal((sizes[i], sizes[i + 1])) / np.sqrt(sizes[i])
               ).astype(settings.floatx) for i in range(len(self.widths))]
        bs = [np.zeros((sizes[i + 1],), settings.floatx) for i in range(len(self.widths))]
        return ws, bs

    def _np_features(self, ws, bs, x):
        h = np.asarray(x, dtype=settings.floatx)
        if h.ndim == 1:
            h = h[:, None]
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if i < len(ws) - 1:
                h = self.act(torch.as_tensor(h)).numpy()
        return h

    def default_hypers_dims(self, x=None, y=None):
        # Kernel's override walks (var, metric), which the extractor
        # replaces: the generic slice-then-default walk
        return Hypers.default_hypers_dims(self, x, y)

    def default_hypers(self, x=None, y=None):
        """``x`` arrives sliced to this kernel's active dims."""
        out = {}
        x = np.asarray(x, dtype=settings.floatx)
        if x.ndim == 1:
            x = x[:, None]
        ws, bs = self._init_weights(x.shape[1])
        if self.w is not None and is_param(self.w[0]):
            out.update(zip(self.w, ws))
            out.update(zip(self.b, bs))
        out.update(self.base.default_hypers_dims(self._np_features(ws, bs, x), y))
        return out

    # -- forward ------------------------------------------------------------------
    def features(self, params, x):
        """phi_w(x): (n, d_in-sliced) -> (n, widths[-1]); (R, n, width) for a
        params dict of R rows."""
        h = slice_dims(as_tensor(x), self.dims)
        last = len(self.w) - 1
        for i, (wp, bp) in enumerate(zip(self.w, self.b)):
            b = hval(bp, params)
            h = torch.matmul(h, hval(wp, params)) + b[..., None, :]
            if i < last:
                h = self.act(h)
        return h

    def cov(self, params, x1, x2=None):
        f1 = self.features(params, x1)
        f2 = None if x2 is None else self.features(params, x2)
        return self.base.cov(params, f1, f2)

    def input_sensitivity(self, params):
        """The base kernel's feature sensitivities pushed back through the
        absolute weights: s_in = |W_1| ... |W_L| s_feat."""
        s = torch.as_tensor(self.base.input_sensitivity(params), dtype=settings.dtype,
                            device=settings.device) * torch.ones(
            self.widths[-1], dtype=settings.dtype, device=settings.device)
        for wp in reversed(self.w):
            s = torch.matmul(torch.abs(hval(wp, params)), s[..., None])[..., 0]
        return s

    def has_potential(self):
        return getattr(self, "potential", None) is not None or self.base.has_potential()

    def potential_logp(self, params):
        own = Hypers.potential_logp(self, params)
        inner = self.base.potential_logp(params)
        if own is None:
            return inner
        if inner is None:
            return own
        return own + inner

    def __str__(self):
        return f"DeepKernel[{self.widths}:{self.activation} -> {self.base}]"

    __repr__ = __str__
