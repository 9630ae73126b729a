"""Vector-valued triangular transport maps (the PyTorch counterpart of
:mod:`g3py_tpu.hypers.transports`).

A Transport pushes a white-noise vector through a (triangular) map
conditioned on the inputs: elementwise transports (location, scale,
mapping), the linear kernel-Cholesky transport :class:`TKernel`,
composition with ``@`` (with the composed posterior), and the
joint-extension ``posterior`` that stacks observed and predictive blocks
and pushes noise through the joint map.

Every vector may also be a matrix of S columns, (N, S): each column is one
vector of the JAX package's, and all columns share one factorization (a
sampler pushes its S draws through one joint Cholesky instead of one a
column).  :class:`TKernel` factors through ``safe_cholesky`` (K2 on the
card) and builds its grams through the kernel's ``cov`` (K1 for the
stationary families).
"""

import torch

from . import Hypers
from ..config import settings
from .kernels import KernelSum, KernelNoise
from ..ops.linalg import safe_cholesky, solve_lower_triangular

__all__ = [
    "Transport",
    "TransportOperation",
    "TransportComposed",
    "ID",
    "TElemwise",
    "TLinear",
    "TNoLinear",
    "TLocation",
    "TScale",
    "TMapping",
    "TKernel",
    "TTriangular",
]


def _along(v, x):
    """A per-point vector ``v`` (N,) shaped to broadcast over ``x``, (N,) or
    (N, S)."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _stack(first, second):
    """[first; second] along the point axis, a vector ``first`` (N,)
    repeated over the columns of a matrix ``second`` (M, S)."""
    if second.ndim > first.ndim:
        first = first[:, None].expand(first.shape[0], second.shape[1])
    return torch.cat([first, second])


class Transport(Hypers):
    """Base transport: ``__call__(params, inputs, outputs, noise)`` pushes a
    latent vector forward; ``inv`` pulls observations back; ``diag`` is the
    marginal-scale approximation; ``logdet_dinv`` the log-Jacobian."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.parametrics = []

    def __call__(self, params, inputs, outputs, noise=False):
        raise NotImplementedError

    def diag(self, params, inputs, outputs, noise=False):
        return self(params, inputs, outputs, noise=noise)

    def inv(self, params, inputs, outputs, noise=False):
        raise NotImplementedError

    def logdet_dinv(self, params, inputs, outputs):
        raise NotImplementedError

    def posterior(self, params, space, pred, inputs, outputs, noise_pred=False,
                  noise_obs=True, diag=False):
        """Joint extension: pull the observations back to white noise, stack
        them with the predictive latent vector, push the joint vector
        through the transport on the concatenated domain, and keep the
        predictive block."""
        outputs_inv = self.inv(params, inputs, outputs, noise=True)
        inputs_space = torch.cat([inputs, space])
        pred_full = self(params, inputs_space, _stack(outputs_inv, pred), noise=True)
        return pred_full[inputs.shape[0]:]

    def check_hypers(self, parent=""):
        for p in self.parametrics:
            p.check_hypers(parent)
            self.hypers += p.hypers

    def check_dims(self, x=None):
        super().check_dims(x)
        for p in self.parametrics:
            p.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        out = {}
        for p in self.parametrics:
            out.update(p.default_hypers_dims(x, y))
        return out

    def potential_logp(self, params):
        parts = [q for q in (p.potential_logp(params) for p in self.parametrics)
                 if q is not None]
        own = super().potential_logp(params)
        if own is not None:
            parts.append(own)
        return sum(parts[1:], parts[0]) if parts else None

    def __matmul__(self, other):
        return TransportComposed(self, other)


class TransportOperation(Transport):
    def __init__(self, t1, t2):
        self.t1 = t1
        self.t2 = t2
        self.hypers = []
        self.potential = None
        self.parametrics = []
        self.op = "op"

    def check_hypers(self, parent=""):
        self.t1.check_hypers(parent=parent)
        self.t2.check_hypers(parent=parent)
        self.hypers = list(self.t1.hypers) + list(self.t2.hypers)

    def check_dims(self, x=None):
        self.t1.check_dims(x)
        self.t2.check_dims(x)

    def default_hypers_dims(self, x=None, y=None):
        return {**self.t1.default_hypers_dims(x, y), **self.t2.default_hypers_dims(x, y)}

    def potential_logp(self, params):
        parts = [p for p in (self.t1.potential_logp(params), self.t2.potential_logp(params))
                 if p is not None]
        return sum(parts[1:], parts[0]) if parts else None

    def __str__(self):
        return f"{self.t1} {self.op} {self.t2}"

    __repr__ = __str__


class TransportComposed(TransportOperation):
    """t1 after t2; the posterior of the composition is the composition of
    the posteriors: t |-GP-> X |-T2-> Z |-T1-> Y."""

    def __init__(self, t1, t2):
        super().__init__(t1, t2)
        self.op = "@"
        self.name = self.t1.name + " " + self.t2.name

    def __call__(self, params, inputs, outputs, noise=False):
        return self.t1(params, inputs, self.t2(params, inputs, outputs, noise=noise),
                       noise=noise)

    def diag(self, params, inputs, outputs, noise=False):
        return self.t1.diag(params, inputs, self.t2(params, inputs, outputs, noise=noise),
                            noise=noise)

    def inv(self, params, inputs, outputs, noise=False):
        return self.t2.inv(params, inputs, self.t1.inv(params, inputs, outputs, noise=noise),
                           noise=noise)

    def logdet_dinv(self, params, inputs, outputs):
        return (self.t2.logdet_dinv(params, inputs,
                                    self.t1.inv(params, inputs, outputs, noise=True))
                + self.t1.logdet_dinv(params, inputs, outputs))

    def posterior(self, params, space, pred, inputs, outputs, noise_pred=False,
                  noise_obs=True, diag=False):
        inner = self.t2.posterior(params, space, pred, inputs,
                                  self.t1.inv(params, inputs, outputs, noise=noise_obs),
                                  noise_pred=noise_pred, noise_obs=noise_obs, diag=diag)
        return self.t1.posterior(params, space, inner, inputs, outputs,
                                 noise_pred=noise_pred, noise_obs=noise_obs, diag=diag)


class ID(Transport):
    """Identity transport."""

    def __call__(self, params, inputs, outputs, noise=False):
        return outputs

    def inv(self, params, inputs, outputs, noise=False):
        return outputs

    def logdet_dinv(self, params, inputs, outputs):
        return torch.zeros((), dtype=settings.dtype, device=outputs.device)


class TElemwise(Transport):
    """Elementwise transports act pointwise, so their posterior extension is
    the transport on the predictive block."""

    def posterior(self, params, space, pred, inputs=None, outputs=None, noise_pred=False,
                  noise_obs=True, diag=False):
        return self(params, space, pred, noise=noise_pred)


class TLinear(Transport):
    pass


class TNoLinear(Transport):
    pass


class TLocation(TElemwise):
    """y = z + m(x)."""

    def __init__(self, location=None, x=None, name=None):
        super().__init__(x, name)
        self.location = location
        self.parametrics.append(self.location)

    def __call__(self, params, inputs, outputs, noise=False):
        return outputs + _along(self.location(params, inputs), outputs)

    def inv(self, params, inputs, outputs, noise=False):
        return outputs - _along(self.location(params, inputs), outputs)

    def logdet_dinv(self, params, inputs, outputs):
        return torch.zeros((), dtype=settings.dtype, device=outputs.device)


class TScale(TElemwise):
    """y = z * s(x)."""

    def __init__(self, scale=None, x=None, name=None):
        super().__init__(x, name)
        self.scale = scale
        self.parametrics.append(self.scale)

    def __call__(self, params, inputs, outputs, noise=False):
        return outputs * _along(self.scale(params, inputs), outputs)

    def inv(self, params, inputs, outputs, noise=False):
        return outputs / _along(self.scale(params, inputs), outputs)

    def logdet_dinv(self, params, inputs, outputs):
        return -torch.log(self.scale(params, inputs)).sum()


class TMapping(TElemwise):
    """y = T(z) for a scalar warping T."""

    def __init__(self, mapping=None, x=None, name=None):
        super().__init__(x, name)
        self.mapping = mapping
        self.parametrics.append(self.mapping)

    def __call__(self, params, inputs, outputs, noise=False):
        return self.mapping(params, outputs)

    def inv(self, params, inputs, outputs, noise=False):
        return self.mapping.inv(params, outputs)

    def logdet_dinv(self, params, inputs, outputs):
        return self.mapping.logdet_dinv(params, outputs)


class TKernel(TLinear):
    """y = chol(K(x)) z — the linear gaussian-process transport."""

    def __init__(self, kernel, noisy=False, x=None, name=None):
        super().__init__(x, name)
        self.kernel = kernel
        if noisy:
            self.noisy = KernelSum(self.kernel, KernelNoise(name="Noise" + kernel.name))
        else:
            self.noisy = kernel
        self.parametrics.append(self.noisy)

    def _chol(self, params, inputs, noise):
        k = self.noisy if noise else self.kernel
        return safe_cholesky(k.cov(params, inputs))

    def __call__(self, params, inputs, outputs, noise=False):
        return torch.matmul(self._chol(params, inputs, noise), outputs)

    def diag(self, params, inputs, outputs, noise=False):
        k = self.noisy if noise else self.kernel
        sd = torch.sqrt(torch.diagonal(k.cov(params, inputs)))
        return _along(sd, outputs) * outputs

    def inv(self, params, inputs, outputs, noise=False):
        return solve_lower_triangular(self._chol(params, inputs, noise), outputs)

    def logdet_dinv(self, params, inputs, outputs):
        cho = self._chol(params, inputs, noise=True)
        return -torch.log(torch.diagonal(cho)).sum()

    def posterior(self, params, space, pred, inputs, outputs, noise_pred=False,
                  noise_obs=True, diag=False):
        """Joint-Cholesky push-forward: whiten the observations with the
        observed block, then colour the stacked [whitened obs; pred] with
        the joint Cholesky and keep the predictive block — one joint
        factorization for all the columns of ``pred``."""
        outputs_inv = self.inv(params, inputs, outputs, noise=noise_obs)
        k_obs = (self.noisy if noise_obs else self.kernel).cov(params, inputs)
        k_space = (self.noisy if noise_pred else self.kernel).cov(params, space)
        k_cross = self.kernel.cov(params, inputs, space)
        cov = torch.cat([torch.cat([k_obs, k_cross], dim=1),
                         torch.cat([k_cross.T, k_space], dim=1)])
        pred_full = torch.matmul(safe_cholesky(cov), _stack(outputs_inv, pred))
        return pred_full[inputs.shape[0]:]


class TTriangular(TNoLinear):
    """A learned triangular generator: declared in the reference's API and
    kept as a stub, as in the JAX package."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator
        self.parametrics.append(self.generator)
