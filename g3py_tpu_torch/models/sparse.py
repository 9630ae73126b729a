"""Sparse (inducing-point) Gaussian processes: the SGPR collapsed bound (the
PyTorch counterpart of :mod:`g3py_tpu.models.sparse`).

Titsias' collapsed bound ("Variational Learning of Inducing Variables in
Sparse Gaussian Processes", AISTATS 2009) costs O(n m^2): one (m, m) gram
Kuu and one (m, n) cross gram Kuf (K1 on the card), two m x m
factorizations (K2: Kuu and B~ = s2 I + V V'), an (m, n) triangular
solve V = Luu^{-1} Kuf and the product V V' — the n x n gram is never
formed, in the bound or in its gradient.  ``loglike`` is the bound, so
``find_MAP``, ``sample_hypers`` and the scores work unchanged; a params
dict of R hyperparameter rows gives R bounds from one batched K1 launch a
gram and one batched K2 launch a factorization.  The inducing inputs are
an (m, d) hyper (k-means default, trained by gradient unless
``learn_inducing=False``).

The bound stays in the unscaled V-parametrization (B~ = s2 I + V V', the
1/s2 numerators clamped at 0): the s-scaled textbook form puts 1/s2 inside
float32 cancellations and fakes a huge bound as s2 -> 0.

The diagonal of the signal gram (the bound's trace term, the predictive
variance) comes from :func:`signal_kernel_diag`, which follows the kernel
algebra to its leaves: var for a K1 leaf (its gram's diagonal is var k(0)
= var exactly) with no launch, the diagonals of square (256, 256) block
grams for any other leaf.

``fit_svgp`` is stochastic variational training (Hensman et al. 2013) on
the uncollapsed bound: Adam (optax's update, written out) over the hypers
and a whitened q(u), or natural-gradient steps on q (``natgrad``), in a
host loop of one value-and-gradient evaluation a step.  The sharded
trainers (``mesh=``) come with ROADMAP item 16.
"""

import math

import numpy as np
import torch

from ..bayesian.advi import _Adam
from ..bayesian.density import kmeans
from ..config import settings, as_tensor
from ..hypers import Hypers, Flat, hval
from ..hypers.kernels import (KernelMax, KernelNoise, KernelProd, KernelScale, KernelShift,
                              KernelStationary, KernelSum)
from ..ops.guards import to_num, to_cov, to_bounded
from ..ops.linalg import safe_cholesky, solve_lower_triangular, solve_upper_triangular
from .elliptical import _contains_kernel_noise, _mv
from .gaussian import GaussianProcess, WarpedGaussianProcess

__all__ = ["InducingPoints", "SparseGaussianProcess", "SparseWarpedGaussianProcess",
           "select_inducing", "make_inducing", "signal_kernel_diag", "SGP", "SWGP"]

LOG2PI = math.log(2.0 * math.pi)

# reserved serving-state keys (merged into params by the Predictor, like the
# dense _state_obs_* family), all in the unscaled V = Luu^{-1} Kuf form
STATE_SGP_LUU = "_state_sgp_luu"   # chol(Kuu + jitter)              (m, m)
STATE_SGP_LBT = "_state_sgp_lbt"   # chol(B~), B~ = s2 I + V V'      (m, m)
STATE_SGP_CW = "_state_sgp_cw"     # LBt^{-1} V r                    (m,)
STATE_SGP_BT = "_state_sgp_bt"     # B~ itself (streaming updates)   (m, m)
STATE_SGP_W = "_state_sgp_w"       # V r (streaming updates)         (m,)
STATE_SGP_S2 = "_state_sgp_s2"     # noise variance snapshot         ()
STATE_SGP_Z = "_state_sgp_z"       # inducing inputs snapshot        (m, d)

#: square block of the generic diagonal route (n * 256 gram entries)
_DIAG_BLOCK = 256
_NO_MESH = ("data-parallel sparse training (mesh=) is not ported yet "
            "(ROADMAP Queue 1 item 16)")


def signal_kernel_diag(kernel, params, x, block=_DIAG_BLOCK):
    """diag K(x, x) of a signal kernel, exactly and without the n x n gram.
    The algebra is followed down to its leaves: a sum's diagonal is the sum
    of its terms', a product's the product, a maximum the maximum, a scale
    or a shift acts on its kernel's.  A K1 leaf (SE/MAT32/MAT52/RQ on
    ARD_L2) gives its amplitude, the value its gram's diagonal holds (a
    point's distance to itself is an exact 0), with no launch; any other
    leaf gives the diagonals of ceil(n / block) square (block, block) grams.
    A params dict of R rows gives (R, n)."""
    if isinstance(kernel, (KernelSum, KernelProd, KernelMax)):
        d1 = signal_kernel_diag(kernel.k1, params, x, block)
        d2 = signal_kernel_diag(kernel.k2, params, x, block)
        if isinstance(kernel, KernelSum):
            return d1 + d2
        return d1 * d2 if isinstance(kernel, KernelProd) else torch.maximum(d1, d2)
    if isinstance(kernel, (KernelScale, KernelShift)):
        inner = signal_kernel_diag(kernel.k_inner, params, x, block)
        element = hval(kernel.element, params)[..., None]
        return element * inner if isinstance(kernel, KernelScale) else element + inner
    if isinstance(kernel, KernelStationary) and kernel._gram_dispatchable() is not None:
        var = hval(kernel.var, params).expand(hval(kernel.metric.rate, params).shape[:-1])
        return var[..., None] * torch.ones(x.shape[0], dtype=var.dtype, device=var.device)
    return torch.cat([torch.diagonal(kernel.cov(params, x[lo:lo + block]), dim1=-2, dim2=-1)
                      for lo in range(0, x.shape[0], block)], dim=-1)


def make_inducing(inducing, learn_inducing=True):
    """Normalize the ``inducing=`` argument: an int (the k-means default of
    that size), an array (an explicit set) or an :class:`InducingPoints`."""
    if isinstance(inducing, InducingPoints):
        return inducing
    if np.ndim(inducing) >= 1:
        return InducingPoints(z=inducing, trainable=learn_inducing)
    return InducingPoints(m=int(inducing), trainable=learn_inducing)


def _sharded_data_layout(mesh, x_np, y_np):
    """The data-parallel row layout of the sharded trainers (item 16)."""
    raise NotImplementedError(_NO_MESH)


def _sharded_draw_factory(nloc, bs_local, full_batch):
    """The per-device minibatch draw of the sharded trainers (item 16)."""
    raise NotImplementedError(_NO_MESH)


def select_inducing(x, m, seed=0):
    """Data-driven inducing inputs: the k-means centers of ``x``
    (scikit-learn's ``KMeans(m, n_init=4, random_state=seed)``, computed by
    the port's own copy, :func:`~g3py_tpu_torch.bayesian.density.kmeans`);
    fewer points than ``m`` are tiled with a tiny jitter."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = len(x)
    if n <= m:
        # tile + tiny jitter so Kuu stays nonsingular
        reps = -(-m // n)
        rng = np.random.default_rng(seed)
        z = np.tile(x, (reps, 1))[:m]
        z = z + 1e-3 * (x.std(axis=0, keepdims=True) + 1e-6) * rng.standard_normal(z.shape)
        return z.astype(settings.floatx)
    return kmeans(x, m, n_init=4, random_state=seed)[0].astype(settings.floatx)


class InducingPoints(Hypers):
    """The (m, d) inducing inputs as a hyper-bearing component:
    ``trainable=True`` registers one flat-prior Param of shape (m, d)
    (default :func:`select_inducing`, or ``z`` when given); otherwise the
    set is fixed (``z``, or selected once from the observed inputs)."""

    def __init__(self, x=None, m=32, z=None, trainable=True, name=None):
        self.m = int(m if z is None else len(z))
        self.z_fixed = None if z is None else np.asarray(z, settings.floatx)
        self.trainable = bool(trainable)
        self.z = None  # the Param when trainable
        super().__init__(x=x, name=name if name is not None else "Inducing")

    def check_hypers(self, parent=""):
        if self.trainable and self.z is None:
            d = self.shape if isinstance(self.shape, int) else 1
            self.z = self._param(None, parent + self.name + "_z", prior=Flat(),
                                 shape=(self.m, d))

    def default_hypers(self, x=None, y=None):
        if not self.trainable:
            return {}
        if self.z_fixed is not None:
            z0 = self.z_fixed
        elif x is not None:
            z0 = select_inducing(x, self.m)
        else:
            d = self.shape if isinstance(self.shape, int) else 1
            z0 = np.zeros((self.m, d), settings.floatx)
        return {self.z.name: np.asarray(z0, settings.floatx)}

    def value(self, params, inputs=None):
        """The inducing inputs: the Param's value (trainable; (R, m, d) for
        R rows) or the fixed set."""
        if self.trainable:
            return hval(self.z, params)
        if self.z_fixed is None:
            raise ValueError("fixed inducing points need observed inputs to select from "
                             "(call observed(x, y) first)")
        return as_tensor(self.z_fixed)

    def resolve(self, inputs):
        """Select the fixed inducing set from the observed inputs (host)."""
        if not self.trainable and self.z_fixed is None and inputs is not None:
            self.z_fixed = select_inducing(np.asarray(inputs), self.m)


def _index_draws(key, steps, bs, n, device):
    """``draw(i) -> (bs,) indices`` of step i, uniform with replacement:
    from a ``torch.Generator`` on ``device`` (an int seeds one), or from a
    (steps, bs) integer array of injected draws."""
    if isinstance(key, (int, np.integer)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        key = gen
    if isinstance(key, torch.Generator):
        return lambda i: torch.randint(0, n, (bs,), generator=key, device=device)
    idx = torch.as_tensor(np.asarray(key), dtype=torch.int64, device=device)
    if idx.shape != (steps, bs):
        raise ValueError(f"injected minibatch indices of shape {tuple(idx.shape)}, "
                         f"expected ({steps}, {bs})")
    return lambda i: idx[i]


def _guard_loss(elbo):
    """-ELBO with any non-finite value read as +1e30."""
    g = settings.logp_guard
    return -to_num(elbo, nan=g, posinf=g, neginf=g)


class _SparseMixin:
    """Sparse machinery over GaussianProcess / WarpedGaussianProcess: the
    collapsed bound (and its masked form), the sparse posterior moments,
    the (Luu, LB~, cw) serving state with its O(m^2) streaming update, and
    ``fit_svgp``."""

    def __init__(self, *args, inducing=32, learn_inducing=True, **kwargs):
        self.f_inducing = make_inducing(inducing, learn_inducing)
        super().__init__(*args, **kwargs)
        kn = self.f_kernel_noise
        if not (isinstance(kn, KernelSum) and isinstance(kn.k2, KernelNoise)):
            raise ValueError(
                "sparse processes need the noisy=True KernelSum(kernel, KernelNoise) "
                "construction (the collapsed bound is defined for a gaussian noise "
                "likelihood)")
        if _contains_kernel_noise(self.f_kernel):
            raise ValueError(
                "sparse processes do not support KernelNoise terms inside the signal "
                "kernel (cross-covariances to inducing points would silently drop them)")

    # -- registration --------------------------------------------------------
    def _components(self):
        return super()._components() + [self.f_inducing]

    def observed(self, inputs=None, outputs=None, order=None, index=None, hidden=None):
        out = super().observed(inputs=inputs, outputs=outputs, order=order, index=index,
                               hidden=hidden)
        # a fixed inducing set is selected on the host from the observed inputs
        self.f_inducing.resolve(self._inputs)
        return out

    # -- shared pure pieces --------------------------------------------------
    def _noise_var(self, params):
        return torch.clamp(hval(self.f_kernel_noise.k2.var, params), min=1e-12)

    def _zval(self, params, inputs=None):
        if STATE_SGP_Z in params:
            return params[STATE_SGP_Z]
        return self.f_inducing.value(params, inputs)

    def _kernel_diag(self, params, x):
        return signal_kernel_diag(self.f_kernel, params, x)

    def _sparse_factors(self, params, inputs, w=None):
        """(z, s2, Luu, V, B~, LB~) with V = Luu^{-1} Kuf (unscaled) and
        B~ = s2 I + V V' (V's columns masked by ``w`` when given); with R
        rows, stacks from one batched K1 launch a gram and one batched K2
        launch a factorization."""
        z = self._zval(params, inputs)
        sigma2 = self._noise_var(params)
        kuu = to_cov(self.f_kernel.cov(params, z))
        kuf = to_num(self.f_kernel.cov(params, z, inputs))
        luu = safe_cholesky(kuu)
        v = solve_lower_triangular(luu, kuf)
        if w is not None:
            v = v * w[None, :]
        eye = torch.eye(v.shape[-2], dtype=v.dtype, device=v.device)
        bt = sigma2[..., None, None] * eye + torch.matmul(v, v.transpose(-1, -2))
        lbt = safe_cholesky(bt)
        return z, sigma2, luu, v, bt, lbt

    @staticmethod
    def _elbo_from_factors(sigma2, v, lbt, r, n_eff, kdiag):
        """The collapsed bound in the V-parametrization,

          log N(r | 0, Qff + s2 I) - tr(Kff - Qff) / (2 s2)
          logdet(Qff + s2 I)     = (n - m) log s2 + 2 sum log diag LB~
          r'(Qff + s2 I)^{-1} r  = (|r|^2 - |cw|^2) / s2,   cw = LB~^{-1} V r
          tr(Kff - Qff)          = sum_i max(kdiag_i - |V_:,i|^2, 0)

        both 1/s2 numerators clamped at their floor 0 (float32 cancellation
        cannot fake a +inf bound as s2 -> 0)."""
        m = v.shape[-2]
        cw = solve_lower_triangular(lbt, _mv(v, r))
        quad_num = torch.clamp((r * r).sum(dim=-1) - (cw * cw).sum(dim=-1), min=0.0)
        qdiag = (v * v).sum(dim=-2)
        trace_num = torch.clamp(kdiag - qdiag, min=0.0).sum(dim=-1)
        logdet = torch.log(torch.diagonal(lbt, dim1=-2, dim2=-1)).sum(dim=-1)
        return (-0.5 * n_eff * LOG2PI - 0.5 * (n_eff - m) * torch.log(sigma2) - logdet
                - 0.5 * (quad_num + trace_num) / sigma2)

    @staticmethod
    def _guarded(elbo, lbt, r, logdet_map):
        bad = (~torch.isfinite(lbt).all(dim=-1).all(dim=-1) | ~torch.isfinite(r).all(dim=-1)
               | ~torch.isfinite(logdet_map))
        g = settings.logp_guard
        return torch.where(bad, torch.full_like(elbo, g), to_num(elbo, nan=g, neginf=g))

    # -- collapsed bound -----------------------------------------------------
    def th_loglike_fn(self):
        """The collapsed ELBO (this process's ``loglike``) plus the warping's
        log|det dT^{-1}(y)|; non-finite pieces give ``settings.logp_guard``."""
        mapping = self.f_mapping
        location = self.f_location

        def fn(params, space, inputs, outputs):
            r = to_num(mapping.inv(params, outputs)) - location(params, inputs)
            logdet_map = mapping.logdet_dinv(params, outputs)
            _, sigma2, _, v, _, lbt = self._sparse_factors(params, inputs)
            kdiag = self._kernel_diag(params, inputs)
            elbo = self._elbo_from_factors(sigma2, v, lbt, r, inputs.shape[0], kdiag) \
                + logdet_map
            return self._guarded(elbo, lbt, r, logdet_map)

        return fn

    def th_loglike_masked_fn(self):
        """The collapsed bound of the included subset ``fn(params, inputs,
        outputs, w)`` at one static shape: excluded columns of V and entries
        of r and diag(Kff) are zeroed."""
        mapping = self.f_mapping
        location = self.f_location

        def fn(params, inputs, outputs, w):
            w = as_tensor(w)
            r = (to_num(mapping.inv(params, outputs)) - location(params, inputs)) * w
            logdet_map = (mapping.logdet_dinv_elem(params, outputs) * w).sum(dim=-1)
            _, sigma2, _, v, _, lbt = self._sparse_factors(params, inputs, w=w)
            kdiag = self._kernel_diag(params, inputs) * w
            elbo = self._elbo_from_factors(sigma2, v, lbt, r, w.sum(), kdiag) + logdet_map
            return self._guarded(elbo, lbt, r, logdet_map)

        return fn

    # -- sparse posterior moments -------------------------------------------
    def _predict_pieces(self, params, space, inputs, outputs):
        """(tmp1, u2, cw, s2): tmp1 = Luu^{-1} Kus, u2 = LB~^{-1} tmp1, cw =
        LB~^{-1} V r — from the serving state when present, recomputed
        otherwise.  mean* = loc + u2' cw, cov* = Kss - tmp1' tmp1 + s2 u2' u2."""
        if STATE_SGP_LBT in params:
            z, luu = params[STATE_SGP_Z], params[STATE_SGP_LUU]
            lbt, cw, sigma2 = params[STATE_SGP_LBT], params[STATE_SGP_CW], params[STATE_SGP_S2]
        else:
            z, sigma2, luu, v, _, lbt = self._sparse_factors(params, inputs)
            r = to_num(self.f_mapping.inv(params, outputs)) - self.f_location(params, inputs)
            cw = solve_lower_triangular(lbt, _mv(v, r))
        tmp1 = solve_lower_triangular(luu, to_num(self.f_kernel.cov(params, z, space)))
        return tmp1, solve_lower_triangular(lbt, tmp1), cw, sigma2

    def _sparse_mean_var(self, params, space, inputs, outputs):
        tmp1, u2, cw, sigma2 = self._predict_pieces(params, space, inputs, outputs)
        loc = self.f_location(params, space) + (u2 * cw[..., None]).sum(dim=-2)
        latent = to_bounded(self._kernel_diag(params, space) - (tmp1 * tmp1).sum(dim=-2)
                            + sigma2[..., None] * (u2 * u2).sum(dim=-2), 0.0)
        return loc, latent

    def _posterior_location(self, params, space, inputs, outputs, noise):
        return self._sparse_mean_var(params, space, inputs, outputs)[0]

    def _posterior_kernel(self, params, space, inputs, outputs, noise):
        tmp1, u2, _, sigma2 = self._predict_pieces(params, space, inputs, outputs)
        out = (self.f_kernel.cov(params, space) - torch.matmul(tmp1.transpose(-1, -2), tmp1)
               + sigma2[..., None, None] * torch.matmul(u2.transpose(-1, -2), u2))
        if noise:
            out = out + torch.diag_embed(self._noise_diag(params, space))
        return out

    def _posterior_kernel_diag(self, params, space, inputs, outputs, noise):
        latent = self._sparse_mean_var(params, space, inputs, outputs)[1]
        return latent + self._noise_diag(params, space) if noise else latent

    def _latent_moments(self, params, space, inputs, outputs, prior=False):
        """``(location, latent variance, noise variance)`` of the sparse
        posterior from one (m, s) cross gram (the Predictor's fused path)."""
        if prior:
            return super()._latent_moments(params, space, inputs, outputs, prior=True)
        loc, latent = self._sparse_mean_var(params, space, inputs, outputs)
        return loc, latent, self._noise_diag(params, space)

    # -- serving state -------------------------------------------------------
    def _posterior_state_pure(self, p, inputs, outputs):
        """The sparse serving state: O(n m^2) once, then every statistic of
        a query batch of s points is O(s m^2)."""
        with torch.no_grad():
            z, sigma2, luu, v, bt, lbt = self._sparse_factors(p, inputs)
            r = to_num(self.f_mapping.inv(p, outputs)) - self.f_location(p, inputs)
            w_vec = _mv(v, r)
            cw = solve_lower_triangular(lbt, w_vec)
        return {STATE_SGP_Z: z, STATE_SGP_LUU: luu, STATE_SGP_LBT: lbt, STATE_SGP_CW: cw,
                STATE_SGP_BT: bt, STATE_SGP_W: w_vec, STATE_SGP_S2: sigma2}

    def _posterior_state_update_pure(self, p, state, x_old, x_new, y_new):
        """O(m^2 (m + batch)) streaming update: the new columns of V
        rank-update B~ and V r, then one m x m factorization (K2)."""
        with torch.no_grad():
            z, luu = state[STATE_SGP_Z], state[STATE_SGP_LUU]
            v_new = solve_lower_triangular(luu, to_num(self.f_kernel.cov(p, z, x_new)))
            r_new = to_num(self.f_mapping.inv(p, y_new)) - self.f_location(p, x_new)
            bt = state[STATE_SGP_BT] + torch.matmul(v_new, v_new.transpose(-1, -2))
            w_vec = state[STATE_SGP_W] + _mv(v_new, r_new)
            lbt = safe_cholesky(bt)
            cw = solve_lower_triangular(lbt, w_vec)
        return {STATE_SGP_Z: z, STATE_SGP_LUU: luu, STATE_SGP_LBT: lbt, STATE_SGP_CW: cw,
                STATE_SGP_BT: bt, STATE_SGP_W: w_vec, STATE_SGP_S2: state[STATE_SGP_S2]}

    # -- stochastic (minibatch) training: SVGP --------------------------------
    def _svgp_batch_pieces(self):
        """``fn(p, xb, yb) -> (vb, tb, locb, logdet_elem, kdiag_b, s2)``
        with vb = Luu^{-1} K(z, xb) (m, |B|): O(|B| m^2)."""
        mapping, location, kernel = self.f_mapping, self.f_location, self.f_kernel

        def fn(p, xb, yb):
            z = self._zval(p)
            luu = safe_cholesky(to_cov(kernel.cov(p, z)))
            vb = solve_lower_triangular(luu, to_num(kernel.cov(p, z, xb)))
            return (vb, to_num(mapping.inv(p, yb)), location(p, xb),
                    mapping.logdet_dinv_elem(p, yb), self._kernel_diag(p, xb),
                    self._noise_var(p))

        return fn

    def fit_svgp(self, batch_size=1024, steps=2000, lr=1e-2, start=None, key=0, display=True,
                 natgrad=None, mesh=None):
        """Stochastic variational training (Hensman et al. 2013) on the
        uncollapsed bound

          n/|B| sum_{i in B} E_q[log N(t_i | f_i, s2)] - KL(q(u) || p(u))
          + n/|B| sum_{i in B} log det dT^{-1}(y_i) + log p(hypers)

        with a whitened q(u) = N(Luu (mq + eps), Luu Lq Lq' Luu'): Adam over
        the hypers and (mq, Lq), one value-and-gradient evaluation a step,
        O(|B| m^2).  ``natgrad=rho`` moves q's natural parameters a fraction
        rho toward the minibatch's closed-form stationary point (Lambda =
        I + (n/|B|) V_B V_B' / s2, nu = (n/|B|) V_B r_B / s2) and Adam
        trains the hypers only; rho=1 at |B|=n reaches the collapsed
        optimum in one step.  ``batch_size >= n`` is the deterministic full
        batch; otherwise each step draws |B| rows with replacement: ``key``
        is a seed (a ``torch.Generator`` on ``settings.device``), a
        ``torch.Generator`` or a (steps, |B|) integer array of the draws.
        Returns ``(params, losses)``: the trained natural-space hypers and
        the per-step negative ELBO (before each update)."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        rho = None
        if natgrad is not None:
            rho = float(natgrad)
            if not 0.0 < rho <= 1.0:
                raise ValueError("natgrad must be a step size in (0, 1]")
        reg = self.active
        if start is None:
            start = self.params_default
        u0 = as_tensor(reg.dict_to_array(start))
        x_all, y_all = self._device_data("inputs"), self._device_data("outputs")
        n, m, nd = x_all.shape[0], self.f_inducing.m, u0.shape[0]
        bs = int(min(batch_size, n))
        scale = n / bs
        full = bs >= n  # deterministic: with-replacement draws at bs = n would bias the bound
        draw = None if full else _index_draws(key, steps, bs, n, x_all.device)
        prior_pure = self._logp_pure(prior=True)
        pieces = self._svgp_batch_pieces()
        eye = torch.eye(m, dtype=u0.dtype, device=u0.device)

        def batch(i):
            if full:
                return x_all, y_all
            idx = draw(i)
            return x_all[idx], y_all[idx]

        def bound(p, xb, yb, pc, mq, vsv):
            """The data terms and the hyper prior at q's mean ``mq`` and
            per-row variance ``vsv`` (the KL is the caller's)."""
            vb, tb, locb, logdet_e, kdiag_b, sigma2 = pc
            mf = locb + torch.matmul(vb.T, mq)
            varf = torch.clamp(kdiag_b - (vb * vb).sum(dim=0), min=0.0) + vsv
            exp_ll = (-0.5 * LOG2PI - 0.5 * torch.log(sigma2)
                      - ((tb - mf) ** 2 + varf) / (2.0 * sigma2))
            return scale * (exp_ll.sum() + logdet_e.sum()) + prior_pure(p, xb, xb, yb)

        losses = torch.empty(int(steps), dtype=u0.dtype, device=u0.device)
        if rho is None:
            theta = torch.cat([u0, u0.new_zeros(m + m * m + m)])
            opt = _Adam(theta, lr)
            for i in range(int(steps)):
                xb, yb = batch(i)
                with torch.enable_grad():
                    th = theta.detach().requires_grad_(True)
                    mq, ld = th[nd:nd + m], th[nd + m + m * m:]
                    lq = torch.tril(th[nd + m:nd + m + m * m].reshape(m, m), -1) \
                        + torch.diag(torch.exp(ld))
                    p = reg.array_to_dict_tensor(th[:nd])
                    pc = pieces(p, xb, yb)
                    vsv = (torch.matmul(lq.T, pc[0]) ** 2).sum(dim=0)
                    kl = 0.5 * ((mq * mq).sum() + (lq * lq).sum() - 2.0 * ld.sum() - m)
                    loss = _guard_loss(bound(p, xb, yb, pc, mq, vsv) - kl)
                    (g,) = torch.autograd.grad(loss, th)
                losses[i] = loss.detach()
                theta = opt.step(theta, g)
            u = theta[:nd]
        else:
            nat1, nat2, u = u0.new_zeros(m), eye.clone(), u0
            opt = _Adam(u, lr)
            for i in range(int(steps)):
                xb, yb = batch(i)
                with torch.enable_grad():
                    uu = u.detach().requires_grad_(True)
                    p = reg.array_to_dict_tensor(uu)
                    # the minibatch's pieces once: the natural step reads
                    # them detached, the bound at the moved q differentiates
                    pc = pieces(p, xb, yb)
                    vb, tb, locb = (t.detach() for t in pc[:3])
                    c = scale / pc[5].detach()
                    nat2 = (1.0 - rho) * nat2 + rho * (eye + c * torch.matmul(vb, vb.T))
                    nat1 = (1.0 - rho) * nat1 + rho * (c * torch.matmul(vb, tb - locb))
                    cl = safe_cholesky(nat2)
                    mq = solve_upper_triangular(cl.T, solve_lower_triangular(cl, nat1))
                    vsv = (solve_lower_triangular(cl, pc[0]) ** 2).sum(dim=0)
                    ci = solve_lower_triangular(cl, eye)
                    kl = 0.5 * ((mq * mq).sum() + (ci * ci).sum()
                                + 2.0 * torch.log(torch.diagonal(cl)).sum() - m)
                    loss = _guard_loss(bound(p, xb, yb, pc, mq, vsv) - kl)
                    (g,) = torch.autograd.grad(loss, uu)
                losses[i] = loss.detach()
                u = opt.step(u, g)
        losses = losses.cpu().numpy()
        if display:
            mode = "adam" if rho is None else f"natgrad rho={natgrad}"
            print(f"fit_svgp[{mode}]: {steps} steps, -elbo {losses[0]:.1f} -> "
                  f"{losses[-1]:.1f} (batch {bs}, n {n})")
        return reg.array_to_dict(u.detach().cpu().numpy()), losses

    def _fit_svgp_sharded(self, mesh, **kwargs):
        raise NotImplementedError(_NO_MESH)


class SparseGaussianProcess(_SparseMixin, GaussianProcess):
    """SGPR: sparse variational GP regression with the collapsed bound.

    >>> sgp = g3t.SGP(space=x, location=g3t.Bias(), kernel=g3t.SE(x), inducing=64)
    >>> sgp.observed(x, y)
    >>> params = sgp.find_MAP()      # hypers AND inducing inputs by gradient
    >>> pr = sgp.predictor(params)   # the (Luu, LB~, cw) state, O(n m^2) once
    """

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "SGP")
        super().__init__(*args, **kwargs)


class SparseWarpedGaussianProcess(_SparseMixin, WarpedGaussianProcess):
    """Warped-observation SGPR: the collapsed bound on the latent T^{-1}y
    plus the warping Jacobian; moments by Gauss-Hermite over the sparse
    latent posterior."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "SWGP")
        super().__init__(*args, **kwargs)


SGP = SparseGaussianProcess
SWGP = SparseWarpedGaussianProcess
