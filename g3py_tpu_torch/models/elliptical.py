"""EllipticalProcess — shared posterior math of the GP and Student-t
families (the PyTorch counterpart of :mod:`g3py_tpu.models.elliptical`,
subset).

Owns a location Mean, a Kernel (wrapped with an additive KernelNoise when
``noisy=True``), a Mapping warping and, for the Student-t family, a
Freedom degree hyper (``freedom``: nu, and nu + n on the posterior).  The
posterior goes through one robust Cholesky of the observed gram:

  location* = m(s) + K_si Kii^{-1} (T^{-1}y - m(i))
  var*      = k_ss - colsum((L^{-1} K_is)^2)      (clamped at 0)
  cov*      = K_ss - (L^{-1} K_is)^T (L^{-1} K_is)

and every statistic has a prior branch (``prior=True``: the moments of
m and K at the space, before the observations).

``posterior_state`` factors the observed gram once into ``(L^{-1}, alpha,
z)``, with L^{-1} seeded by the factorization's panel inverses; carried in
a params dict under the reserved ``_state_*`` keys it turns every query
into products with that state (the serving fast path,
:class:`~g3py_tpu_torch.models.predictor.Predictor`).

Every piece takes a params dict of R hyperparameter rows as well: the
state is then stacked (R, n, n), (R, n), (R, n), from one batched K2
factorization (:meth:`posterior_state_rows`), and every statistic gains a
leading row axis — the Bayesian model average of a datatrace
(:meth:`averaged_predictor`, ``batch_predict``, ``average``) and one draw
a row (``batch_sample``).  A state extends to new observations by the
block-Cholesky identity (:meth:`_posterior_state_update_pure`, behind
``Predictor.updated``), and :meth:`_noncentered_sampling_shear` is the
non-centered reparameterization of ``sample_hypers``.
"""

import numpy as np
import torch

from ..hypers import LogTransform, hval
from ..hypers.kernels import KernelSum, KernelNoise, KernelStationary
from ..hypers.means import Zero
from ..hypers.mappings import Identity
from ..config import as_tensor, settings
from ..bayesian.models import _host
from ..ops.guards import to_cov, to_num, to_bounded
from ..ops.linalg import (safe_cholesky, safe_cholesky_panels, trtri_from_panels,
                          solve_lower_triangular, cho_solve)
from .stochastic import StochasticProcess, _statistic

__all__ = ["EllipticalProcess", "STATE_OBS_LINV", "STATE_OBS_ALPHA", "STATE_OBS_Z"]

STATE_OBS_LINV = "_state_obs_linv"     # L^{-1} of chol(K_obs + noise)
STATE_OBS_ALPHA = "_state_obs_alpha"   # K^{-1} (T^{-1}y - m)
STATE_OBS_Z = "_state_obs_z"           # L^{-1} (T^{-1}y - m)


def _mv(mat, vec):
    """``mat @ vec`` for a matrix and a vector, or stacks of them."""
    if vec.ndim == 1:
        return torch.matmul(mat, vec)
    return torch.matmul(mat, vec[..., None])[..., 0]


def _diag(m):
    return torch.diagonal(m, dim1=-2, dim2=-1)


def _contains_kernel_noise(kernel, kinds=KernelNoise):
    """True when a KernelNoise term (or one of ``kinds``) hides anywhere in
    a kernel tree."""
    stack = [kernel]
    while stack:
        k = stack.pop()
        if isinstance(k, kinds):
            return True
        stack.extend(sub for sub in (getattr(k, a, None) for a in ("k1", "k2", "k_inner"))
                     if sub is not None)
    return False


class EllipticalProcess(StochasticProcess):
    def __init__(self, space=None, location=None, kernel=None, mapping=None, degree=None,
                 noisy=True, var_noise=None, **kwargs):
        self.f_location = location if location is not None else Zero()
        self.f_degree = degree
        self.f_mapping = mapping if mapping is not None else Identity()
        self.f_kernel = kernel
        if noisy:
            self.f_kernel_noise = KernelSum(
                self.f_kernel, KernelNoise(name="Noise", var=var_noise))
        else:
            self.f_kernel_noise = self.f_kernel
        super().__init__(space=space, **kwargs)

    # -- registration ----------------------------------------------------------
    def _components(self):
        comps = [self.f_location, self.f_kernel_noise, self.f_mapping]
        if self.f_degree is not None:
            comps.append(self.f_degree)
        return comps

    def _check_hypers(self):
        for comp in self._components():
            comp.check_dims(None if comp is self.f_degree else self.inputs)
        for comp in self._components():
            comp.check_hypers(self.name + "_")

    def default_hypers(self):
        x, y = self.inputs, self.outputs
        out = {}
        for comp in self._components():
            out.update(comp.default_hypers_dims(x, y))
        return out

    def _noncentered_sampling_shear(self):
        """Non-centered reparameterization for ``sample_hypers(reparam=
        'noncentered')``: every amplitude hyper (``<name>_*_var`` on a log
        transform) is sampled relative to the data scale, the unit-Jacobian
        shear

            theta_var = v_var + log Var[g^{-1}(y; v_mapping)]

        of the unconstrained vector (the shifted dims never feed the shift,
        so the map is unit lower-triangular and the density needs no
        correction).  Returns ``(shear, unshear)`` over (R, nsampling)
        tensors of the sampling dims, or None when no amplitude hyper is
        sampled."""
        reg = self.active
        slices = reg.slices()
        prefix = self.name + "_"
        dims_full = []
        for p in reg.ordered_params:
            if (p.name.startswith(prefix) and p.name.endswith("_var")
                    and isinstance(p.prior.transform, LogTransform)):
                s0, s1, _ = slices[p.name]
                dims_full.extend(range(s0, s1))
        sampling = list(reg.sampling_dims)
        pos = {d: i for i, d in enumerate(sampling)}
        tgt = [pos[d] for d in dims_full if d in pos]
        if not tgt:
            return None
        full = as_tensor(reg.dict_to_array(reg.params))
        sdims = torch.as_tensor(sampling, device=full.device)
        tgt = torch.as_tensor(tgt, device=full.device)
        y = self._device_data("outputs")

        def logscale(v):
            if len(sampling) == reg.ndim:
                u = v
            else:
                u = full.expand(v.shape[:-1] + full.shape).clone()
                u[..., sdims] = v
            z = self.f_mapping.inv(reg.array_to_dict_tensor(u), y)
            var = torch.var(z, dim=-1, unbiased=False)
            return torch.log(torch.clamp(var, min=1e-20))

        def shifted(v, sign):
            out = v.clone()
            out[..., tgt] = out[..., tgt] + sign * logscale(v)[..., None]
            return out

        def shear(v):
            return shifted(v, 1.0)

        def unshear(v):
            # the mapping dims are untouched by the shear, so the shift at
            # theta equals the shift at v
            return shifted(v, -1.0)

        return shear, unshear

    # -- shared math -------------------------------------------------------------
    def _latent_obs(self, params, outputs):
        """T^{-1} y."""
        return to_num(self.f_mapping.inv(params, outputs))

    def _obs_chol(self, params, inputs):
        """Robust Cholesky of the (noisy) observed gram."""
        return safe_cholesky(to_cov(self.f_kernel_noise.cov(params, inputs)))

    # -- the band-sharded (multi-rank) objective ---------------------------------
    def _distributed_parts(self, mesh=None, axis="dp", what="nll_distributed"):
        """``(mesh, cov_fn, noise_fn)`` of every band-sharded consumer
        (training objectives, serving), after the checks they share: n
        divisible by the mesh, the noisy=True construction and no
        KernelNoise inside the signal kernel."""
        from ..parallel.cholesky import _resolve_mesh

        mesh = _resolve_mesh(mesh, axis)
        n_dev = mesh.shape[axis]
        n_obs = len(self.inputs) if self.inputs is not None else 0
        if n_obs == 0 or n_obs % n_dev:
            raise ValueError(
                f"{what}: n={n_obs} observations must divide evenly over the {n_dev}-device "
                "mesh (subset/pad the training data or use a mesh whose size divides n)")
        kn = self.f_kernel_noise
        if not (isinstance(kn, KernelSum) and isinstance(kn.k2, KernelNoise)):
            raise ValueError(f"{what} needs the noisy=True KernelSum(kernel, KernelNoise) "
                             "construction")
        if _contains_kernel_noise(self.f_kernel):
            # the band gram is built from CROSS covariances (x_band vs x): a
            # KernelNoise term inside the signal kernel adds 0 there
            raise ValueError(f"{what} does not support KernelNoise terms inside the signal "
                             "kernel (the band gram sees only cross-covariances)")
        kernel, noise_hyper = self.f_kernel, kn.k2.var
        return mesh, kernel.cov, lambda p: hval(noise_hyper, p)

    def _distributed_qld(self, mesh=None, block=None, axis="dp"):
        """The band-sharded ``fn(params, x, resid) -> (quad, logdet_half)``
        (:func:`~g3py_tpu_torch.parallel.cholesky.distributed_quad_logdet`)
        behind the families' ``nll_distributed``."""
        from ..parallel.cholesky import distributed_quad_logdet

        mesh, cov_fn, noise_fn = self._distributed_parts(mesh, axis)
        return distributed_quad_logdet(cov_fn, mesh=mesh, block=block, axis=axis,
                                       noise_fn=noise_fn)

    def _distributed_resid(self, params):
        """``(params, x, outputs, resid)`` of ``nll_distributed``: params
        as device tensors, the observed data and T^{-1}y - m(x)."""
        params = {k: as_tensor(v) for k, v in
                  self.filter_params(self.params if params is None else params).items()}
        x = self._device_data("inputs")
        outputs = self._device_data("outputs")
        return params, x, outputs, self._latent_obs(params, outputs) - self.f_location(params, x)

    def posterior_state(self, params=None):
        """Factor the observed gram ONCE: a dict of ``_state_*`` device
        tensors (L^{-1} of the observed-gram Cholesky, alpha =
        K^{-1}(T^{-1}y - m) and the whitened residual z), valid for exactly
        these params and the current observed data."""
        if not self.is_observed:
            raise ValueError("posterior_state needs observed data "
                             "(call observed(x, y) first)")
        p = self._tensor_params(self.params if params is None else params)
        _, inputs, outputs = self._resolve_data(None, None, None)
        return self._posterior_state_pure(p, inputs, outputs)

    def _posterior_state_pure(self, p, inputs, outputs):
        """The state of a params dict of tensors (one row, or a stack of R
        rows: every factorization of the stack in one batched K2 call)."""
        with torch.no_grad():
            # L^{-1} from the panel inverses of the same factorization
            chol, dinv, _ = safe_cholesky_panels(
                to_cov(self.f_kernel_noise.cov(p, inputs)))
            linv = trtri_from_panels(chol, dinv)
            resid = self._latent_obs(p, outputs) - self.f_location(p, inputs)
            resid = resid.expand(linv.shape[:-1])
            z = _mv(linv, resid)
            alpha = _mv(linv.transpose(-1, -2), z)
        return {STATE_OBS_LINV: linv, STATE_OBS_ALPHA: alpha, STATE_OBS_Z: z}

    def _posterior_state_update_pure(self, p, state, x_old, x_new, y_new):
        """The state of the observed data extended by ``m`` new
        observations, from the state of the old ones, with no n x n
        factorization.  Block-Cholesky identity: with L_aug = [[L, 0],
        [C, S]], C = K_new,X L^{-T} and S = chol(K_newnew - C C^T),

          linv_aug  = [[L^{-1}, 0], [-S^{-1} C L^{-1}, S^{-1}]]
          z_aug     = [z, S^{-1}(r_new - C z)]
          alpha_aug = linv_aug^T z_aug

        — one cross gram (m, n) and one m x m gram through K1, one m x m
        factorization through K2 (``safe_cholesky``)."""
        with torch.no_grad():
            linv, z = state[STATE_OBS_LINV], state[STATE_OBS_Z]
            m, n = x_new.shape[0], linv.shape[-1]
            k_cross = to_num(self.f_kernel_noise.cov(p, x_new, x_old))   # (m, n)
            k_new = to_cov(self.f_kernel_noise.cov(p, x_new))             # (m, m)
            c = torch.matmul(k_cross, linv.T)                              # (m, n)
            s_chol = safe_cholesky(k_new - torch.matmul(c, c.T))
            s_inv = solve_lower_triangular(
                s_chol, torch.eye(m, dtype=s_chol.dtype, device=s_chol.device))
            r_new = self._latent_obs(p, y_new) - self.f_location(p, x_new)
            z_b = torch.matmul(s_inv, r_new - torch.matmul(c, z))
            linv_aug = torch.zeros((n + m, n + m), dtype=linv.dtype, device=linv.device)
            linv_aug[:n, :n] = linv
            linv_aug[n:, :n] = -torch.matmul(s_inv, torch.matmul(c, linv))
            linv_aug[n:, n:] = s_inv
            z_aug = torch.cat([z, z_b])
            alpha_aug = torch.matmul(linv_aug.T, z_aug)
        return {STATE_OBS_LINV: linv_aug, STATE_OBS_ALPHA: alpha_aug, STATE_OBS_Z: z_aug}

    def posterior_state_rows(self, rows, inputs=None, outputs=None):
        """``(params, state)`` of an (R, ndim) matrix of unconstrained
        parameter rows: the natural-space params dict with a leading row
        axis, and the stacked posterior states, factored together (the
        counterpart of the JAX package's ``vmap`` of
        ``_posterior_state_pure``)."""
        if not self.is_observed and inputs is None:
            raise ValueError("posterior_state_rows needs observed data "
                             "(call observed(x, y) first)")
        _, inputs, outputs = self._resolve_data(None, inputs, outputs)
        rows = as_tensor(rows)
        if rows.ndim != 2 or rows.shape[1] != self.active.ndim:
            raise ValueError(f"posterior_state_rows: rows of shape {tuple(rows.shape)}, "
                             f"expected (R, {self.active.ndim})")
        p = self.active.array_to_dict_tensor(rows)
        return p, self._posterior_state_pure(p, inputs, outputs)

    def predictor(self, params=None):
        """Serving fast path: a :class:`~g3py_tpu_torch.models.predictor.
        Predictor` bound to these params and the current observed data."""
        from .predictor import Predictor
        return Predictor(self, params=params)

    def averaged_predictor(self, datatrace, max_rows=64):
        """Serving fast path for the Bayesian model average: factor the
        posterior once per datatrace row (one batched K2 call for all the
        rows), then serve row-averaged statistics as batched products
        (:class:`~g3py_tpu_torch.models.predictor.AveragedPredictor`)."""
        from .predictor import AveragedPredictor
        return AveragedPredictor(self, datatrace, max_rows=max_rows)

    def clustered_predictors(self, datatrace, max_rows=64):
        """One :class:`~g3py_tpu_torch.models.predictor.AveragedPredictor`
        per posterior cluster, ``{label: predictor}`` ordered by label: the
        datatrace needs the ``_cluster`` column (set by clustering, or by
        hand)."""
        from .predictor import AveragedPredictor
        if "_cluster" not in datatrace:
            raise ValueError("datatrace has no _cluster column — run "
                             "cluster_datatrace(process, dt) first")
        labels = datatrace["_cluster"]
        return {int(c): AveragedPredictor(self, datatrace[labels == c], max_rows=max_rows)
                for c in np.unique(labels)}

    def _batch_statistics(self, rows, space, inputs, outputs, prior=False, **flags):
        """Statistics of every row of ``rows`` at ``space``, each with a
        leading row axis (the hook of ``batch_predict``): the posterior's
        from one batched factorization, or with ``prior`` the prior's."""
        from .predictor import statistics
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        if prior:
            params = self.active.array_to_dict_tensor(as_tensor(rows))
        else:
            params, state = self.posterior_state_rows(rows, inputs, outputs)
            params = {**params, **state}
        return statistics(self, params, space, inputs, outputs, prior=prior, batch=True,
                          **flags)

    def _batch_draws(self, rows, rand, space, inputs, outputs, prior=False, noise=False):
        """The hook of ``batch_sample``: T(loc + chol(cov) rand) for every
        row, the posterior states of all rows from one batched
        factorization, their (R, m, m) covariances from another; ``rand``
        (R, m) holds the rows' latent innovations."""
        space, inputs, outputs = self._resolve_data(space, inputs, outputs)
        with torch.no_grad():
            if prior:
                p = self.active.array_to_dict_tensor(as_tensor(rows))
            else:
                p, state = self.posterior_state_rows(rows, inputs, outputs)
                p = {**p, **state}
            loc = self.th_location(prior=prior, noise=noise)(p, space, inputs, outputs, None)
            cho = self.th_cholesky(prior=prior, noise=noise)(p, space, inputs, outputs, None)
            latent = loc.expand(rand.shape) + _mv(cho, as_tensor(rand))
            return self.f_mapping(p, latent)

    def _whitened_cross(self, params, inputs, cross):
        """v = L^{-1} K_is — a product with the state's inverse when one
        rides in ``params``, a triangular solve otherwise."""
        if STATE_OBS_LINV in params:
            return torch.matmul(params[STATE_OBS_LINV], cross.transpose(-1, -2))
        return solve_lower_triangular(self._obs_chol(params, inputs), cross.T)

    def _location_from_cross(self, params, space, inputs, outputs, cross):
        if STATE_OBS_ALPHA in params:
            alpha = params[STATE_OBS_ALPHA]
        else:
            chol = self._obs_chol(params, inputs)
            resid = self._latent_obs(params, outputs) - self.f_location(params, inputs)
            alpha = cho_solve(chol, resid)
        return self.f_location(params, space) + _mv(cross, alpha)

    def _latent_var_from_cross(self, params, space, inputs, cross):
        """``k_ss - v'v`` clamped at 0: f32 cancellation lands it a few ulp
        negative where the space meets the observed inputs."""
        v = self._whitened_cross(params, inputs, cross)
        return to_bounded(self._query_diag(params, space) - (v * v).sum(dim=-2), 0.0)

    def _query_diag(self, params, space):
        """The diagonal of the signal kernel's gram at ``space``.  A K1
        kernel's is its amplitude, var k(0) = var, the value its gram's
        diagonal holds (the distance of a point to itself is an exact 0),
        with no launch; any other kernel's is read off its gram."""
        k = self.f_kernel
        if isinstance(k, KernelStationary) and k._gram_dispatchable() is not None:
            var = hval(k.var, params).expand(hval(k.metric.rate, params).shape[:-1])
            return var[..., None] * torch.ones(space.shape[0], dtype=var.dtype,
                                               device=var.device)
        return _diag(k.cov(params, space))

    def _posterior_location(self, params, space, inputs, outputs, noise):
        kernel = self.f_kernel_noise if noise else self.f_kernel
        cross = to_num(kernel.cov(params, space, inputs))
        return self._location_from_cross(params, space, inputs, outputs, cross)

    def _posterior_kernel(self, params, space, inputs, outputs, noise):
        """The full posterior covariance over ``space`` (m, m)."""
        kernel = self.f_kernel_noise if noise else self.f_kernel
        cross = to_num(kernel.cov(params, space, inputs))
        v = self._whitened_cross(params, inputs, cross)
        return kernel.cov(params, space) - torch.matmul(v.transpose(-1, -2), v)

    def _posterior_kernel_diag(self, params, space, inputs, outputs, noise):
        """Posterior variance diagonal: the latent part is clamped at 0 and
        the noise variance is added separately, so the noisy variance never
        drops below the noise floor."""
        cross = to_num(self.f_kernel.cov(params, space, inputs))
        latent = self._latent_var_from_cross(params, space, inputs, cross)
        if noise:
            return latent + self._noise_diag(params, space)
        return latent

    def _noise_diag(self, params, space):
        """Diagonal of the noise-only kernel, taken from the noise term
        itself: ``diag(K + s2 I) - diag(K)`` would lose the noise to f32
        absorption when the signal variance dwarfs it."""
        kn = self.f_kernel_noise
        if kn is self.f_kernel:
            return torch.zeros(space.shape[0], dtype=space.dtype, device=space.device)
        if isinstance(kn, KernelSum) and kn.k1 is self.f_kernel:
            return to_bounded(_diag(kn.k2.cov(params, space)), 0.0)
        return to_bounded(_diag(kn.cov(params, space))
                          - _diag(self.f_kernel.cov(params, space)), 0.0)

    def _latent_moments(self, params, space, inputs, outputs, prior=False):
        """``(location, latent variance, noise variance)`` of the posterior
        from ONE cross gram — the fused path of the Predictor — or with
        ``prior`` of the prior.  The noisy location equals the noise-free
        one: the noise term adds exactly 0 to every cross covariance."""
        if prior:
            return (self.f_location(params, space),
                    to_bounded(_diag(self.f_kernel.cov(params, space)), 0.0),
                    self._noise_diag(params, space))
        cross = to_num(self.f_kernel.cov(params, space, inputs))
        return (self._location_from_cross(params, space, inputs, outputs, cross),
                self._latent_var_from_cross(params, space, inputs, cross),
                self._noise_diag(params, space))

    def _warped_moments(self, params, loc, var):
        """(mean, variance) of the observed process given latent moments."""
        return self.f_mapping(params, loc), var

    def _moments_fn(self, params, inputs, outputs, prior=False):
        """``(loc, var) -> (mean, variance)`` of the observed process at
        these params (the Student-t process also scales the variance)."""
        return lambda loc, var: self._warped_moments(params, loc, var)

    # -- selector th_* quantities ------------------------------------------------
    def th_freedom(self, prior=False, noise=False):
        """Degrees of freedom: nu on the prior, nu + n on the posterior
        (None without a Freedom hyper)."""
        if self.f_degree is None:
            return None
        deg = self.f_degree
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return deg(params)
        else:
            def fn(params, space, inputs, outputs, vector):
                return deg(params) + inputs.shape[0]
        return fn

    def th_mapping(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            # forward warping of an arbitrary latent vector
            return self.f_mapping(params, vector)
        return fn

    def th_mapping_inv(self, prior=False, noise=False):
        def fn(params, space, inputs, outputs, vector):
            return self._latent_obs(params, outputs)
        return fn

    def th_location(self, prior=False, noise=False):
        if prior:
            def fn(params, space, inputs, outputs, vector):
                return self.f_location(params, space)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._posterior_location(params, space, inputs, outputs, noise)
        return fn

    def th_kernel(self, prior=False, noise=False):
        if prior:
            kernel = self.f_kernel_noise if noise else self.f_kernel

            def fn(params, space, inputs, outputs, vector):
                return to_cov(kernel.cov(params, space))
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._posterior_kernel(params, space, inputs, outputs, noise)
        return fn

    def th_cholesky(self, prior=False, noise=False):
        k_fn = self.th_kernel(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            return safe_cholesky(to_cov(k_fn(params, space, inputs, outputs, vector)))
        return fn

    def th_kernel_diag(self, prior=False, noise=False):
        if prior:
            kernel = self.f_kernel_noise if noise else self.f_kernel

            def fn(params, space, inputs, outputs, vector):
                return to_bounded(_diag(kernel.cov(params, space)), 0.0)
        else:
            def fn(params, space, inputs, outputs, vector):
                return self._posterior_kernel_diag(params, space, inputs, outputs, noise)
        return fn

    def th_kernel_sd(self, prior=False, noise=False):
        diag_fn = self.th_kernel_diag(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            return torch.sqrt(diag_fn(params, space, inputs, outputs, vector))
        return fn

    def th_cholesky_diag(self, prior=False, noise=False):
        sd_fn = self.th_kernel_sd(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            return torch.diag_embed(sd_fn(params, space, inputs, outputs, vector))
        return fn

    def th_median(self, prior=False, noise=False, simulations=None):
        loc_fn = self.th_location(prior=prior, noise=noise)

        def fn(params, space, inputs, outputs, vector):
            return self.f_mapping(params, loc_fn(params, space, inputs, outputs, vector))
        return fn

    def th_mean(self, prior=False, noise=False, simulations=None):
        return self.th_median(prior=prior, noise=noise)

    def th_variance(self, prior=False, noise=False, simulations=None):
        return self.th_kernel_diag(prior=prior, noise=noise)

    def th_covariance(self, prior=False, noise=False):
        return self.th_kernel(prior=prior, noise=noise)

    freedom = _statistic("th_freedom", "Degrees of freedom (the Student-t family).")
    mapping = _statistic("th_mapping", "Forward warping of ``vector``.")
    mapping_inv = _statistic("th_mapping_inv", "Inverse warping of the observed outputs.")
    location = _statistic("th_location", "Latent (pre-warping) location.")
    kernel = _statistic("th_kernel", "Latent covariance over ``space``.")
    cholesky = _statistic("th_cholesky", "Cholesky factor of the latent covariance.")
    kernel_diag = _statistic("th_kernel_diag", "Latent marginal variance.")
    kernel_sd = _statistic("th_kernel_sd", "Latent marginal standard deviation.")
    cholesky_diag = _statistic("th_cholesky_diag",
                               "Diagonal matrix of the latent standard deviations.")

    # -- model plots (matplotlib imported by the drawing calls only) -----------------
    def plot_kernel(self, params=None, space=None, inputs=None, prior=True, noise=False,
                    centers=(1 / 10, 1 / 2, 9 / 10)):
        from ..utils.plots import plot, plot_text

        params = self.params if params is None else params
        space = self.space if space is None else space
        inputs = self.inputs if inputs is None else inputs
        ksi = _host(self.kernel(params=params, space=space, inputs=inputs, prior=prior,
                                noise=noise)).T
        for ind in centers:
            plot(self.order, ksi[int(len(ksi) * ind), :],
                 label="k(x_" + str(int(len(ksi) * ind)) + ")")
        plot_text("Kernel", "Space x", "Kernel value k(x,v)")

    def plot_concentration(self, params=None, space=None, prior=True, noise=True, color=True,
                           cmap="seismic", figsize=(6, 6), title="Concentration"):
        from ..utils.plots import plot_text, pyplot

        plt = pyplot()
        params = self.params if params is None else params
        space = self.space if space is None else space
        concentration = _host(self.kernel(params=params, space=space, prior=prior,
                                          noise=noise))
        if color:
            if figsize is not None:
                plt.figure(None, figsize)
            v = np.max(np.abs(concentration))
            plt.imshow(concentration, cmap=cmap, vmax=v, vmin=-v)
        else:
            plt.matshow(concentration)
        plot_text(title, "Space x", "Space x", legend=False)

    def plot_mapping(self, params=None, domain=None, inputs=None, outputs=None, neval=100,
                     title=None, label="mapping"):
        from ..utils.plots import plot, plot_text

        params = self.params if params is None else params
        outputs = self.outputs if outputs is None else outputs
        if domain is None:
            domain = np.linspace(outputs.min(), outputs.max(), neval, dtype=settings.floatx)
        with torch.no_grad():
            warped = self.f_mapping.inv(self._tensor_params(params), as_tensor(domain))
        plot(domain, _host(warped), label=label)
        plot_text(title or "Mapping", "Domain y", "Domain T(y)")

    def plot_model(self, params=None, indexs=None, kernel=True, mapping=True, marginals=True,
                   bivariate=True):
        from ..utils.plots import show, subplot

        if indexs is None:
            mid = len(self.index) // 2
            indexs = [int(self.index[mid]), int(self.index[mid]) + 1]
        if kernel:
            subplot(121)
            self.plot_kernel(params=params)
        if mapping:
            subplot(122)
            self.plot_mapping(params=params)
        show()
        if marginals:
            for panel, i in ((121, indexs[0]), (122, indexs[1])):
                subplot(panel)
                self.plot_distribution(index=i, params=params, space=self.space[i:i + 1, :],
                                       prior=True)
                self.plot_distribution(index=i, params=params, space=self.space[i:i + 1, :])
            show()
        if bivariate:
            self.plot_distribution2D(indexs=indexs, params=params, space=self.space[indexs, :])
            show()

    def plot_distribution(self, index=0, params=None, space=None, inputs=None, outputs=None,
                          mean=True, var=True, cov=False, median=False, quantiles=False,
                          quantiles_noise=False, noise=False, prior=False, sigma=4, neval=100,
                          title=None, swap=False, label=None):
        from ..utils.plots import plot, plot_text

        pred = self.predict(params=params, space=space, inputs=inputs, outputs=outputs,
                            mean=mean, var=var, cov=cov, median=median, quantiles=quantiles,
                            quantiles_noise=quantiles_noise, noise=noise, distribution=True,
                            prior=prior)
        m, sd = _host(pred["mean"]), _host(pred["std"])
        domain = np.linspace(m - sigma * sd, m + sigma * sd, neval).reshape(-1)
        dist_plot = np.exp([float(_host(pred["logpredictive"](domain[i:i + 1])))
                            for i in range(len(domain))])
        if label is None:
            label = "prior" if prior else "posterior"
        if label is False:
            label = None
        if title is None:
            title = "Marginal Distribution y_" + str(self.order[index])
        if swap:
            plot(dist_plot, domain, label=label)
            plot_text(title, "Density", "Domain y")
        else:
            plot(domain, dist_plot, label=label)
            plot_text(title, "Domain y", "Density")

    def plot_distribution2D(self, indexs=(0, 1), params=None, space=None, inputs=None,
                            outputs=None, mean=True, var=True, cov=False, median=False,
                            quantiles=False, quantiles_noise=False, noise=False, prior=False,
                            sigma_1=2, sigma_2=2, neval=33, title=None):
        from ..utils.plots import grid2d, plot_2d, plot_text

        pred = self.predict(params=params, space=space, inputs=inputs, outputs=outputs,
                            mean=mean, var=var, cov=cov, median=median, quantiles=quantiles,
                            quantiles_noise=quantiles_noise, noise=noise, distribution=True,
                            prior=prior)
        m, sd = _host(pred["mean"]), _host(pred["std"])
        dist1 = np.linspace(m[0] - sigma_1 * sd[0], m[0] + sigma_1 * sd[0], neval)
        dist2 = np.linspace(m[1] - sigma_2 * sd[1], m[1] + sigma_2 * sd[1], neval)
        xy, x2d, y2d = grid2d(dist1, dist2)
        dist_plot = np.exp([float(_host(pred["logpredictive"](xy[i])))
                            for i in range(len(xy))])
        plot_2d(dist_plot, x2d, y2d)
        plot_text(title or "Distribution2D", "Domain y_" + str(self.order[indexs[0]]),
                  "Domain y_" + str(self.order[indexs[1]]), legend=False)

    def plot_location(self, params=None, space=None):
        from ..utils.plots import plot, plot_text

        params = self.params if params is None else params
        space = self.space if space is None else space
        plot(self.order, _host(self.location(params=params, space=space, prior=True)),
             label="location")
        plot_text("Location", "Space x", "Location value m(x)")
