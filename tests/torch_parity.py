"""Parity harness between the JAX package and its PyTorch port.

The same numpy inputs, made from a seed, go through a JAX callable and a
torch callable; the results come back as numpy and are compared:

* float32 against float32 at rtol 1e-4, atol 1e-5 — the f32 floor of the
  reference (PARITY.md; ROADMAP Queue 3);
* float64 against JAX under ``jax.enable_x64(True)`` at 1e-10, where a check
  must be tight.

``floatx(name)`` switches both packages' compute dtype and restores it.
The port's entry points run on the card by default; importing this module
puts them on the CPU (``g3t.settings.device = "cpu"``).
"""

import contextlib

import jax
import numpy as np
import torch

import g3py_tpu as g3
import g3py_tpu_torch as g3t
import g3py_tpu_torch.hypers.kernels as tkernels
import g3py_tpu_torch.ops.linalg as tlinalg

torch.set_num_threads(1)
g3t.settings.device = "cpu"

F32_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


@contextlib.contextmanager
def floatx(name):
    """Both packages in ``name`` ("float32"/"float64"); float64 also turns
    on JAX's x64 mode.  Restores the previous settings on exit."""
    old_j, old_t = g3.config.settings.floatx, g3t.settings.floatx
    x64 = jax.enable_x64(True) if name == "float64" else contextlib.nullcontext()
    with x64:
        g3.set_floatx(name)
        g3t.set_floatx(name)
        try:
            yield
        finally:
            g3.set_floatx(old_j)
            g3t.set_floatx(old_t)


def jax_eager():
    """The JAX package op by op (``jax.disable_jit``): at these tests' sizes
    that takes a fraction of the time of compiling every entry point of
    every model, for the same values to rounding."""
    return jax.disable_jit()


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return np.asarray(x)


def tol(name):
    return F64_TOL if name == "float64" else F32_TOL


def assert_close(got, want, name="float32", err_msg=""):
    """Recursive allclose at the dtype's parity tolerance."""
    got, want = to_numpy(got), to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], name, err_msg=f"{err_msg} [{k}]")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, name, err_msg=f"{err_msg} [{i}]")
        return
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol(name))


def check(jax_fn, torch_fn, *inputs, name="float32"):
    """Run both callables on the same numpy ``inputs`` (cast to ``name``)
    and compare; returns the (jax, torch) results as numpy."""
    with floatx(name):
        arrs = [np.asarray(a, dtype=name) for a in inputs]
        want = to_numpy(jax_fn(*[jax.numpy.asarray(a) for a in arrs]))
        got = to_numpy(torch_fn(*[torch.as_tensor(a) for a in arrs]))
    assert_close(got, want, name)
    return want, got


def process_pair(build, x, y):
    """The same model built by ``build(lib)`` in both packages (``lib`` is
    g3py_tpu or g3py_tpu_torch), each observed on ``x``, ``y``."""
    out = []
    for lib in (g3, g3t):
        proc = build(lib)
        proc.observed(x, y)
        out.append(proc)
    return out


#: XLA options of every program these tests compile from the JAX package:
#: the backend's optimizations off.  A Laplace state-space logp and gradient
#: compiles in ~6 s, not ~9 s; and at XLA's default CPU optimization one
#: NonGaussianMultiSSGP gradient leaves its own central differences by ~10%
#: (ROADMAP Queue 3), where this compile agrees with them and with the port.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_compiled(fn, *args):
    """``fn(*args)`` through one jit compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def jax_parts(parts):
    """Several JAX computations as ONE program (:func:`jax_compiled`):
    ``parts`` maps a key to ``(fn, args, post)``; returns key ->
    ``post(fn(*args))``.  For the Laplace family one program of three
    models' logp and gradient compiles in about half the time of three."""
    fns = {k: p[0] for k, p in parts.items()}
    out = jax_compiled(lambda a: {k: fns[k](*a[k]) for k in fns},
                       {k: p[1] for k, p in parts.items()})
    return {k: parts[k][2](out[k]) for k in parts}


def logp_dlogp_part(proc, params, space=None, specs=None, vector=None):
    """A JAX process's ``logp`` and ``dlogp`` at the params dict ``params``
    (``jax.value_and_grad`` over the process's own pure logp, where its
    ``logp`` and ``dlogp`` compile a program each) and, with ``specs``, its
    statistics at ``space`` (``specs`` maps a key to ``(th_name, kwargs)``,
    e.g. ``("th_variance", {"noise": True})``; ``vector`` the log
    predictive's targets), as a part of :func:`jax_parts`: it gives
    ``(value, grad)``, or ``(value, grad, statistics)`` with ``specs``."""
    import jax.numpy as jnp
    from g3py_tpu.ops.guards import to_num

    reg = proc.active
    pure = proc._logp_pure(prior=False)
    floatx = g3.settings.floatx
    u = np.asarray(reg.dict_to_array(params), dtype=floatx)
    fns = {k: getattr(proc, th)(**kw) for k, (th, kw) in (specs or {}).items()}
    s, i, o = proc._resolve_data(space, None, None)
    sdata = (s, i, o, np.zeros(len(s), dtype=floatx) if vector is None
             else np.asarray(vector, dtype=floatx))
    pj = {k: jnp.asarray(v) for k, v in proc.filter_params(params).items()}
    data = (*proc._resolve_data(None, None, None), np.zeros(0, dtype=floatx))

    def fn(u, data, p, sdata):
        vg = jax.value_and_grad(lambda w: pure(reg.array_to_dict_jax(w), *data))(u)
        return vg, {k: f(p, *sdata) for k, f in fns.items()}

    def post(out):
        (val, grad), stats = out
        vg = float(val), np.asarray(to_num(grad))
        return vg + (to_numpy(stats),) if specs else vg

    return fn, (u, data, pj, sdata), post


def jax_logp_dlogp(proc, params, space=None, specs=None, vector=None):
    """:func:`logp_dlogp_part` as its own program."""
    return jax_parts({"": logp_dlogp_part(proc, params, space, specs, vector)})[""]


def nudged(params, factor=0.1):
    """``params`` moved off their defaults (where a Bias or a warping may
    sit at a zero of its gradient) by ``factor`` relative."""
    return {k: np.asarray(v) * (1.0 + factor * np.sign(np.asarray(v))) for k, v in params.items()}


def zoo_data(n=16, d=2, seed=0):
    """Positive inputs (the Brownian kernel's min-product stays PSD), a
    sine around 1.6 and query points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 6.0, (n, d))
    y = np.sin(x[:, 0]) + 1.6 + 0.1 * rng.standard_normal(n)
    xq = rng.uniform(0.0, 6.5, (7, d))
    return x, y, xq


def check_gp(label, kernel, location=None, mapping=None, data=None, name="float64"):
    """GP(location, kernel, mapping) built in both packages from the
    builders ``lib -> component`` (location defaults to Bias) on
    ``data`` (default :func:`zoo_data`): the same hyper names, the defaults
    bit for bit, then logp (inside the priors' support), dlogp and predict
    at nudged defaults (:func:`assert_process_matches`).  Returns the two processes and the
    params."""
    x, y, xq = zoo_data() if data is None else data
    location = location if location is not None else (lambda lib: lib.Bias())

    def build(lib):
        return lib.GP(space=x, location=location(lib), kernel=kernel(lib),
                      mapping=None if mapping is None else mapping(lib), name="T" + label)

    # eager JAX pays off over several float64 models; a single float32
    # model compiles sooner than it warms up op by op
    eager = jax_eager() if name == "float64" else contextlib.nullcontext()
    with floatx(name), eager:
        jp, tp = process_pair(build, x, y)
        assert [p.name for p in tp.active.ordered_params] == \
            [p.name for p in jp.active.ordered_params]
        for k, v in jp.params_default.items():
            np.testing.assert_array_equal(tp.params_default[k], np.asarray(v), err_msg=k)
        # a PSD metric's directions default to 0, on the wall of their
        # FlatExp prior (logp -1e30 in both packages): take them inside
        params = {k: np.full_like(v, 0.3) if k.endswith("_directions") else v
                  for k, v in nudged(jp.params_default).items()}
        assert_process_matches(jp, tp, params, xq, name, label=label)
        assert tp.logp(params) > -1e29, label
    return jp, tp, params


def assert_process_matches(jp, tp, params, xq, name="float64", label=""):
    """logp, dlogp (``jax.grad`` in the JAX package) and predict's mean and
    std at ``xq`` of a JAX process ``jp`` and its port ``tp``, at the
    dtype's parity tolerance (``floatx(name)`` must be active)."""
    pairs = [("logp", jp.logp(params), tp.logp(params)),
             ("dlogp", jp.dlogp(params), tp.dlogp(params))]
    want = jp.predict(params, xq, mean=True, std=True)
    got = tp.predict(params, xq, mean=True, std=True)
    pairs += [(k, want[k], got[k]) for k in ("mean", "std")]
    for what, w, g in pairs:
        assert_close(g, w, name, err_msg=f"{label} {what}")


class KernelSpy:
    """Counts the calls of the K1 wrapper (``stationary_gram``, reached by
    the kernels) and of the K2 wrapper (``panel_cholesky``, reached by every
    factorization) through ``monkeypatch``: on a CPU tensor each call is one
    plain-version evaluation, on the card one launch."""

    def __init__(self, monkeypatch):
        self.k1 = self.k2 = 0
        k1, k2 = tkernels.stationary_gram, tlinalg.panel_cholesky

        def spy_k1(*a, **kw):
            self.k1 += 1
            return k1(*a, **kw)

        def spy_k2(*a, **kw):
            self.k2 += 1
            return k2(*a, **kw)

        monkeypatch.setattr(tkernels, "stationary_gram", spy_k1)
        monkeypatch.setattr(tlinalg, "panel_cholesky", spy_k2)

    def take(self):
        """The (K1, K2) counts since the last take, then zero them."""
        out = (self.k1, self.k2)
        self.k1 = self.k2 = 0
        return out


def jax_compiled_method(proc, name):
    """Route a JAX process's method ``name`` (e.g. ``_joint_draws``, which
    its ``sampler`` calls) through one program compiled with
    :data:`FAST_COMPILE`, not XLA's defaults or op-by-op dispatch of its
    scans: its params-dict arguments are the program's inputs, the others
    closed over.  Returns ``proc``."""
    method = getattr(proc, name)
    programs = {}

    def compiled(*args, **kw):
        dyn = {i: a for i, a in enumerate(args) if isinstance(a, dict)}
        key = repr([(np.shape(a), np.asarray(a).tobytes()) if hasattr(a, "shape") else a
                     for a in args if not isinstance(a, dict)] + sorted(kw.items()))
        if key not in programs:            # the same closed-over inputs: one compile
            def fn(dyn):
                return method(*[dyn.get(i, a) for i, a in enumerate(args)], **kw)

            programs[key] = jax.jit(fn).lower(dyn).compile(compiler_options=FAST_COMPILE)
        return programs[key](dyn)

    setattr(proc, name, compiled)
    return proc
