"""The workloads of the port's Laplace state-space parity tests
(``tests/test_torch_ngssm*.py``, ``tests/test_torch_ngstssm.py``): each
model built the same way in either package (``lib`` is g3py_tpu or
g3py_tpu_torch) on numpy inputs made from a seed, and the query points."""

import numpy as np

LIKS = {"poisson": "PoissonLik", "bernoulli": "BernoulliLik", "studentt": "StudentTLik"}


def counts(n=12, seed=3):
    """A series on (0, 10) and its Poisson, Bernoulli and Student-t
    targets around sin(t)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n)).reshape(-1, 1)
    f = np.sin(t[:, 0])
    return t, {"poisson": rng.poisson(np.exp(f)).astype(float),
               "bernoulli": (f + 0.5 * rng.standard_normal(n) > 0).astype(float),
               "studentt": f + 0.2 * rng.standard_t(3, n)}


def nudged(params, seed=0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) * (1.0 + 0.1 * rng.uniform(-1, 1, np.shape(v)))
            for k, v in params.items()}


def ngssgp(lib, kind, n=12):
    t, ys = counts(n)
    proc = lib.NonGaussianSSGP(space=t, location=lib.Bias(), kernel=lib.MAT32(t),
                               likelihood=getattr(lib, LIKS[kind])(), name="NG_" + kind)
    proc.observed(t, ys[kind])
    return proc


NG_TQ = np.linspace(-0.5, 10.5, 7)[:, None]
NG_YQ = np.arange(7.0) % 3
NG_DRAW_TQ = np.linspace(0.5, 9.5, 5)[:, None]


def ngm_data(case):
    """Two channels at their own times, Poisson counts and Bernoulli events
    (``mixed`` 6 + 4 rows; ``fault`` 20 + 14, where the JAX package's
    gradient leaves its own central differences)."""
    rng = np.random.default_rng(4)
    n0, n1 = (6, 4) if case == "mixed" else (20, 14)
    t0 = np.sort(rng.uniform(0, 8, n0))[:, None]
    t1 = np.sort(rng.uniform(0, 8, n1))[:, None]
    y0 = rng.poisson(np.exp(np.sin(t0[:, 0]))).astype(float)
    y1 = ((np.cos if case == "mixed" else np.sin)(t1[:, 0]) > 0).astype(float)
    return t0, t1, y0, y1


def ngmssgp(lib, case):
    t0, t1, y0, y1 = ngm_data(case)
    x, y = lib.stack_outputs([t0, t1], [y0, y1])
    proc = lib.NonGaussianMultiSSGP(space=x, kernel=lib.MAT32(t0),
                                    likelihood=[lib.PoissonLik(), lib.BernoulliLik()],
                                    outputs_dim=2, name="NGM_" + case)
    proc.observed(x, y)
    return proc


NGM_XQ = np.array([[1.0, 0.0], [2.5, 1.0], [4.0, 0.0], [7.5, 1.0]])
NGM_YQ = np.array([2.0, 1.0, 0.0, 0.0])


def ngst_sites():
    return np.stack(np.meshgrid(np.linspace(0, 1, 2), np.linspace(0, 1, 2), indexing="ij"),
                    -1).reshape(-1, 2)


def ngstssgp(lib):
    """A Poisson Cox process on 4 sites in 2-D, 3 events a site."""
    rng = np.random.default_rng(5)
    sites = ngst_sites()
    ts, ys = [], []
    for s in range(len(sites)):
        tt = np.sort(rng.uniform(0, 5, 3))[:, None]
        ts.append(tt)
        ys.append(rng.poisson(np.exp(0.5 * np.sin(tt[:, 0] + s))).astype(float))
    x, y = lib.stack_outputs(ts, ys)
    proc = lib.NonGaussianSTSSGP(space=x, kernel=lib.MAT32(x[:, :1]), space_kernel=lib.SE(sites),
                                 sites=sites, name="NGST")
    proc.observed(x, y)
    return proc


NGST_TQ = np.array([0.5, 2.0, 4.5])
NGST_XQ = np.array([[0.2, 0.3], [0.7, 0.9], [0.5, 0.5]])
NGST_ROWS = np.array([[1.0, 0.0], [2.0, 3.0], [3.5, 1.0]])
