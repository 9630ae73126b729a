"""The port's plots against the JAX package's, drawn with the Agg backend:
each figure's line data (and images and bar heights) equal within 1e-6 —
the process plot (mean, median, bands, hidden, observations), the kernel,
mapping, location, marginal-density and concentration plots, the datatrace
panels and histograms, the plot helpers — and the widget's slider layout,
``describe`` and ``find_MAP(plot=True)``."""

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import g3py_tpu as g3  # noqa: E402
import g3py_tpu_torch as g3t  # noqa: E402

from torch_parity import floatx, jax_eager, nudged, process_pair  # noqa: E402


def _drawn(fn):
    """Draw with ``fn`` on fresh figures; the lines' xy data, the images'
    arrays and the bars' heights of every axes of every figure."""
    plt.close("all")
    fn()
    out = []
    for num in plt.get_fignums():
        for ax in plt.figure(num).axes:
            out += [ln.get_xydata() for ln in ax.lines]
            out += [np.asarray(im.get_array()) for im in ax.images]
            out += [np.array([p.get_height() for p in ax.patches])] if ax.patches else []
    plt.close("all")
    return out


def _same_drawing(jfn, tfn, label):
    want, got = _drawn(jfn), _drawn(tfn)
    assert len(got) == len(want) > 0, label
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{label} [{i}]")


def _models():
    rng = np.random.default_rng(2)
    x = np.linspace(0.0, 6.0, 14).reshape(-1, 1)
    y = np.sin(x[:, 0]) + 2.0 + 0.1 * rng.standard_normal(14)
    jp, tp = process_pair(lambda lib: lib.WGP(space=x, location=lib.Bias(), kernel=lib.SE(x),
                                              mapping=lib.BoxCoxShifted(), name="PLT"), x, y)
    return jp, tp, nudged(jp.params_default)


DRAWINGS = {
    "plot": lambda p, params: p.plot(params, median=True, std=True),
    "plot_kernel": lambda p, params: p.plot_kernel(params),
    "plot_mapping": lambda p, params: p.plot_mapping(params),
    "plot_location": lambda p, params: p.plot_location(params),
    "plot_distribution": lambda p, params: p.plot_distribution(
        index=3, params=params, space=p.space[3:4], neval=12),
    "plot_concentration": lambda p, params: p.plot_concentration(params),
    "plot_space_hidden_observations": lambda p, params: (p.plot_space(observed=True),
                                                         p.plot_hidden(hidden=p.outputs),
                                                         p.plot_observations()),
}


@pytest.mark.parametrize("name", sorted(DRAWINGS))
def test_process_plots_match_jax(name):
    with floatx("float64"), jax_eager():
        jp, tp, params = _models()
        _same_drawing(lambda: DRAWINGS[name](jp, params), lambda: DRAWINGS[name](tp, params),
                      name)


def test_datatrace_plots_and_helpers_match_jax():
    import pandas as pd

    rng = np.random.default_rng(3)
    cols = {"a": rng.standard_normal(40), "b": rng.standard_normal(40),
            "_nchain": np.repeat(np.arange(4), 10), "_niter": np.tile(np.arange(10), 4),
            "_burnin": np.tile(np.arange(10) >= 3, 4), "_outlayer": np.ones(40, bool)}
    df, dt = pd.DataFrame(cols), g3t.Datatrace(cols)
    _same_drawing(lambda: g3.plot_datatrace(df), lambda: g3t.plot_datatrace(dt),
                  "plot_datatrace")
    _same_drawing(lambda: g3.hist_datatrace(df, bins=8, reference={"a": 0.5}),
                  lambda: g3t.hist_datatrace(dt, bins=8, reference={"a": 0.5}), "hist")
    m = rng.standard_normal((5, 5))
    _same_drawing(lambda: g3.plot_matrix(m), lambda: g3t.plot_matrix(m), "plot_matrix")
    for got, want in zip(g3t.grid2d(np.arange(3.0), np.arange(2.0)),
                         g3.grid2d(np.arange(3.0), np.arange(2.0))):
        np.testing.assert_array_equal(got, want)
    assert g3t.kde_datatrace(dt, size=2) is not None
    assert g3t.scatter_datatrace(dt, samples=20) is not None
    plt.close("all")


def test_widget_layout_describe_and_find_map_plot():
    with floatx("float64"), jax_eager():
        jp, tp, params = _models()
        assert tp._widget_intervals(params) == jp._widget_intervals(params)
        assert tp.params_widget == tp.params and tp.widget_params is None
        tp.describe(title="T", x="time", y="value", text="t")
        assert tp.description == {"title": "T", "x": "time", "y": "value", "text": "t"}
        spec = tp._check_params_dims({k: float(np.mean(v)) for k, v in params.items()})
        assert {k: v.shape for k, v in spec.items()} == {
            k: np.shape(v) for k, v in tp.params.items()}
        plt.close("all")
        tp.find_MAP(params, points=1, powell=False, display=False, plot=True)
        assert len(plt.get_fignums()) == 2  # the start and the BFGS point
    plt.close("all")
