"""Matplotlib helpers and style presets (the PyTorch counterpart of
:mod:`g3py_tpu.utils.plots`, the same names).

matplotlib and seaborn are imported inside the functions, never with the
package: a machine without them (the card's) imports and runs the port, and
only a call that draws needs them.  Without a display the backend is Agg.
"""

import os

import numpy as np

from ..config import settings

__all__ = ["subplot", "tight_layout", "style_text", "figure", "plot", "show", "plot_text",
           "plot_save", "plot_img", "show_img", "plot_matrix", "grid2d", "plot_2d",
           "style_seaborn", "style_normal", "style_big", "style_big_seaborn", "style_widget"]


def pyplot():
    """``matplotlib.pyplot``, headless-safe (Agg when there is no display)."""
    import matplotlib

    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def figure(*args, **kwargs):
    return pyplot().figure(*args, **kwargs)


def plot(*args, **kwargs):
    return pyplot().plot(*args, **kwargs)


def show(*args, **kwargs):
    return pyplot().show(*args, **kwargs)


def _rc(values):
    import matplotlib

    matplotlib.rcParams.update(values)


def style_seaborn():
    import seaborn as sb

    sb.set_theme(style="darkgrid")
    settings.plot_big = False


def style_normal():
    _rc({"figure.figsize": (10, 6), "axes.titlesize": 20, "font.size": 14})
    settings.plot_big = False


def style_big():
    _rc({"figure.figsize": (20, 12), "axes.titlesize": 36, "font.size": 28,
         "lines.linewidth": 4})
    settings.plot_big = True


def style_big_seaborn():
    style_seaborn()
    style_big()
    settings.plot_big = True


def style_widget():
    _rc({"figure.figsize": (9, 5), "font.size": 12})
    settings.plot_big = False


def plot_text(title="title", x="xlabel", y="ylabel", legend=True, ncol=3, loc="best",
              axis=None):
    """Title, labels and legend in one call."""
    plt = pyplot()
    plt.axis("tight")
    plt.title(title)
    plt.xlabel(x)
    plt.ylabel(y)
    if legend:
        plt.legend(ncol=ncol, loc=loc)
    if axis is not None:
        plt.axis(axis)


def plot_save(file="plot.pdf"):
    d = os.path.dirname(file)
    if d:
        os.makedirs(d, exist_ok=True)
    pyplot().savefig(file, bbox_inches="tight")


def plot_img(file="plot.png"):
    plot_save(file)
    return file


show_img = plot_img


def plot_matrix(m, cmap="seismic", title="Matrix", colorbar=True):
    plt = pyplot()
    m = np.asarray(m)
    v = np.max(np.abs(m)) if m.size else 1.0
    plt.imshow(m, cmap=cmap, vmax=v, vmin=-v)
    if colorbar:
        plt.colorbar()
    plt.title(title)


def grid2d(x, y):
    """A mesh over two 1-D axes: (pairs, X, Y)."""
    xx, yy = np.meshgrid(x, y)
    return np.stack([xx.ravel(), yy.ravel()], axis=1), xx, yy


def plot_2d(values, x2d, y2d, contour=True, surface=False):
    """Contour (or surface, or mesh) rendering of a gridded field."""
    plt = pyplot()
    z = np.asarray(values).reshape(x2d.shape)
    if surface:
        ax = plt.gcf().add_subplot(111, projection="3d")
        ax.plot_surface(x2d, y2d, z, cmap="viridis")
    elif contour:
        plt.contourf(x2d, y2d, z, levels=30, cmap="viridis")
        plt.colorbar()
    else:
        plt.pcolormesh(x2d, y2d, z, cmap="viridis")


def subplot(*args, **kwargs):
    return pyplot().subplot(*args, **kwargs)


def tight_layout(*args, **kwargs):
    pyplot().tight_layout(*args, **kwargs)


def style_text(size=36):
    pyplot().rcParams["legend.fontsize"] = size
