"""Tracing, graph inspection and profiling helpers (the PyTorch counterpart
of :mod:`g3py_tpu.utils.debug`).

* :func:`set_debug` / :func:`debug` — a pass-through value tap that prints
  only when enabled (``G3PY_DEBUG`` in the environment turns it on): when
  off it reads nothing, so it never makes the host wait for the card.
* :func:`show_graph` / :func:`print_graph` — the op graph of a call, traced
  by ``torch.fx.experimental.proxy_tensor.make_fx`` (the JAX package prints
  a jaxpr or the compiled HLO).
* :func:`debug_mode` — raises on a NaN made inside the block, in the
  forward (a ``TorchDispatchMode`` that checks every op's floating outputs)
  or in the backward (``torch.autograd.detect_anomaly``).
* :func:`profile_trace` — a ``torch.profiler`` context that writes a
  chrome trace (``trace.json`` in the directory ``path``).
"""

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["debug", "show_graph", "print_graph", "debug_mode", "profile_trace", "set_debug"]

_DEBUG = bool(os.environ.get("G3PY_DEBUG", ""))


def set_debug(on=True):
    """Turn the value taps (and ``compat.debug_p``) on or off globally."""
    global _DEBUG
    _DEBUG = bool(on)


def debug(x, name="", force=False):
    """Pass-through value tap: prints ``name = x`` when debugging is on (or
    ``force``) and returns ``x``, so it can sit inside an expression."""
    if _DEBUG or force:
        print(name + " = {}".format(x.detach().cpu() if isinstance(x, torch.Tensor) else x))
    return x


def _graph(fn, *example_args):
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn)(*example_args)


def show_graph(fn, *example_args, path=None):
    """The op graph of ``fn`` on ``example_args`` as text (aten ops, one a
    line); written to ``path`` when given."""
    txt = _graph(fn, *example_args).print_readable(print_output=False)
    if path:
        with open(path, "w") as f:
            f.write(txt)
    return txt


def print_graph(fn, *example_args):
    """Print and return the traced graph of ``fn`` (a ``torch.fx``
    GraphModule)."""
    gm = _graph(fn, *example_args)
    print(gm.graph)
    return gm


class _NanCheck(TorchDispatchMode):
    """Raise when an op returns a floating tensor holding a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans=True):
    """Raise on a NaN made inside the block: ``FloatingPointError`` from the
    op that made it, forward or backward (or torch's anomaly mode's
    ``RuntimeError`` for a backward run elsewhere); ``nans=False`` checks
    nothing.  Every op's result is read, so the block runs at the
    host's pace."""
    if not nans:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True), _NanCheck():
        yield


@contextlib.contextmanager
def profile_trace(path="g3py_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); the chrome trace goes to ``path/trace.json``.  Yields
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
