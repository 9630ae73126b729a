"""Gloo worlds on the CPU for the port's distributed tests.

:func:`world` runs a file's rank work (``tests/torch_dist_work.py``, which
imports no JAX) on D ranks through
:func:`g3py_tpu_torch.parallel.launch.run_local`: D fresh interpreters,
each on one thread with ``settings.device = "cpu"``, joined by a
``file://`` store under the test's temporary directory (so parallel test
workers never share a port).  The JAX side of a test runs in the pytest
process on the virtual 8-device mesh of ``tests/conftest.py``."""

import os

from g3py_tpu_torch.parallel.launch import run_local

TESTS = os.path.dirname(os.path.abspath(__file__))


def world(d, tasks, workdir, timeout=300.0):
    """Every rank's ``{name: result}`` for ``tasks`` (a list of ``(name,
    function of torch_dist_work, keywords)``) on ``d`` gloo ranks."""
    workdir = os.path.join(str(workdir), f"world{d}")
    os.makedirs(workdir)
    return run_local(d, "torch_dist_work:run", {"tasks": tasks}, backend="gloo",
                     device="cpu", threads=1, timeout=timeout, workdir=workdir,
                     env={"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"})
