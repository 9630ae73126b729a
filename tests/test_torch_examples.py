"""The tutorials replayed on the port: each ``examples/tut*.py`` runs
``main(quick=True, plot=False)`` in a fresh process where ``g3py_tpu`` (and
every ``g3py_tpu.<module>``) is an alias of ``g3py_tpu_torch``, so that no
JAX is imported.  Marked ``slow``, as tests/test_examples.py is.  Tutorial
11 (distributed training) calls ``jax.devices()`` itself and is skipped
(its path runs in ``tests/test_torch_distributed_models.py``).

On the card (``settings.device = "cuda"``), without pytest:

    python3 tests/test_torch_examples.py --device cuda [tut03_kernels ...]

prints one line a tutorial and a JSON summary last."""

import json
import os
import subprocess
import sys
import time

import pytest

pytestmark = pytest.mark.slow

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
EXAMPLES = os.path.join(ROOT, "examples")

MODULES = ["example", "tut00_introduction", "tut01_gaussian_processes", "tut02_hyperparameters",
           "tut03_kernels", "tut04_random_fields", "tut05_pushforward", "tut06_copulas",
           "tut07_multi_output", "tut08_graphical_models", "tut09_large_scale",
           "tut10_serving", "tut12_likelihoods", "tut13_time_series", "tut14_spatiotemporal",
           "tut15_grids", "tut16_ski", "tut17_deep_kernels", "tut18_bayesian_optimization",
           "tut19_multioutput_50k"]
#: tutorials that use JAX themselves
NOT_PORTABLE = {"tut11_distributed_training":
                "calls jax.devices() itself (examples/tut11_distributed_training.py:34)"}

# the child: alias g3py_tpu to the port, then run one tutorial
_CHILD = r'''
import importlib, importlib.abc, importlib.util, sys
import g3py_tpu_torch

class Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """g3py_tpu.<x> is g3py_tpu_torch.<x>."""
    def find_spec(self, name, path, target=None):
        if name == "g3py_tpu" or name.startswith("g3py_tpu."):
            return importlib.util.spec_from_loader(name, self)
        return None
    def create_module(self, spec):
        return importlib.import_module("g3py_tpu_torch" + spec.name[len("g3py_tpu"):])
    def exec_module(self, module):
        pass

sys.meta_path.insert(0, Alias())
try:
    import matplotlib
except ImportError:  # a machine without matplotlib: plot=False draws nothing
    import types
    mpl, plt = types.ModuleType("matplotlib"), types.ModuleType("matplotlib.pyplot")
    mpl.use, mpl.pyplot = (lambda *a, **k: None), plt
    sys.modules.update({"matplotlib": mpl, "matplotlib.pyplot": plt})
g3py_tpu_torch.settings.device = sys.argv[2]
sys.path.insert(0, sys.argv[3])
importlib.import_module(sys.argv[1]).main(quick=True, plot=False)
assert "jax" not in sys.modules, "a tutorial imported JAX"
'''


def run_tutorial(name, device="cpu", timeout=1800):
    """(ok, seconds, the tail of the output) of one tutorial on the port."""
    env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD, name, device, EXAMPLES],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    tail = (proc.stdout + proc.stderr)[-2000:]
    return proc.returncode == 0, time.perf_counter() - t0, tail


@pytest.mark.parametrize("name", MODULES + sorted(NOT_PORTABLE))
def test_tutorial_runs_on_the_port(name):
    if name in NOT_PORTABLE:
        pytest.skip(f"{name} {NOT_PORTABLE[name]}")
    ok, _, tail = run_tutorial(name)
    assert ok, tail


if __name__ == "__main__":
    args = sys.argv[1:]
    device = "cpu"
    if args[:1] == ["--device"]:
        device, args = args[1], args[2:]
    summary = {}
    for name in args or MODULES:
        ok, secs, tail = run_tutorial(name, device)
        summary[name] = {"ok": ok, "seconds": round(secs, 1)}
        print(f"{name}: {'ok' if ok else 'FAILED'} in {secs:.1f} s", flush=True)
        if not ok:
            print("    " + tail.replace("\n", "\n    ")[-1500:], flush=True)
    print(json.dumps(summary))
