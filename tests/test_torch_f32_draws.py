"""The float32 stage tool (g3py_tpu_torch/tools/f32_draws.py) on the CPU at
a small size: its stages and swaps run on the plain forms there, and the
swap that changes nothing is the port's own path."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (puts the port on the CPU)
from g3py_tpu_torch import settings
from g3py_tpu_torch.bayesian.registry import GraphicalModel
from g3py_tpu_torch.tools import f32_draws


@pytest.fixture(scope="module")
def report():
    GraphicalModel.active = None
    saved = settings.device, settings.floatx
    try:
        return f32_draws.draws_report(96, 24, "cpu")
    finally:
        GraphicalModel.active = None
        settings.device, settings.floatx = saved


@pytest.mark.parametrize("row", ["MAP", "row 0", "row 15"])
def test_stages_and_swaps_on_the_cpu(report, row):
    rec = report[row]
    assert rec["cond"] > 1.0 and rec["noise_var"] > 0.0
    stages = rec["stages"]["cpu"]
    assert all(np.isfinite(v) and v < 1e-2 for v in stages.values()), stages
    swaps = rec["swaps"]
    # on the CPU "k2" is the plain form: the port's swap is the CPU's stages
    port = swaps["port (k2, panels, k2)"]
    assert port == {k: stages[k] for k in port}
    assert swaps["grams: the CPU's plain form"] == port
    assert swaps["factor: plain form on the CPU"] == port
    # a float64 factor rounded to float32 is a better L^{-1} than the float32 one
    assert swaps["factor: float64 rounded to float32"]["linv"] < port["linv"]
    assert all(np.isfinite(v) for s in swaps.values() for v in s.values())
