"""The port's debug surface (:mod:`g3py_tpu_torch.utils.debug`): the value
tap prints only when enabled (and ``compat.debug_p`` with it), the op graph
of a call, ``debug_mode`` raising on a NaN made in the forward or the
backward inside the block (and nowhere else), and ``profile_trace``
writing a chrome trace."""

import json
import os

import pytest
import torch

import g3py_tpu_torch as g3t
from g3py_tpu_torch.utils import debug as dbg

import torch_parity  # noqa: F401  (puts the port on the CPU)


def test_tap_prints_only_when_enabled(capsys):
    x = torch.tensor([1.0, 2.0])
    assert g3t.debug(x, "x") is x
    g3t.debug_p("hidden")
    assert capsys.readouterr().out == ""
    g3t.set_debug(True)
    try:
        g3t.debug(x, "x")
        g3t.debug_p("shown")
    finally:
        g3t.set_debug(False)
    out = capsys.readouterr().out
    assert "x = tensor([1., 2.])" in out and "shown" in out
    g3t.debug(3, "k", force=True)
    assert capsys.readouterr().out == "k = 3\n"


def test_graph_of_a_call(tmp_path, capsys):
    fn = lambda a, b: torch.exp(a) @ b  # noqa: E731
    a, b = torch.ones(2, 2), torch.ones(2, 3)
    txt = g3t.show_graph(fn, a, b, path=str(tmp_path / "g.txt"))
    assert "aten.exp" in txt and "aten.mm" in txt
    assert open(tmp_path / "g.txt").read() == txt
    gm = g3t.print_graph(fn, a, b)
    assert "exp" in capsys.readouterr().out
    torch.testing.assert_close(gm(a, b), fn(a, b))


def test_debug_mode_raises_on_nans():
    with g3t.debug_mode():
        torch.log(torch.tensor([1.0, 2.0]))  # finite: no error
    with pytest.raises(FloatingPointError, match="NaN"):
        with g3t.debug_mode():
            torch.log(torch.tensor([-1.0]))
    x = torch.tensor([0.0], requires_grad=True)
    # the backward's ops go through the same check (or anomaly mode's)
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan"):
        with g3t.debug_mode():
            # the forward is finite, the backward 0 * inf = NaN
            torch.sqrt(x * torch.tensor([0.0])).sum().backward()
    with g3t.debug_mode(nans=False):
        torch.log(torch.tensor([-1.0]))
    assert not dbg._DEBUG


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace")
    with g3t.profile_trace(path) as p:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert p == path
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
