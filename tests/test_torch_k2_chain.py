"""The K2 timeline tool's trace parsing (g3py_tpu_torch/tools/k2_chain.py)
on synthetic chrome-trace events: the tool itself needs a card, its cutting
of a trace into panels does not."""

import pytest

from g3py_tpu_torch.tools.k2_chain import _label, chain_summary

MAIN, SIDE = 7, 14


def _evt(name, ts, dur, stream, grid=(1, 1, 1)):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream, "grid": list(grid)}}


def _trace(with_prep=True):
    """prep on the caller's stream, then three panels on the side stream
    40 us apart, each tile followed by its product and the next panel's T1,
    with the caller's T2 beside them."""
    ev = [_evt("void (anonymous namespace)::prep_kernel<float>(...)", 0.0, 40.0, MAIN)] \
        if with_prep else []
    for k in range(3):
        t = 50.0 + 40.0 * k
        ev.append(_evt("void (anonymous namespace)::diag_kernel<float, 128>(...)", t, 27.0, SIDE))
        if k < 2:
            ev.append(_evt("void (anonymous namespace)::sgemm_rows_16<false>(...)", t + 28, 5.0,
                           SIDE, (8 * (2 - k), 1, 1)))
            ev.append(_evt("void (anonymous namespace)::sgemm_rows_16<true>(...)", t + 34, 5.0,
                           SIDE, (8 * (2 - k) + 8, 1, 1)))
            ev.append(_evt("(anonymous namespace)::sgemm_nt_128(...)", t + 30, 15.0, MAIN,
                           (3 - k, 1, 1)))
    return ev


@pytest.mark.parametrize("with_prep", [True, False])
def test_chain_summary_cuts_panels_at_tile_starts(with_prep):
    got = chain_summary(list(reversed(_trace(with_prep))))  # any order
    assert got["side"] == SIDE
    assert got["chains"] == [40.0, 40.0]
    assert got["diag_us"] == [27.0, 27.0, 27.0]
    t0 = 0.0 if with_prep else 50.0
    assert got["span_us"] == 50.0 + 80.0 + 27.0 - t0
    assert [p[0] for p in got["panels"]] == [50.0 - t0, 90.0 - t0, 130.0 - t0]
    first = got["panels"][0][2]
    assert first == [("side", "diag[1]", 27.0), ("side", "prod[16]", 5.0),
                     ("main", "syrk[3]", 15.0), ("side", "upd[24]", 5.0)]
    assert got["busy_us"][SIDE] == 3 * 27.0 + 4 * 5.0
    assert got["busy_us"][MAIN] == 2 * 15.0 + (40.0 if with_prep else 0.0)


def test_chain_summary_without_a_tile_is_none():
    assert chain_summary([_evt("void (anonymous namespace)::prep_kernel<float>(...)",
                               0.0, 40.0, MAIN)]) is None


def test_labels():
    assert _label(_evt("Memcpy DtoD (Device -> Device)", 0, 1, MAIN)) == "memcpy"
    assert _label(_evt("void (anonymous namespace)::finish_kernel<float>(...)", 0, 1, MAIN)) \
        == "finish"
    # any other kernel: its name cut to 24 characters, and its block count
    assert _label(_evt("void at::native::elementwise_kernel<128>(...)", 0, 1, MAIN, (2, 3, 1))) \
        == "void at::native::element[6]"
