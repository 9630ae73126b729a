"""Phase 11 of chip_smoke.py stays on the card: read-only checks of the
script's source on the CPU (nothing here calls ``main()`` or any run).

The script is loaded from the repository root with ``importlib`` and its
phase-11 runs are found through the module (the ones it lists, each marked
as a card run).  Every run, and every helper of the script that it reaches
by name, never names the CPU as a device (``settings.device = "cpu"``,
``device="cpu"``, ``torch.device("cpu")``) — except one marked replay on
the CPU, the single such site.  ``main()`` hands the runs' batched launch
counts to the ``kernels`` record's batched K1 and K2 entries and requires
both above zero, as it does for phase 10.
"""

import ast
import importlib.util
import inspect
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_source", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # inspect finds its classes' source through it
    try:
        spec.loader.exec_module(module)
        yield module
    finally:
        del sys.modules[spec.name]


def _tree(obj):
    return ast.parse(textwrap.dedent(inspect.getsource(obj)))


def _runs(smoke):
    runs = [v for v in vars(smoke).values()
            if isinstance(v, tuple) and v and all(getattr(f, "card_only", False) for f in v)]
    assert len(runs) == 1, "chip_smoke.py lists its card runs in one tuple"
    return runs[0]


def _reached(smoke, roots):
    """The script's own functions and classes reached by name from
    ``roots``, the roots included."""
    seen, todo = {}, list(roots)
    while todo:
        obj = todo.pop()
        if obj.__name__ in seen:
            continue
        seen[obj.__name__] = obj
        for node in ast.walk(_tree(obj)):
            if isinstance(node, ast.Name):
                target = getattr(smoke, node.id, None)
                if (inspect.isfunction(target) or inspect.isclass(target)) and \
                        getattr(target, "__module__", None) == smoke.__name__:
                    todo.append(target)
    return seen


def _names_cpu(obj):
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and n.value.split(":")[0] == "cpu" for n in ast.walk(_tree(obj)))


def test_phase11_runs_are_card_runs(smoke):
    runs = _runs(smoke)
    assert len(runs) >= 7
    for run in runs:
        assert run.card_only and inspect.isfunction(run)


def test_no_cpu_site_but_the_replay(smoke):
    reached = _reached(smoke, _runs(smoke))
    cpu_sites = sorted(name for name, obj in reached.items() if _names_cpu(obj))
    replays = sorted(name for name, obj in reached.items() if getattr(obj, "cpu_replay", False))
    assert len(replays) == 1, replays
    assert cpu_sites == replays, cpu_sites
    assert not getattr(reached[replays[0]], "card_only", False)


def _runner_counts(smoke):
    """The name of the list that main() hands to the function that calls every
    phase-11 run (its last argument)."""
    runs = set(_runs(smoke))
    for node in ast.walk(_tree(smoke.main)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            target = getattr(smoke, node.func.id, None)
            if inspect.isfunction(target) and target not in runs and \
                    runs <= set(_reached(smoke, [target]).values()):
                assert isinstance(node.args[-1], ast.Name)
                return node.args[-1].id
    raise AssertionError("main() does not drive the phase-11 runs")


def _reads(expr, name, index):
    return any(isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
               and n.value.id == name and isinstance(n.slice, ast.Constant)
               and n.slice.value == index for n in ast.walk(expr))


def test_record_reads_phase11_batched_counts(smoke):
    name = _runner_counts(smoke)
    entries = {}
    for node in ast.walk(_tree(smoke.main)):
        if isinstance(node, ast.Dict):
            keys = [k.value if isinstance(k, ast.Constant) else None for k in node.keys]
            if "name" in keys and "launches" in keys:
                label = node.values[keys.index("name")]
                if isinstance(label, ast.Constant):
                    entries[label.value] = node.values[keys.index("launches")]
    batched = {k: v for k, v in entries.items() if k.endswith("_batched")}
    assert len(batched) == 2, sorted(entries)
    k1 = [v for k, v in batched.items() if "gram" in k]
    k2 = [v for k, v in batched.items() if "cholesky" in k]
    assert k1 and _reads(k1[0], name, 0) and k2 and _reads(k2[0], name, 1)


def test_main_requires_both_counts_above_zero(smoke):
    name = _runner_counts(smoke)

    def above_zero(expr, index):
        return any(isinstance(n, ast.Compare) and _reads(n.left, name, index)
                   and isinstance(n.ops[0], ast.Gt) and isinstance(n.comparators[0], ast.Constant)
                   and n.comparators[0].value == 0 for n in ast.walk(expr))

    calls = [n for n in ast.walk(_tree(smoke.main)) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "require"]
    assert any(above_zero(c.args[0], 0) and above_zero(c.args[0], 1) for c in calls)
