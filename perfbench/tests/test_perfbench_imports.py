"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is the port, not ``repro``); the
references, the inputs, the judge and the work arithmetic import nothing
of the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ["reference/*.py", "inputs.py", "judge.py", "quant_judge.py",
             "work/*.py", "trace.py"]


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for g in YARDSTICK
                                        for p in BENCH.glob(g)),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)


def test_whole_names_are_compared(monkeypatch):
    import sys

    from perfbench import bench

    monkeypatch.setitem(sys.modules, "repro_torch_probe", sys)
    assert "repro_torch_probe" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe", sys)
    assert "repro.probe" in bench.forbidden_modules()
