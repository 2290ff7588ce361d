"""What the benchmark may import: nothing under perfbench/ imports a
module whose top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the port's ``repro_torch`` begins with ``repro``
and is another name), and the reference, with every layer kind under
``layers/``, imports nothing of the port."""
import ast
import subprocess
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the harness modules the reference uses: the inputs it makes itself
REFERENCE_SIDE = ["reference/model.py", "reference/wire.py",
                  "reference/step.py", "harness/shapes.py",
                  "harness/traffic.py", "harness/weights.py"] + sorted(
    str(p.relative_to(BENCH)) for p in (BENCH / "layers").glob("*.py"))


def imported(path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    are within perfbench/)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("rel", REFERENCE_SIDE)
def test_reference_imports_nothing_of_the_port(rel):
    names = imported(BENCH / rel)
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "json", "pathlib", "typing",
                     "importlib", "numpy", "torch", "harness", "reference",
                     "layers"}


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, %r); import reference.step; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"repro_torch"})
