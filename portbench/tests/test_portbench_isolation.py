"""The benchmark stands apart from the JAX package: no module under
``portbench/`` imports ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level
names compared whole, so ``repro_torch`` is not ``repro``), nothing in
``portbench/reference/`` imports the port, and nothing reads the JAX
package's benchmark record.
"""
import ast
import re
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _modules():
    return sorted(PORTBENCH.rglob("*.py"))


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, statically or
    through ``importlib.import_module`` / ``__import__`` with a literal."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_scan_sees_every_module():
    names = {p.relative_to(PORTBENCH).as_posix() for p in _modules()}
    assert {"run.py", "harness/cell.py", "reference/hashing.py", "loops/route.py"} <= names


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.relative_to(PORTBENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & (BANNED | {"repro_torch"})
    assert _imports(path) <= {"__future__", "dataclasses", "numpy", "torch", "portbench"}


def test_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch\nfrom repro_torch.x import y\nimport importlib\n"
                     "importlib.import_module('jaxlib.xla')\n")
    assert _imports(probe) == {"repro_torch", "importlib", "jaxlib"}
    assert not _imports(probe) & (BANNED - {"jaxlib"})


READS = re.compile(r"""["'/](benchmarks/|BENCH_[A-Za-z0-9_*]*\.json|chip_smoke)""")


@pytest.mark.parametrize("path", [p for p in _modules() if p.parent.name != "tests"],
                         ids=lambda p: p.relative_to(PORTBENCH).as_posix())
def test_nothing_reads_the_jax_record(path):
    assert not READS.search(path.read_text())
