"""The port's examples (``examples/*_torch.py``) against the JAX package's:
each run with ``--device cpu`` prints what its counterpart prints, the
times masked and the numbers that follow the random weights left out; none
imports JAX or the JAX package; and none runs without a card unless asked.
``test_torch_examples_tiers.py`` and ``test_torch_examples_serving.py``
hold the rest of the seven."""
import ast
import importlib.util

import pytest

pytest.importorskip("torch")

from test_torch_examples_common import EXAMPLES, NAMES, normalize, run_pair  # noqa: E402


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["quickstart", "elastic_cluster", "placement_demo"])
def test_example_prints_what_the_reference_prints(name):
    port, ref = run_pair(name)
    assert normalize(port) == normalize(ref)
    lines = port.splitlines()
    assert lines[0].startswith("[device] cpu: the kernels' plain torch versions")
    if name == "quickstart":  # it says that the kernel did not run; it claims no match
        (kernel,) = [line for line in lines if line.startswith("cuda kernel")]
        assert "not run" in kernel and "match" not in kernel


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    roots = set()
    for node in ast.walk(ast.parse((EXAMPLES / f"{name}_torch.py").read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_the_card_unless_asked(name):
    """With no ``--device`` an example runs on the CUDA device, and raises
    where there is none: no silent run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
