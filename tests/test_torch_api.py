"""The port's top-level API: ``repro_torch.__all__`` is the JAX package's
``repro.__all__``, each name resolves lazily to the object of the port
module that defines it, and ``import repro_torch`` imports no submodule (no
kernel build, no JAX)."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_all_is_the_reference_surface():
    repro = pytest.importorskip("repro")
    assert set(repro_torch.__all__) == set(repro.__all__)
    assert len(repro_torch.__all__) == len(set(repro_torch.__all__)) == 27


@pytest.mark.parametrize("name", sorted(repro_torch._EXPORTS))
def test_name_resolves_to_its_port_module_object(name):
    repro = pytest.importorskip("repro")
    module = repro_torch._EXPORTS[name]
    assert module == repro._EXPORTS[name].replace("repro.", "repro_torch.", 1)
    assert getattr(repro_torch, name) is getattr(importlib.import_module(module), name)
    assert name in dir(repro_torch)


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="no attribute 'route_everything'"):
        repro_torch.route_everything  # noqa: B018


def test_import_loads_no_submodule_nor_jax():
    code = ("import json, sys\nimport repro_torch\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.startswith(('repro', 'jax')))))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["repro_torch"]
