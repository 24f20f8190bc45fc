"""The torch package stands alone: importing it (every submodule) pulls in
neither ``jax`` nor any module of the JAX package ``repro``;
``chip_smoke.py`` imports neither; and the entry points refuse to run on a
machine without CUDA unless the caller asks for the CPU."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _submodules() -> list[str]:
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_every_submodule_imports_without_jax_or_repro():
    mods = _submodules()
    assert {"repro_torch.serving.batch_router", "repro_torch.kernels.fused",
            "repro_torch.interop", "repro_torch.serving.engine", "repro_torch.models.model",
            "repro_torch.launch.serve"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_chip_smoke_fails_without_cuda():
    """No CUDA: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
        env=_env(), timeout=120, cwd=ROOT,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_batch_router_defaults_to_cuda_and_raises_without_it():
    from repro_torch.serving.batch_router import BatchRouter

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRouter(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRouter(8, device="cuda")
    assert BatchRouter(8, device="cpu").device.type == "cpu"


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels.fused import BINOMIAL

    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        BINOMIAL.route(keys, keys.to("meta"), keys, keys[:2])
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.lookup_dyn(keys.to("meta"), keys[:1].to("meta"))
    with pytest.raises(ValueError, match="agree in shape"):
        BINOMIAL.ingest(keys, keys[:3], keys, keys, keys[:2])
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.lookup_vec(keys.to("meta"), 10)
    assert BINOMIAL.launches == {"route": 0, "ingest": 0, "lookup_dyn": 0, "lookup_vec": 0}
