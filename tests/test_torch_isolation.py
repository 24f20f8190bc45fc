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
            "repro_torch.launch.serve", "repro_torch.serving.lifecycle.journal",
            "repro_torch.serving.lifecycle.detector", "repro_torch.serving.lifecycle.manager",
            "repro_torch.observability.trace", "repro_torch.placement.store",
            "repro_torch.placement.assignment", "repro_torch.core.placement_torch",
            "repro_torch.observability.metrics", "repro_torch.observability.alarms",
            "repro_torch.observability.export", "repro_torch.observability.load",
            "repro_torch.serving.streaming.clock", "repro_torch.serving.streaming.admission",
            "repro_torch.serving.streaming.hedge", "repro_torch.serving.streaming.batcher",
            "repro_torch.serving.streaming.frontend", "repro_torch.core.baselines",
            "repro_torch.core.analysis", "repro_torch.analysis.markers",
            "repro_torch.models.layers.mla", "repro_torch.models.layers.rglru",
            "repro_torch.models.layers.ssd", "repro_torch.tree", "repro_torch.training.optimizer",
            "repro_torch.training.compression", "repro_torch.training.train_step",
            "repro_torch.training.checkpoint", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.analysis.report",
            "repro_torch.analysis.certify", "repro_torch.analysis.lint",
            "repro_torch.analysis.sass", "repro_torch.analysis.sass_gate",
            "repro_torch.analysis.__main__", "repro_torch.roofline.hw",
            "repro_torch.roofline.op_cost", "repro_torch.roofline.analysis"} <= set(mods)
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
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.route_family(keys.to("meta"), 3, keys.to("meta"), keys.to("meta"),
                              keys[:2].to("meta"))
    # the plain version and the kernels take any r >= 1
    assert BINOMIAL.route_family(keys, 9, keys, keys, torch.tensor([8, 8])).shape == (4, 9)
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.resolve(keys.to("meta"), keys.reshape(4, 1).to("meta"), keys.to("meta"),
                         keys[:2].to("meta"), 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.route_load(keys.to("meta"), keys.to("meta"), keys.to("meta"), keys[:2].to("meta"),
                            keys.to("meta"))
    with pytest.raises(ValueError, match="CUDA devices"):
        BINOMIAL.chain_remap(keys.to("meta"), keys.to("meta"), keys.to("meta"),
                             keys[:2].to("meta"))
    assert BINOMIAL.launches == {"route": 0, "ingest": 0, "lookup_dyn": 0, "lookup_vec": 0,
                                 "route_family": 0, "resolve": 0, "route_load": 0,
                                 "chain_remap": 0}
