"""The serving and training launchers' veneers among the port's examples
against the JAX package's (see ``test_torch_examples.py``): training runs
3 steps on both sides, each into a checkpoint directory of its own."""
import pytest

pytest.importorskip("torch")

from test_torch_examples_common import normalize, run_pair  # noqa: E402


def test_serve_example_prints_what_the_reference_prints():
    port, ref = run_pair("serve_lm")
    assert normalize(port) == normalize(ref)
    assert port.splitlines()[0].startswith("[device] cpu")


def test_train_example_prints_what_the_reference_prints(tmp_path):
    args = ["--arch", "qwen2.5-14b", "--preset", "smoke", "--steps", "3", "--batch", "8",
            "--seq", "64"]
    port, ref = run_pair("train_lm", [*args, "--ckpt-dir", str(tmp_path / "port")],
                         [*args, "--ckpt-dir", str(tmp_path / "ref")])
    assert normalize(port) == normalize(ref)
    assert len([line for line in normalize(port) if line.lstrip().startswith("step")]) == 3
    assert (tmp_path / "port").is_dir()
