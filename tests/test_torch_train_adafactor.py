"""The port's Adafactor train step against the JAX package's jitted
``make_train_step`` (``test_torch_train_common.run_steps``): three steps from
the same stacked parameters and batches, its factored moments per stacked
leaf and its ``f`` list in the reference's flatten order, with gradient
accumulation, each compression and an active clip.  Tolerance:
``test_torch_train_common.TOL`` of max(1, max |reference|) per leaf and
metric (int8's level flips as ``run_steps`` says).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_train_common import HPARAM_IDS, HPARAMS, run_steps  # noqa: E402


@pytest.mark.parametrize("hp", HPARAMS, ids=HPARAM_IDS)
def test_adafactor_train_step_matches_reference(hp):
    jm, _ = run_steps("stablelm-3b", "adafactor", **hp)
    if hp.get("clip_norm"):
        assert float(jm["grad_norm"]) > hp["clip_norm"]  # the clip was active
