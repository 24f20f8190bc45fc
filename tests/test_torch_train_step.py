"""The port's train step (``repro_torch.training``) against the JAX
package's jitted ``make_train_step``: three steps from the same stacked
parameters over the same seeded batches, comparing parameters, optimizer
state and metrics after each (``test_torch_train_common.run_steps``), for AdamW
(with and without master weights; Adafactor is
``test_torch_train_adafactor.py``), gradient accumulation 1 and 2,
compression none / int8 / topk and active clipping, and for the MoE
architectures; the train state's tree (every leaf's keystr path, shape
and dtype); the schedule, the compression hooks and the clip on their
own.

Tolerance: ``test_torch_train_common.TOL`` of max(1, max |reference|) per leaf
and metric.  The schedule and the compression hooks are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.training import compression as JC  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.training import compression as TC  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TT  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train_common import (  # noqa: E402
    HPARAM_IDS, HPARAMS, _configs, _reference_params, assert_close, assert_tree_close,
    make_batch, run_steps,
)


@pytest.mark.parametrize("hp", HPARAMS, ids=HPARAM_IDS)
def test_train_step_matches_reference(hp):
    jm, _ = run_steps("stablelm-3b", "adamw", **hp)
    if hp.get("clip_norm"):
        assert float(jm["grad_norm"]) > hp["clip_norm"]  # the clip was active


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_moe_train_step_matches_reference(arch):
    run_steps(arch, "adamw", grad_accum=2)


def test_adamw_without_master_weights_matches_reference():
    run_steps("stablelm-3b", "adamw", opt_kw=dict(master_weights=False))


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 9999, 10000, 12000])
def test_warmup_cosine_matches_reference(step):
    want = np.asarray(JO.warmup_cosine(3e-4, 100, 10000)(step))
    got = TO.warmup_cosine(3e-4, 100, 10000)(step).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got == want, (got, want)


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("shape", [(64, 64), (3, 17, 5), (1,)])
def test_compression_matches_reference(kind, shape):
    """Two rounds of each hook with error feedback, bit for bit (the top-k
    threshold with ties at it: values repeat)."""
    rng = np.random.default_rng(3)
    g = (rng.integers(-40, 40, size=shape) / 8).astype(np.float32)
    jerr, terr = {"w": jnp.zeros(shape, jnp.float32)}, {"w": torch.zeros(shape)}
    for _ in range(2):
        jg, jerr = JC.apply_compression({"w": jnp.asarray(g)}, jerr, kind)
        tg, terr = TC.apply_compression({"w": torch.from_numpy(g)}, terr, kind)
        np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
        np.testing.assert_array_equal(terr["w"].numpy(), np.asarray(jerr["w"]))


def test_compression_none_is_identity():
    g = {"w": torch.ones(3)}
    out, err = TC.apply_compression(g, None, "none")
    assert out is g and err is None


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    tree = {"b": rng.normal(size=(7,)).astype(np.float32),
            "a": {"w": rng.normal(size=(5, 3)).astype(np.float32)}}
    jg, jn = JT._clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    tg = jax.tree.map(torch.from_numpy, tree)
    blocks = leaves(tg)  # the step's clip: the norm from the blocks (with no mesh the
    tn = TO.Zero1(tg).global_norm(blocks)  # leaves), then the scale
    TT._scale_to(blocks, max_norm, tn)
    assert_close(tn.numpy(), jn, "norm")
    assert_tree_close(tg, jg, "clipped ")


def test_serve_steps_read_the_stacked_params():
    _, tcfg = _configs("qwen3-moe-235b-a22b")
    _, host = _reference_params("qwen3-moe-235b-a22b")
    params = train_state_from_numpy(host, "cpu")
    prefill, decode = TT.make_serve_steps(dataclasses.replace(tcfg), 12)
    tokens = torch.from_numpy(make_batch(tcfg)["tokens"][:, :8])
    cache, logits = prefill(params, {"tokens": tokens})
    cache, nxt = decode(params, cache, {"tokens": logits.argmax(-1, keepdim=True).int()})
    assert logits.shape == nxt.shape == (2, tcfg.padded_vocab) and cache["cur"] == 9
