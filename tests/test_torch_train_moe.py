"""The port's training loss and gradients against the JAX package's for
the MoE architectures (Qwen3 with softmax top-k and its aux loss,
DeepSeek-V3 with MLA, the sigmoid router, a shared expert and the MTP
loss), the hash router on both engines, with ``router_dynamic_n`` and
with tokens dropped past capacity; remat ``"full"`` and ``"dots"`` against
``"none"``; the softmax top-k router's tie order and aux loss against
``repro.models.layers.moe.route``.  Tolerance: ``test_torch_train_common.TOL``
of max(1, max |reference|); expert ids exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train_common import _configs, assert_matches, run_both  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_moe_loss_and_grads_match_reference(arch):
    assert_matches(*run_both(arch))


@pytest.mark.parametrize(
    "moe",
    [dict(router="hash"), dict(router="hash", router_hash_engine="jump"),
     dict(router="hash", router_dynamic_n=True), dict(router="hash", capacity_factor=1.25)],
    ids=["binomial", "jump", "dynamic-n", "binomial-drops"],
)
def test_hash_routed_loss_and_grads_match_reference(moe):
    ref, port = run_both("qwen3-moe-235b-a22b", moe)
    assert float(port[1]["aux"]) == 0.0
    assert_matches(ref, port)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b", "recurrentgemma-9b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat(arch, remat):
    """Recomputation runs the same operators on the same inputs: the
    port's loss and gradients under remat equal its own without, bit for
    bit, and so match the reference."""
    ref, full = run_both(arch, remat=remat)
    _, none = run_both(arch, remat="none")
    assert float(full[0]) == float(none[0])
    for a, b in zip(leaves(full[2]), leaves(none[2])):
        assert torch.equal(a, b)
    assert_matches(ref, full)


# --- the softmax top-k router ------------------------------------------------


def _router_case(tied: bool):
    jcfg, tcfg = _configs("qwen3-moe-235b-a22b")
    rng = np.random.default_rng(5)
    router = (rng.normal(size=(jcfg.d_model, jcfg.moe.num_experts)) * 0.006).astype(np.float32)
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    if tied:
        x[0, :3] = 0.0  # every probability equal: ties across the k-th place
        router[:, 2] = router[:, 5]  # two experts tied on every token
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 6)).astype(np.int32)
    want = jmoe.route({"router": jnp.asarray(router)}, jnp.asarray(x), jnp.asarray(tokens), 0, jcfg)
    got = tmoe.route({"router": torch.from_numpy(router)}, torch.from_numpy(x),
                     torch.from_numpy(tokens), 0, tcfg)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_topk_router_matches_reference(tied):
    """Equal probabilities go to the lower expert id first, as
    ``lax.top_k`` orders them; expert ids exact, gates and aux within
    1e-6."""
    (w_ids, w_gates, w_aux), (g_ids, g_gates, g_aux) = _router_case(tied)
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_allclose(g_gates, w_gates, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(g_aux, w_aux, atol=1e-6, rtol=1e-6)
    if tied:
        assert (g_ids[0, :3] == [0, 1]).all()
