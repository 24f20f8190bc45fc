"""The port's ``ServingTier(mesh=..., router_spec=...)`` on 1 and 2 gloo
ranks on the CPU against the JAX package's ``ServingTier`` (unmeshed: the
reference shows its meshed routing identical to the unmeshed one), on the
reduced hash-routed Qwen3-MoE, through a failure of replica 1.  Replica
ids and generated tokens must be identical on every rank.  On one rank the
model also serves under ``mesh_context`` with its parameters cut by
``params_local``: its 12-token prompts take the expert-parallel body in
prefill and the dense GShard path in decode.  ``router_spec`` together
with ``engine`` or ``shard_axis`` must raise on both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.core.bulk import RouterSpec as RefRouterSpec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingTier as RefServingTier  # noqa: E402
from test_torch_mesh_common import serving_mesh_rank, spawn  # noqa: E402

N_NEW, PROMPT = 4, 12


@pytest.fixture(scope="module")
def reference_serve():
    cfg = ref_reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="hash"))
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    requests = [(f"user-{i}", rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32))
                for i in range(24)]
    tier = RefServingTier(cfg, params, 3, max_len=PROMPT + N_NEW)
    serves = []
    for failed in (None, 1):
        if failed is not None:
            tier.fail(failed)
        got = tier.serve([RefRequest(s, p, N_NEW) for s, p in requests])
        serves.append({"tokens": {k: np.asarray(v) for k, v in got.items()},
                       "routes": [tier.router.route(s) for s, _ in requests]})
    for clash in (dict(engine="jump"), dict(shard_axis="data")):
        with pytest.raises(ValueError, match="router_spec"):
            RefServingTier(cfg, params, 3, router_spec=RefRouterSpec(), **clash)
    return jax.tree.map(np.asarray, params), requests, serves


@pytest.mark.parametrize("world", [1, 2])
def test_meshed_serving_tier_matches_reference(world, reference_serve, tmp_path):
    tree, requests, want = reference_serve
    ranks = spawn(serving_mesh_rank, world, tmp_path, tree, requests, N_NEW, PROMPT + N_NEW)
    for res in ranks:
        assert "router_spec" in res["clash"]
        for got, ref in zip(res["serves"], want):
            assert got["routes"] == ref["routes"]
            np.testing.assert_array_equal(got["batch_routes"], ref["routes"])
            assert sorted(got["tokens"]) == sorted(ref["tokens"])
            for sid, tokens in ref["tokens"].items():
                np.testing.assert_array_equal(got["tokens"][sid], tokens)
        moved = [a != b for a, b in zip(*(s["routes"] for s in res["serves"]))]
        assert any(moved) and all(
            before == 1 for before, m in zip(res["serves"][0]["routes"], moved) if m)
        if world == 1:  # both mesh branches served
            assert res["calls"]["_ep_moe"] > 0 and res["calls"]["_dense_moe"] > 0, res["calls"]
        else:
            assert res["calls"] == {"_ep_moe": 0, "_dense_moe": 0}
