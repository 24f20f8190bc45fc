"""The port's LM stack (``repro_torch.models``) against the JAX package's on
the same parameters: JAX ``init_params`` makes them, ``params_from_numpy``
carries them over, and both run prefill and greedy decode on the same
seeded prompts in float32.

Tolerance: logits within atol = rtol = 1e-4 — the sums run in another
order, and the reference's attention is a chunked online softmax where the
port takes one chunk directly.  Integer outputs (the hash router's expert
ids, the dispatch plan) must be identical.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 12
N_DECODE = 3


def _configs(arch: str, **moe):
    """The reference's and the port's reduced config, with ``moe`` fields
    replaced in both."""
    cfgs = []
    for make in (ref_reduced_config, reduced_config):
        cfg = make(arch)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        cfgs.append(cfg)
    return cfgs


@functools.cache
def _reference_params(arch: str):
    """The reference's parameters for ``arch``'s reduced config (the MoE
    router fields do not change them), and their numpy copy."""
    cfg = ref_reduced_config(arch)
    params = jax.jit(functools.partial(JM.init_params, cfg=cfg))(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _record_routes(monkeypatch, with_inputs=False):
    """Capture (layer salt, token ids, expert ids) of every port MoE call;
    ``with_inputs`` also keeps the router's input activations and the
    gates: (salt, token ids, x, expert ids, gates)."""
    log = []
    route = tmoe.route

    def recording(p, x, token_ids, layer_salt, cfg):
        out = route(p, x, token_ids, layer_salt, cfg)
        ids = out[0].numpy().copy()
        if with_inputs:
            log.append((layer_salt, token_ids.numpy().copy(), x.detach().numpy().copy(), ids,
                        out[1].numpy().copy()))
        else:
            log.append((layer_salt, token_ids.numpy().copy(), ids))
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    return log


def _run_both(arch, monkeypatch, batch=3, prompt=8, with_inputs=False, **moe):
    jcfg, tcfg = _configs(arch, **moe)
    jparams, host = _reference_params(arch)
    tparams = params_from_numpy(host, tcfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(batch, prompt)).astype(np.int32)
    log = _record_routes(monkeypatch, with_inputs)
    jcache, jl = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, MAX_LEN)
    tcache, tl = TM.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, MAX_LEN)
    steps = [(np.asarray(jl), tl.numpy())]
    for _ in range(N_DECODE):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
        jcache, jl = JM.decode_step(jparams, jcache, {"tokens": jnp.asarray(nxt)}, jcfg)
        tcache, tl = TM.decode_step(tparams, tcache, {"tokens": torch.from_numpy(nxt)}, tcfg)
        steps.append((np.asarray(jl), tl.numpy()))
    return jcfg, steps, log


@pytest.mark.parametrize(
    "moe",
    [
        dict(router="hash"),
        dict(router="hash", capacity_factor=1.25),  # tokens dropped past capacity
        dict(router="hash", router_hash_engine="jump"),
        dict(router="hash", router_dynamic_n=True),
    ],
    ids=["binomial", "binomial-drops", "jump", "dynamic-n"],
)
def test_hash_routed_moe_matches_reference(moe, monkeypatch):
    jcfg, steps, log = _run_both("qwen3-moe-235b-a22b", monkeypatch, **moe)
    for want, got in steps:
        assert got.shape == want.shape == (3, jcfg.padded_vocab)
        np.testing.assert_allclose(got, want, **TOL)
    n_moe = sum(k == "attn_moe" for k in jcfg.layer_kinds())
    assert len(log) == n_moe * (1 + N_DECODE)
    for salt, tokens, expert_ids in log:
        want, _, _ = jmoe.route(None, None, jnp.asarray(tokens.astype(np.int32)), salt, jcfg)
        np.testing.assert_array_equal(expert_ids, np.asarray(want))


def test_topk_routed_moe_matches_reference(monkeypatch):
    _, steps, _ = _run_both("qwen3-moe-235b-a22b", monkeypatch, router="topk", capacity_factor=1.25)
    for want, got in steps:
        np.testing.assert_allclose(got, want, **TOL)


def test_dense_stablelm_matches_reference(monkeypatch):
    jcfg, steps, log = _run_both("stablelm-3b", monkeypatch)
    assert jcfg.norm == "layernorm" and jcfg.rope_fraction == 0.25 and not log
    for want, got in steps:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_dispatch_plan_and_combine_match_reference(capacity_factor):
    rng = np.random.default_rng(2)
    N, K, E, D, F = 24, 2, 8, 16, 8
    C = max(1, int(capacity_factor * N * K / E))
    eids = rng.integers(0, E, size=(N, K)).astype(np.int32)
    gates = rng.random((N, K)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((E, D, F), (E, D, F), (E, F, D))]
    T = torch.from_numpy
    got = tmoe._routing_plan(T(eids), T(gates), 0, E, C, N, K)
    want = jmoe._routing_plan(jnp.asarray(eids), jnp.asarray(gates), 0, E, C, N, K)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    slot, stok, sg, keep = got
    jslot, jstok, jsg, jkeep = want
    buf = tmoe._scatter_buf(T(x), slot, stok, keep, E, C)
    np.testing.assert_allclose(buf.numpy(), np.asarray(jmoe._scatter_buf(jnp.asarray(x), jslot, jstok, jkeep, E, C)), **TOL)
    comb = tmoe._combine(buf, slot, stok, sg, keep, N, torch.float32)
    jcomb = jmoe._combine(jnp.asarray(buf.numpy()), jslot, jstok, jsg, jkeep, N, jnp.float32)
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), **TOL)
    y = tmoe._dispatch_local(T(x), T(eids), T(gates), *map(T, w), 0, E, C)
    jy = jmoe._dispatch_local(jnp.asarray(x), jnp.asarray(eids), jnp.asarray(gates), *map(jnp.asarray, w), 0, E, C)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


DSV3 = "deepseek-v3-671b"


@pytest.mark.parametrize(
    "moe",
    [dict(), dict(router="hash"), dict(router="hash", router_hash_engine="jump")],
    ids=["sigmoid", "hash-binomial", "hash-jump"],
)
def test_deepseek_v3_matches_reference(moe, monkeypatch):
    """DeepSeek-V3 reduced (MLA, 1 dense + 2 MoE layers, a shared expert):
    prefill and absorbed-decode logits within 1e-4, and the expert ids of
    every router call identical to the reference's router on the same
    inputs.  The sigmoid router's ids are compared in order: the port
    breaks equal selection scores toward the lower expert id, as
    ``lax.top_k`` does (a stable sort), so not even a tie may reorder
    them; its gates agree within 1e-6."""
    jcfg, steps, log = _run_both(DSV3, monkeypatch, with_inputs=True, **moe)
    assert jcfg.attention == "mla" and jcfg.moe.shared_experts == 1
    assert jcfg.layer_kinds() == ["attn", "attn_moe", "attn_moe"]
    for want, got in steps:
        assert got.shape == want.shape == (3, jcfg.padded_vocab)
        np.testing.assert_allclose(got, want, **TOL)
    n_moe = sum(k == "attn_moe" for k in jcfg.layer_kinds())
    assert len(log) == n_moe * (1 + N_DECODE)
    tparams = params_from_numpy(_reference_params(DSV3)[1], reduced_config(DSV3), "cpu")
    for salt, tokens, x, expert_ids, gates in log:
        p = {k: jnp.asarray(v.numpy()) for k, v in tparams["layers"][salt]["moe"].items()
             if k in ("router", "router_bias")}
        want, want_gates, _ = jmoe.route(p, jnp.asarray(x), jnp.asarray(tokens.astype(np.int32)),
                                         salt, jcfg)
        np.testing.assert_array_equal(expert_ids, np.asarray(want))
        np.testing.assert_allclose(gates, np.asarray(want_gates), atol=1e-6, rtol=1e-6)


def test_deepseek_v3_parameter_tree_matches_reference():
    """``init_params`` builds the reference's tree: every leaf's name,
    shape and dtype, the ``mtp`` subtree included (which serving never
    reads), and ``params_from_numpy`` carries every leaf over."""
    jparams, host = _reference_params(DSV3)
    cfg = reduced_config(DSV3)
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    carried = params_from_numpy(host, cfg, "cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for name, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{name}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{prefix}/{i}").items()}
        return {prefix: tree}

    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves(port).items()}
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves(carried).items()}
    want_mtp = {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in leaves(host["mtp"], "/mtp").items()}
    assert {k: v for k, v in got.items() if k.startswith("/mtp/")} == want_mtp
    assert {"/mtp/in_proj_mtp", "/mtp/block/moe/shared/wi", "/mtp/block/moe/router_bias",
            "/mtp/block/mixer/w_uk", "/mtp/norm_e/scale"} <= set(want_mtp)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert sum(v.numel() for v in leaves(port).values()) == n_ref
    for k, v in leaves(host["mtp"], "/mtp").items():
        np.testing.assert_array_equal(leaves(carried)[k].numpy(), v)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "stablelm-3b", DSV3, "starcoder2-7b",
                                  "recurrentgemma-9b", "mamba2-1.3b", "musicgen-medium",
                                  "qwen2-vl-7b"])
def test_empty_cache_matches_reference(arch):
    """``init_cache``: one dict per layer ({k, v, pos}, MLA's {ckv, kr,
    pos}, RG-LRU's {h, conv}, SSD's {state, conv}), the reference's stacked
    leaves split along their scan axis, with their dtypes."""
    jcfg, tcfg = ref_reduced_config(arch), reduced_config(arch)
    want = JM.init_cache(jcfg, 2, MAX_LEN)
    got = TM.init_cache(tcfg, 2, MAX_LEN, "cpu")
    assert got["cur"] == int(want["cur"]) == 0 and len(got["layers"]) == jcfg.num_layers
    layer = 0
    for i, seg in enumerate(B.build_segments(tcfg)):
        for step in range(seg.count):
            for j in range(len(seg.unit)):
                names = want[f"seg{i}"][f"sub{j}"]
                assert sorted(got["layers"][layer]) == sorted(names)
                for name, leaf in names.items():
                    g = got["layers"][layer][name]
                    assert str(g.dtype) == f"torch.{leaf.dtype}"
                    np.testing.assert_array_equal(g.numpy(), np.asarray(leaf[step]))
                layer += 1
