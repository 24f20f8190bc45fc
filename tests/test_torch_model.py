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
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
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


def _record_routes(monkeypatch):
    """Capture (layer salt, token ids, expert ids) of every port MoE call."""
    log = []
    route = tmoe.route

    def recording(p, x, token_ids, layer_salt, cfg):
        out = route(p, x, token_ids, layer_salt, cfg)
        log.append((layer_salt, token_ids.numpy().copy(), out[0].numpy().copy()))
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    return log


def _run_both(arch, monkeypatch, batch=3, prompt=8, **moe):
    jcfg, tcfg = _configs(arch, **moe)
    jparams, host = _reference_params(arch)
    tparams = params_from_numpy(host, tcfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(batch, prompt)).astype(np.int32)
    log = _record_routes(monkeypatch)
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


@pytest.mark.parametrize(
    "arch", sorted(a for a in ARCHS if a not in ("qwen3-moe-235b-a22b", "stablelm-3b", "deepseek-coder-33b", "qwen2.5-14b"))
)
def test_unported_flavours_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TM.init_params(torch.Generator().manual_seed(0), reduced_config(arch))


def test_sigmoid_router_raises():
    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="sigmoid"))
    with pytest.raises(NotImplementedError, match="sigmoid"):
        TM.init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "stablelm-3b"])
def test_empty_cache_matches_reference(arch):
    """``init_cache``: one {k, v, pos} per layer, the reference's stacked
    leaves split along their scan axis."""
    jcfg, tcfg = ref_reduced_config(arch), reduced_config(arch)
    want = JM.init_cache(jcfg, 2, MAX_LEN)
    got = TM.init_cache(tcfg, 2, MAX_LEN, "cpu")
    assert got["cur"] == int(want["cur"]) == 0 and len(got["layers"]) == jcfg.num_layers
    layer = 0
    for i, seg in enumerate(B.build_segments(tcfg)):
        for step in range(seg.count):
            for j in range(len(seg.unit)):
                for name, leaf in want[f"seg{i}"][f"sub{j}"].items():
                    np.testing.assert_array_equal(got["layers"][layer][name].numpy(), np.asarray(leaf[step]))
                layer += 1
