"""The rest of the port's LM stack against the JAX package's on the same
parameters: sliding windows and their ring caches (Starcoder2,
RecurrentGemma), RG-LRU (RecurrentGemma), Mamba-2 SSD (Mamba2), sinusoidal
positions over embeds inputs (MusicGen) and M-RoPE over embeds inputs
(Qwen2-VL).  The reference's ``init_params`` makes the parameters of each
reduced config, ``params_from_numpy`` carries them over, and both run
prefill and greedy decode on the same seeded inputs in float32.

Tolerance: logits within atol = rtol = 1e-4, as in ``test_torch_model``.
The sums run in another order: the reference's attention is a chunked
online softmax where the port takes a direct softmax over each query
chunk's band, and its einsums contract three operands in their own order.
The RG-LRU scan combines its pairs in the reference's order (the odd/even
recursion of ``jax.lax.associative_scan``).  Greedy tokens must be
identical.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import common as jcommon  # noqa: E402
from repro.models.layers import rglru as jrglru  # noqa: E402
from repro.models.layers import ssd as jssd  # noqa: E402
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import common as tcommon  # noqa: E402
from repro_torch.models.layers import rglru as trglru  # noqa: E402
from repro_torch.models.layers import ssd as tssd  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
N_DECODE = 3
BATCH = 2
FAMILIES = ("starcoder2-7b", "recurrentgemma-9b", "mamba2-1.3b", "musicgen-medium", "qwen2-vl-7b")
#: 8 tokens: the windowed caches are padded (max_len 12 < window 16); 24
#: tokens: past the reduced window of 16, so the ring path runs, and three
#: SSD chunks of 8
PROMPTS = (8, 24)


@functools.cache
def _reference(arch: str):
    """The reference's reduced config and parameters for ``arch``, their
    numpy copy, and the port's parameters carried over from it."""
    cfg = ref_reduced_config(arch)
    params = jax.jit(functools.partial(JM.init_params, cfg=cfg))(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    return cfg, params, host, params_from_numpy(host, reduced_config(arch), "cpu")


@functools.cache
def _jitted(arch: str, max_len: int):
    """The reference's prefill and decode, jitted as its ``Replica`` does."""
    cfg = ref_reduced_config(arch)
    return (jax.jit(lambda p, b: JM.prefill(p, b, cfg, max_len)),
            jax.jit(lambda p, c, b: JM.decode_step(p, c, b, cfg)))


def _inputs(cfg, S: int, seed: int):
    """Seeded inputs of S prompt positions and N_DECODE decode steps: token
    ids, or embeddings (and, for M-RoPE, three position streams whose
    height and width streams differ from the temporal one)."""
    rng = np.random.default_rng(seed)
    n = S + N_DECODE
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, size=(BATCH, n)).astype(np.int32)}
    batch = {"embeds": rng.standard_normal((BATCH, n, cfg.d_model)).astype(np.float32)}
    if cfg.input_mode == "embeds_mrope":
        t = np.arange(S, dtype=np.int32)
        batch["positions"] = np.broadcast_to(np.stack([t, t // 2, t % 3])[:, None], (3, BATCH, S)).copy()
    return batch


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_reference(arch, prompt):
    """Prefill and three greedy decode steps: logits within 1e-4 and the
    same greedy tokens.  Token models feed their greedy token back; embeds
    models take the next seeded embedding."""
    jcfg, jparams, _, tparams = _reference(arch)
    tcfg = reduced_config(arch)
    max_len = prompt + N_DECODE + 1
    jprefill, jdecode = _jitted(arch, max_len)
    data = _inputs(jcfg, prompt, seed=prompt)
    if jcfg.input_mode == "tokens":
        pre = {"tokens": data["tokens"][:, :prompt]}
    else:
        pre = {k: v[:, :prompt] if k == "embeds" else v for k, v in data.items()}
    jcache, jl = jprefill(jparams, {k: jnp.asarray(v) for k, v in pre.items()})
    tcache, tl = TM.prefill(tparams, {k: torch.from_numpy(v) for k, v in pre.items()}, tcfg, max_len)
    windowed = [c for c, k in zip(tcache["layers"], tcfg.layer_kinds()) if k == "attn"]
    if tcfg.window is not None:  # the ring holds the window's last positions
        ring = prompt >= tcfg.window
        want_pos = (np.roll(np.arange(prompt - tcfg.window, prompt), prompt % tcfg.window) if ring
                    else np.r_[np.arange(prompt), -np.ones(max_len - prompt)])
        for c in windowed:
            np.testing.assert_array_equal(c["pos"].numpy(), np.broadcast_to(want_pos, (BATCH, len(want_pos))))
    for t in range(N_DECODE):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        greedy = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), greedy)
        if jcfg.input_mode == "tokens":
            step = {"tokens": greedy[:, None]}
        else:
            step = {"embeds": data["embeds"][:, prompt + t:prompt + t + 1]}
        jcache, jl = jdecode(jparams, jcache, {k: jnp.asarray(v) for k, v in step.items()})
        tcache, tl = TM.decode_step(tparams, tcache, {k: torch.from_numpy(v) for k, v in step.items()}, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, axis=-1)))
    assert tcache["cur"] == int(jcache["cur"]) == prompt + N_DECODE


def test_every_arch_builds_prefills_and_decodes():
    """All ten architectures, from the port's own init: finite logits of the
    padded vocab after prefill and two decode steps."""
    for arch in sorted(ARCHS):
        cfg = reduced_config(arch)
        params = TM.init_params(torch.Generator().manual_seed(0), cfg)
        data = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 8, seed=5).items()}
        if cfg.input_mode == "tokens":
            pre = {"tokens": data["tokens"][:, :8]}
        else:
            pre = {k: v[:, :8] if k == "embeds" else v for k, v in data.items()}
        cache, logits = TM.prefill(params, pre, cfg, 12)
        for t in range(2):
            assert logits.shape == (BATCH, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
            step = ({"tokens": logits.argmax(-1)[:, None]} if cfg.input_mode == "tokens"
                    else {"embeds": data["embeds"][:, 8 + t:9 + t]})
            cache, logits = TM.decode_step(params, cache, step, cfg)
        assert bool(torch.isfinite(logits).all()), arch


def _mixer(arch: str, kind: str):
    """The first ``kind`` layer's mixer parameters: (reference jnp, port)."""
    jcfg, _, host, tparams = _reference(arch)
    layer = jcfg.layer_kinds().index(kind)
    tp = tparams["layers"][layer]["mixer"]
    return {k: jnp.asarray(v.numpy()) for k, v in tp.items()}, tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_ssd_scan_and_decode_match_reference(carried):
    """``ssd_scan`` over 4 chunks, from zeros or from a carried SSM state
    and conv state, then ``ssd_decode`` steps from the scan's cache."""
    cfg = reduced_config("mamba2-1.3b")
    jp, tp = _mixer("mamba2-1.3b", "ssd")
    d_inner, H, G, N, hd = tssd.dims(cfg)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((BATCH, 4 * cfg.ssm.chunk, cfg.d_model)).astype(np.float32)
    state = conv = None
    if carried:
        state = rng.standard_normal((BATCH, H, hd, N)).astype(np.float32)
        conv = rng.standard_normal((BATCH, cfg.ssm.conv_width - 1, d_inner + 2 * G * N)).astype(np.float32)
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got, tcache = tssd.ssd_scan(tp, T(x), cfg, T(state), T(conv))
    jstate = None if state is None else state.reshape(BATCH, G, H // G, hd, N)
    want, jcache = jssd.ssd_scan(jp, J(x), cfg, J(jstate), J(conv))
    _close(got, want)
    for name in ("state", "conv"):
        _close(tcache[name], jcache[name])
    for step in range(3):
        x1 = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        got, tcache = tssd.ssd_decode(tp, T(x1), tcache, cfg)
        want, jcache = jssd.ssd_decode(jp, J(x1), jcache, cfg)
        _close(got, want)
        _close(tcache["state"], jcache["state"])


@pytest.mark.parametrize("S", [1, 7, 16, 33])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_rglru_scan_and_decode_match_reference(carried, S):
    """``rglru_scan`` (the log-depth scan at even, odd and one-step
    lengths), from zeros or from a carried ``h0`` and conv state, then
    ``rglru_decode`` steps from the scan's cache."""
    cfg = reduced_config("recurrentgemma-9b")
    jp, tp = _mixer("recurrentgemma-9b", "rec")
    W = cfg.rglru.lru_width
    rng = np.random.default_rng(22 + S)
    x = rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    h0 = conv = None
    if carried:
        h0 = rng.standard_normal((BATCH, W)).astype(np.float32)
        conv = rng.standard_normal((BATCH, cfg.rglru.conv_width - 1, W)).astype(np.float32)
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got, tcache = trglru.rglru_scan(tp, T(x), cfg, T(h0), T(conv))
    want, jcache = jrglru.rglru_scan(jp, J(x), cfg, J(h0), J(conv))
    _close(got, want)
    for name in ("h", "conv"):
        _close(tcache[name], jcache[name])
    for step in range(3):
        x1 = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        got, tcache = trglru.rglru_decode(tp, T(x1), tcache, cfg)
        want, jcache = jrglru.rglru_decode(jp, J(x1), jcache, cfg)
        _close(got, want)
        _close(tcache["h"], jcache["h"])


def test_associative_scan_is_the_recurrence():
    """The scan's h against the step-by-step recurrence h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(23)
    for n in (1, 2, 3, 5, 8, 13, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float64))
        b = torch.from_numpy(rng.standard_normal((2, n, 3)))
        prod, h = trglru.associative_scan(a, b)
        want, acc = [], torch.zeros(2, 3, dtype=torch.float64)
        for t in range(n):
            acc = a[:, t] * acc + b[:, t]
            want.append(acc)
        torch.testing.assert_close(h, torch.stack(want, dim=1), atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(prod, torch.cumprod(a, dim=1), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("window,chunk", [(16, 8), (16, 4), (6, 8), (5, 3)])
def test_windowed_attention_matches_reference(window, chunk):
    """The banded prefill at query chunks below S (the reference with the
    same query and KV chunk), against the reference's banded scan."""
    rng = np.random.default_rng(24)
    S, G, R, hd = 24, 2, 2, 16
    q = rng.standard_normal((BATCH, S, G, R, hd)).astype(np.float32)
    k, v = (rng.standard_normal((BATCH, S, G, hd)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (BATCH, S)).copy()
    want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window=window,
                                          q_chunk=chunk, kv_chunk=chunk)
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window=window,
                                 q_chunk=chunk)
    _close(got, want)
    full = tattn.causal_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window=window,
                                  q_chunk=S)
    _close(full, want)


@pytest.mark.parametrize("prompt", [5, 16, 21])
def test_windowed_prefill_and_decode_match_reference(prompt):
    """Starcoder2's reduced attention (window 16, cache of 16 slots): the
    prefill cache (padded below the window, a ring from it on) and 20
    decode steps, so the ring wraps past its first slot more than once."""
    cfg, jcfg = reduced_config("starcoder2-7b"), ref_reduced_config("starcoder2-7b")
    jp, tp = _mixer("starcoder2-7b", "attn")
    rng = np.random.default_rng(25 + prompt)
    x = rng.standard_normal((BATCH, prompt, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(prompt, dtype=np.int32), (BATCH, prompt)).copy()
    got, tcache = tattn.attention_prefill(tp, torch.from_numpy(x), torch.from_numpy(pos), cfg, cfg.window)
    want, jcache = jattn.attention_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, jcfg.window)
    _close(got, want)
    for name in ("k", "v", "pos"):
        _close(tcache[name], jcache[name])
    for p in range(prompt, prompt + 20):
        x1 = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        got, tcache = tattn.attention_decode(tp, torch.from_numpy(x1), p, tcache, cfg)
        want, jcache = jattn.attention_decode(jp, jnp.asarray(x1), jnp.int32(p), jcache, jcfg)
        _close(got, want)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_mrope_and_sinusoidal_positions_match_reference():
    rng = np.random.default_rng(26)
    pos3 = rng.integers(0, 5000, size=(3, BATCH, 11)).astype(np.int32)
    for sections, dim in (((4, 2, 2), 16), ((16, 24, 24), 128)):
        got = tcommon.mrope_cos_sin(torch.from_numpy(pos3), dim, 1e6, sections)
        want = jcommon.mrope_cos_sin(jnp.asarray(pos3), dim, 1e6, sections)
        for g, w in zip(got, want):
            assert g.shape == (BATCH, 11, dim // 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    pos = rng.integers(0, 5000, size=(BATCH, 11)).astype(np.int32)
    for dim in (64, 1536):
        got = tcommon.sinusoidal_pos_emb(torch.from_numpy(pos), dim)
        want = jcommon.sinusoidal_pos_emb(jnp.asarray(pos), dim)
        assert got.shape == (BATCH, 11, dim) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_parameter_tree_matches_reference(arch):
    """``init_params`` builds the reference's tree (every leaf's name, shape
    and dtype, float32 leaves of ``rec`` and ``ssd`` included), and
    ``params_from_numpy`` carries each layer of each segment to its place:
    RecurrentGemma's (rec, rec, attn) steps and its trailing rec layers."""
    jcfg, _, host, carried = _reference(arch)
    cfg = reduced_config(arch)
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for name, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{name}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{prefix}/{i}").items()}
        return {prefix: tree}

    got = {k: (tuple(v.shape), v.dtype) for k, v in leaves(port).items()}
    assert got == {k: (tuple(v.shape), v.dtype) for k, v in leaves(carried).items()}
    f32 = {"lam", "b_a", "b_x"} if arch.startswith("recurrent") else {
        "A_log", "D_skip", "dt_bias", "norm_scale"}
    for name in f32:
        assert all(d == torch.float32 for k, (_, d) in got.items() if k.endswith(f"/mixer/{name}"))
    for i, seg in enumerate(B.build_segments(cfg)):
        for j in range(len(seg.unit)):
            for s in range(seg.count):
                layer = seg.base + s * len(seg.unit) + j
                assert cfg.layer_kinds()[layer] == seg.unit[j]
                for k, v in leaves(host[f"seg{i}"][f"sub{j}"]).items():
                    np.testing.assert_array_equal(leaves(carried["layers"][layer])[k].numpy(), v[s])


def test_full_depth_recurrentgemma_segments_map_to_layers():
    """RecurrentGemma-9B's 38 layers: 12 (rec, rec, attn) steps, then 2
    trailing rec layers."""
    cfg = ARCHS["recurrentgemma-9b"]
    segs = B.build_segments(cfg)
    assert [(s.unit, s.count, s.base) for s in segs] == [(("rec", "rec", "attn"), 12, 0), (("rec",), 2, 36)]
    layers = [seg.base + s * len(seg.unit) + j for seg in segs for s in range(seg.count)
              for j in range(len(seg.unit))]
    assert sorted(layers) == list(range(38))
    assert cfg.layer_kinds()[36:] == ["rec", "rec"]


def test_serve_launcher_runs_recurrentgemma_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "recurrentgemma-9b", "--requests", "6",
                "--new-tokens", "2", "--fail-replica", "1"])
    out = capsys.readouterr().out
    assert "6 requests on 3 replicas (cpu)" in out and "6 requests still served" in out
