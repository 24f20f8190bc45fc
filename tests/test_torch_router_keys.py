"""The MoE hash router's fused call (``RoutingKernels.lookup_router``: the
router keys built inside the static-n lookup's launch) against the JAX
package's router (``repro.models.layers.moe.route``: its salted-key
construction, then the engine's jnp ``lookup_vec``) on the same numpy token
ids, and the first-trip identity the binomial kernel's shortcut rests on.
Tolerance 0: every output is an integer.  On the CPU the wrapper runs its
plain version (``router_keys`` then ``lookup_vec_plain``) — what the CUDA
kernel is held against on the card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.core import binomial_torch as bt  # noqa: E402
from repro_torch.core.registry import make_bulk  # noqa: E402

ENGINES = ("binomial", "jump")
SALTS = (0, 1, 93)
TOP_KS = (1, 2, 8)
NS = (2, 3, 128, 1000, 1025)
#: n for the identity: pow2 edges, the paper's cluster sizes, and the ends
#: of the static-n range (E = 2^31)
IDENTITY_NS = (2, 3, 4, 5, 10, 11, 100, 128, 1000, 1023, 1024, 1025, 10000, 65536, 100000,
               2**31 - 1, 2**31)


def _tokens(seed: int, shape=(3, 7)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 151936, size=shape, dtype=np.int64)


def _ref_expert_ids(engine, tokens, salt, top_k, n, omega=16) -> np.ndarray:
    cfg = ref_reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine, router_hash_omega=omega,
        router_dynamic_n=False, num_experts=n, top_k=top_k))
    x = jnp.zeros((*tokens.shape, cfg.d_model), jnp.float32)
    expert_ids, _, _ = jmoe.route(None, x, jnp.asarray(tokens.astype(np.int32)), salt, cfg)
    return np.asarray(expert_ids)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("top_k", TOP_KS)
@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("engine", ENGINES)
def test_lookup_router_matches_reference_router(engine, salt, top_k, n):
    tokens = _tokens(1000 * salt + 10 * top_k + n)
    want = _ref_expert_ids(engine, tokens, salt, top_k, n)
    kernels = make_bulk(engine).kernels
    got = kernels.lookup_router(torch.from_numpy(tokens), salt, top_k, n)
    assert got.dtype == torch.int32 and got.shape == (*tokens.shape, top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 token ids give the same keys (their low 32 bits)
    got32 = kernels.lookup_router(torch.from_numpy(tokens.astype(np.int32)), salt, top_k, n)
    np.testing.assert_array_equal(got32.numpy(), want)


@pytest.mark.parametrize("engine", ENGINES)
def test_lookup_router_plain_is_router_keys_then_lookup_vec(engine):
    kernels = make_bulk(engine).kernels
    tokens = torch.from_numpy(_tokens(5, (4, 9)))
    keys = bt.router_keys(tokens, 17, 8)
    assert keys.shape == (4, 9, 8) and int(keys.min()) >= 0 and int(keys.max()) <= bt.MASK32
    np.testing.assert_array_equal(
        kernels.lookup_router(tokens, 17, 8, 128, 16).numpy(),
        kernels.lookup_vec_plain(keys, 128, 16).numpy(),
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_lookup_router_n_le_1_and_device_checks(engine):
    kernels = make_bulk(engine).kernels
    before = dict(kernels.launches)
    out = kernels.lookup_router(torch.ones(2, 3, dtype=torch.int64), 4, 8, 1)
    assert out.shape == (2, 3, 8) and out.dtype == torch.int32 and not out.any()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lookup_router(torch.ones(2, 3, dtype=torch.int64, device="meta"), 4, 8, 128)
    assert kernels.launches == before


@pytest.mark.parametrize("n", IDENTITY_NS)
def test_first_trip_fold_equals_candidate(n):
    """On the loop's first trip (hash h0 = mix32(key)), wherever the
    candidate c = relocate(h0 & (E-1), h0) is below M, block A's fold
    relocate(h0 & (M-1), h0) is c itself; so the lookup is c whenever
    c < n, which is what the binomial kernels settle on the first trip."""
    keys = bt.u32(torch.from_numpy(
        np.random.default_rng(n % 9973).integers(0, 2**32, size=1 << 16, dtype=np.uint32).view(np.int32)))
    E, M = bt.fold_pow2(n)
    h0 = bt.mix32(keys)
    c = bt.relocate_within_level(h0 & (E - 1), h0)
    fold = bt.relocate_within_level(h0 & (M - 1), h0)
    below = c < M
    assert bool(below.any())
    assert torch.equal(c[below], fold[below])
    settled = c < n
    lookup = bt.binomial_lookup_vec(keys, n, 16).to(torch.int64) & bt.MASK32
    assert torch.equal(lookup[settled], c[settled])
