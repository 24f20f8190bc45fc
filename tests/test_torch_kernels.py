"""The plain versions of the port's three routing kernels (route, ingest,
lookup_dyn; binomial and jump) against two JAX references on the same
numpy inputs and the same fleet state: the Pallas kernels in interpret mode
and the jnp mirrors.  Tolerance 0 — every output is an integer.

Fleet arrays are built once, by the reference's ``FleetState.pack``, and
carried into the port through ``repro_torch.interop.fleet_from_numpy``.
On the CPU the port's wrappers run their plain versions, so the wrapper
calls below are what the CUDA kernels are held against on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.binomial_jax import binomial_lookup_dyn  # noqa: E402
from repro.core.bulk import FleetState as RefFleetState  # noqa: E402
from repro.core.jump_jax import (  # noqa: E402
    jump_ingest_route,
    jump_lookup_dyn,
    jump_memento_route,
)
from repro.core.memento_jax import (  # noqa: E402
    binomial_ingest_route,
    binomial_memento_route,
    mask_words,
)
from repro.kernels import binomial_hash, jump_hash  # noqa: E402
from repro.serving.router import SessionRouter  # noqa: E402
from repro_torch.core import binomial_torch as bt  # noqa: E402
from repro_torch.core.registry import make_bulk  # noqa: E402
from repro_torch.interop import fleet_from_numpy  # noqa: E402

ENGINES = ("binomial", "jump")
SCALAR = {"binomial": "binomial32", "jump": "jump32"}
PALLAS = {
    "binomial": (
        binomial_hash.binomial_route_pallas_fused,
        binomial_hash.binomial_ingest_pallas_fused,
        binomial_hash.binomial_bulk_lookup_pallas_dyn,
    ),
    "jump": (
        jump_hash.jump_route_pallas_fused,
        jump_hash.jump_ingest_pallas_fused,
        jump_hash.jump_bulk_lookup_pallas_dyn,
    ),
}
MIRROR = {
    "binomial": (binomial_memento_route, binomial_ingest_route, binomial_lookup_dyn),
    "jump": (jump_memento_route, jump_ingest_route, jump_lookup_dyn),
}


def _oracle(engine, n, capacity, fail_frac, seed, omega=16):
    """Reference control plane with a seeded random removed set (the last
    slot is never failed, which would shrink the slot space)."""
    o = SessionRouter(
        n, engine=SCALAR[engine], chain_bits=32, omega=omega, resolve="table",
        allow_empty=True,
    )
    rng = np.random.default_rng(seed)
    k = int(fail_frac * n)
    if n > 1 and k:
        for b in rng.choice(n - 1, size=min(k, n - 1), replace=False):
            o.fail(int(b))
    return o


def _fleets(o, capacity):
    """(reference numpy leaves, port CPU FleetState) of one control plane."""
    ref = RefFleetState.pack(o.domain, capacity)
    port = fleet_from_numpy(ref.packed, ref.table, ref.state, capacity).to("cpu")
    return ref, port


def _keys(seed, size):
    return np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _deep_lanes(keys, port, engine, omega):
    """Lanes the divert sends through the second (deep) redirect."""
    k = bt.u32(_t(keys))
    b = bt.u32(make_bulk(engine).kernels.lookup_dyn(_t(keys), port.state[:1], omega))
    word = bt.u32(port.packed)[b >> 5]
    hit = ((word >> (b & 31)) & 1) != 0
    q = bt.mulhi32(bt.hash_pair(k, b), bt.u32(port.state[0]))
    return int((hit & (q >= bt.u32(port.state[1]))).sum())


def _run(engine, kind, keys, hi, ref, port, omega, capacity, *, pallas):
    """(port result, reference result) for one kernel kind."""
    kernels = make_bulk(engine).kernels
    route_ref, ingest_ref, dyn_ref = PALLAS[engine] if pallas else MIRROR[engine]
    packed, table, state = (jnp.asarray(a) for a in (ref.packed, ref.table, ref.state))
    n_words = mask_words(capacity)
    extra = dict(n_slots=capacity, block_rows=2, interpret=True) if pallas else {}
    if kind == "route":
        got = kernels.route(_t(keys), port.packed, port.table, port.state, omega)
        want = route_ref(
            jnp.asarray(keys), packed, table, state, omega=omega, n_words=n_words, **extra
        )
    elif kind == "ingest":
        got = kernels.ingest(_t(keys), _t(hi), port.packed, port.table, port.state, omega)
        want = ingest_ref(
            jnp.asarray(keys), jnp.asarray(hi), packed, table, state, omega=omega,
            n_words=n_words, **extra,
        )
    else:
        n = int(ref.state[0])
        got = kernels.lookup_dyn(_t(keys), port.state[:1], omega)
        kw = dict(block_rows=2, interpret=True) if pallas else {}
        want = dyn_ref(jnp.asarray(keys), np.uint32(n), omega=omega, **kw)
    return got.numpy(), np.asarray(want)


# --- against the Pallas kernels in interpret mode ---------------------------


@pytest.mark.parametrize("omega", [1, 2, 16, 32])
@pytest.mark.parametrize("kind", ["route", "ingest", "lookup_dyn"])
@pytest.mark.parametrize("engine", ENGINES)
def test_plain_matches_pallas_omega_sweep(engine, kind, omega):
    o = _oracle(engine, 40, 64, 0.3, seed=omega, omega=omega)
    ref, port = _fleets(o, 64)
    keys, hi = _keys(1, 256), _keys(2, 256)
    got, want = _run(engine, kind, keys, hi, ref, port, omega, 64, pallas=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("engine", ENGINES)
def test_route_pow2_boundaries_vs_pallas(engine, n):
    """n at 2^k-1, 2^k, 2^k+1 (and n <= 1), with a removed slot where the
    fleet has room for one."""
    o = _oracle(engine, n, 64, 0.0, seed=n)
    if n > 2:
        o.fail(n // 2)
    ref, port = _fleets(o, 64)
    keys = _keys(n, 256)
    got, want = _run(engine, "route", keys, None, ref, port, 16, 64, pallas=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["route", "ingest"])
@pytest.mark.parametrize("engine", ENGINES)
def test_multiword_mask_deep_redirect_vs_pallas(engine, kind):
    """Capacity 128 (four mask words), half the slots failed: keys reach
    every mask word and the second redirect."""
    o = _oracle(engine, 120, 128, 0.5, seed=11)
    ref, port = _fleets(o, 128)
    keys, hi = _keys(3, 512), _keys(4, 512)
    assert _deep_lanes(keys, port, engine, 16) > 0
    got, want = _run(engine, kind, keys, hi, ref, port, 16, 128, pallas=True)
    np.testing.assert_array_equal(got, want)


# --- against the jnp mirrors ------------------------------------------------


@pytest.mark.parametrize("omega", [1, 2, 16, 32])
@pytest.mark.parametrize("kind", ["route", "ingest", "lookup_dyn"])
@pytest.mark.parametrize("engine", ENGINES)
def test_plain_matches_mirror_capacity_4096(engine, kind, omega):
    """128 mask words, a quarter of 3000 slots failed."""
    o = _oracle(engine, 3000, 4096, 0.25, seed=omega + 100, omega=omega)
    ref, port = _fleets(o, 4096)
    keys, hi = _keys(5, 2048), _keys(6, 2048)
    if kind != "lookup_dyn":
        assert _deep_lanes(keys, port, engine, omega) > 0
    got, want = _run(engine, kind, keys, hi, ref, port, omega, 4096, pallas=False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 1023, 1024, 1025, 4095, 4096])
@pytest.mark.parametrize("engine", ENGINES)
def test_lookup_dyn_edges_vs_mirror(engine, n):
    keys = _keys(n + 7, 1024)
    got = make_bulk(engine).kernels.lookup_dyn(_t(keys), torch.tensor([n], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(MIRROR[engine][2](jnp.asarray(keys), n)))


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_matches_scalar_oracle(engine):
    """Route plain version == the reference control plane's locate."""
    o = _oracle(engine, 300, 512, 0.4, seed=21)
    ref, port = _fleets(o, 512)
    keys = _keys(8, 1000)
    got = make_bulk(engine).kernels.route(_t(keys), port.packed, port.table, port.state)
    np.testing.assert_array_equal(got.numpy(), [o.domain.locate(int(k)) for k in keys])


def test_fleet_from_numpy_drops_padding_and_checks():
    o = _oracle("binomial", 50, 64, 0.2, seed=3)
    ref = RefFleetState.pack(o.domain, 64)
    port = fleet_from_numpy(ref.packed, ref.table, ref.state, 64)
    assert port.packed.shape == (2,) and port.table.shape == (64,)
    np.testing.assert_array_equal(port.packed, ref.packed[0, :2])
    np.testing.assert_array_equal(port.table, ref.table[0, :64])
    with pytest.raises(ValueError, match="too small"):
        fleet_from_numpy(ref.packed, ref.table[:, :10], ref.state, 64)
