"""The chain-mode failure resolution of the port (``resolve="chain"``):
the plain ``memento_remap`` against the JAX package's
(``repro.core.memento_jax.memento_remap``, a jitted while loop) and against
the scalar ``MementoWrapper(binomial32, chain_bits=32, resolve="chain")``,
bit for bit, at failure shares 0, 6, 25 and 50 % and capacities 64 and
1024, at ``max_chain`` 0, 1, 2 and 4096; the packed-mask plain version of
the kernel (``chain_remap_impl``) against it; and the two-pass chain path
(``ops.route_chain_bulk``) on CPU tensors against the scalar domain, for
both engines.  Two properties the card's kernel rests on: its remainder
(Lemire's fastmod, mirrored here in numpy) equals ``%``, and the remap of a
key does not depend on the other keys of its batch or their order (its
warps walk queued keys in whatever order their lanes free up).  Integer
outputs, so every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import binomial_jax as jb  # noqa: E402
from repro.core.memento import MementoWrapper as RefWrapper  # noqa: E402
from repro.core.memento_jax import memento_remap as ref_remap  # noqa: E402
from repro.core.registry import make as ref_make  # noqa: E402
from repro_torch.core import binomial_torch as bt  # noqa: E402
from repro_torch.core.bulk import ChainFleet, RouterSpec  # noqa: E402
from repro_torch.core.memento import MementoWrapper  # noqa: E402
from repro_torch.core.memento_torch import (  # noqa: E402
    chain_remap_impl,
    chain_state,
    memento_remap,
    pack_removed_mask,
)
from repro_torch.core.registry import make  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.router import SessionRouter  # noqa: E402

N_KEYS = 4096
SHARES = (0.0, 0.06, 0.25, 0.5)
CAPACITIES = (64, 1024)
MAX_CHAINS = (0, 1, 2, 4096)


def _keys(seed, size=N_KEYS):
    return np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)


def _wrappers(capacity, share, seed, max_chain, engine="binomial32"):
    """(port, reference) chain-mode wrappers over ``capacity - 3`` slots
    with ``share`` of them failed (never the last slot)."""
    n = capacity - 3
    port = MementoWrapper(lambda m: make(engine, m), n, max_chain=max_chain, chain_bits=32)
    ref = RefWrapper(lambda m: ref_make(engine, m), n, max_chain=max_chain, chain_bits=32)
    for b in np.random.default_rng(seed).choice(n - 1, size=int(share * n), replace=False):
        port.remove_bucket(int(b)), ref.remove_bucket(int(b))
    return port, ref


def _mask(removed, capacity):
    mask = np.zeros(capacity, dtype=bool)
    mask[sorted(removed)] = True
    return mask


@pytest.mark.parametrize("max_chain", MAX_CHAINS)
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_memento_remap_matches_reference_and_scalar(capacity, share, max_chain):
    port, ref = _wrappers(capacity, share, int(share * 100) + capacity, max_chain)
    assert port.removed == ref.removed and port.first_alive() == ref.first_alive()
    keys = _keys(capacity + max_chain)
    base = np.array([port.base.get_bucket(int(k)) for k in keys], dtype=np.int32)
    mask = _mask(port.removed, capacity)
    want = np.asarray(ref_remap(jnp.asarray(keys), jnp.asarray(base), jnp.asarray(mask),
                                jnp.uint32(port.n_total), jnp.uint32(port.first_alive()),
                                max_chain=max_chain))
    got = memento_remap(torch.from_numpy(keys.view(np.int32)), torch.from_numpy(base),
                        torch.from_numpy(mask), port.n_total, port.first_alive(), max_chain)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [ref.get_bucket(int(k)) for k in keys])
    np.testing.assert_array_equal(got.numpy(), [port.get_bucket(int(k)) for k in keys])
    # the kernel's plain version over the packed words and device scalars
    packed = torch.from_numpy(pack_removed_mask(port.removed, capacity).view(np.int32))
    state = torch.tensor([port.n_total, port.first_alive()], dtype=torch.int32)
    packed_out = chain_remap_impl(torch.from_numpy(keys.view(np.int32)), torch.from_numpy(base),
                                  packed, state, max_chain)
    np.testing.assert_array_equal(packed_out.numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(0,), (1,), (3, 5), (2, 3, 7)])
def test_memento_remap_keeps_shape(shape):
    port, _ = _wrappers(64, 0.5, 9, 4096)
    size = int(np.prod(shape))
    keys = _keys(11, size).reshape(shape)
    base = np.array([port.base.get_bucket(int(k)) for k in keys.reshape(-1)],
                    dtype=np.int32).reshape(shape)
    got = memento_remap(torch.from_numpy(keys.view(np.int32)), torch.from_numpy(base),
                        torch.from_numpy(_mask(port.removed, 64)), port.n_total,
                        port.first_alive())
    assert got.shape == shape
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  [port.get_bucket(int(k)) for k in keys.reshape(-1)])


def test_hash_iter_matches_reference():
    keys = _keys(12, 1000)
    for i in (0, 1, 2, 4096, 2**32 - 1):
        want = np.asarray(jb.hash_iter(jnp.asarray(keys), jnp.uint32(i)))
        got = bt.hash_iter(bt.u32(torch.from_numpy(keys.view(np.int32))), i)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_memento_remap_carries_the_waiver():
    from repro.analysis.markers import waivers_of as ref_waivers
    from repro_torch.analysis.markers import waivers_of

    assert waivers_of(memento_remap).keys() == ref_waivers(ref_remap).keys() == {"while-free"}


@pytest.mark.parametrize("max_chain", [0, 1, 4096])
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("engine", ["binomial", "jump"])
def test_route_chain_bulk_matches_scalar_domain(engine, share, max_chain):
    """The two-pass chain path on CPU tensors (the dynamic-n lookup's and
    the chain remap's plain versions) against ``FailureDomain.locate``
    through fail / recover / scale events."""
    spec = RouterSpec(engine, 1024)
    scalar = {"binomial": "binomial32", "jump": "jump32"}[engine]
    plane = SessionRouter(1000, engine=scalar, chain_bits=32, max_chain=max_chain)
    rng = np.random.default_rng(int(share * 100))
    for b in rng.choice(999, size=int(share * 1000), replace=False):
        plane.fail(int(b))
    keys = _keys(13, 2048)
    removed = sorted(plane.domain.removed)
    alive = [b for b in range(999) if b not in plane.domain.removed]
    events = [("scale_up",), ("fail", alive[len(alive) // 2]), ("scale_down",)]
    if removed:
        events.insert(0, ("recover", removed[0]))
    for event in [None, *events]:
        if event is not None:
            getattr(plane, event[0])(*event[1:])
        chain = ChainFleet.pack(plane.domain, spec.capacity).to("cpu")
        assert chain.state.tolist() == chain_state(plane.domain).view(np.int32).tolist()
        assert chain.max_chain == max_chain
        got = ops.route_chain_bulk(torch.from_numpy(keys.view(np.int32)), chain, spec)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), [plane.domain.locate(int(k)) for k in keys])


def test_chain_remap_wrapper_checks_operands():
    from repro_torch.kernels.fused import BINOMIAL

    keys = torch.zeros(4, dtype=torch.int32)
    packed = torch.zeros(2, dtype=torch.int32)
    state = torch.tensor([10, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="agree in shape"):
        BINOMIAL.chain_remap(keys, torch.zeros(5, dtype=torch.int32), packed, state)
    with pytest.raises(ValueError, match="max_chain"):
        BINOMIAL.chain_remap(keys, keys, packed, state, -1)
    before = BINOMIAL.launches["chain_remap"]
    assert BINOMIAL.chain_remap(keys, keys, packed, state).tolist() == [0, 0, 0, 0]
    assert BINOMIAL.launches["chain_remap"] == before  # the plain version: no launch


@pytest.mark.parametrize("kw", [dict(), dict(chain_bits=32, resolve="table")],
                         ids=["chain64", "table"])
def test_chain_fleet_refuses_other_resolutions(kw):
    """Only a ``resolve="chain", chain_bits=32`` domain walks the chain the
    remap walks; packing any other would route its diverted keys
    elsewhere than its ``locate``."""
    plane = SessionRouter(100, **kw)
    with pytest.raises(ValueError, match="chain_bits=32"):
        ChainFleet.pack(plane.domain, 128)


@pytest.mark.parametrize("share", SHARES)
def test_plain_walk_counts_its_steps(share):
    """``chain_remap_impl(return_steps=True)`` gives the same answer and,
    per key, the steps of its walk: 0 on an alive slot, else the steps the
    scalar chain (``MementoWrapper._chain_step``) takes to land alive."""
    port, _ = _wrappers(1024, share, 3, 4096)
    keys = _keys(14, 2048)
    base = np.array([port.base.get_bucket(int(k)) for k in keys], dtype=np.int32)
    packed = torch.from_numpy(pack_removed_mask(port.removed, 1024).view(np.int32))
    state = torch.tensor([port.n_total, port.first_alive()], dtype=torch.int32)
    kt, bt_ = torch.from_numpy(keys.view(np.int32)), torch.from_numpy(base)
    out, steps = chain_remap_impl(kt, bt_, packed, state, return_steps=True)
    assert torch.equal(out, chain_remap_impl(kt, bt_, packed, state))
    want = []
    for k, b in zip(keys.tolist(), base.tolist()):
        s = 0
        while b in port.removed:
            b = port._chain_step(k, b, s, port.n_total)
            s += 1
        want.append(s)
    assert steps.dtype == torch.int64 and steps.tolist() == want
    assert bool((steps > 0).any()) == (share > 0)


def _fastmod(x, d):
    """The chain kernel's ``x % d`` (``fastmod`` in routing.cu) in numpy
    uint64 arithmetic, which wraps as the card's does: M = UINT64_MAX // d
    + 1, then the high 64 bits of (M * x mod 2^64) * d from two 32 x 32 ->
    64-bit products."""
    x = np.asarray(x, dtype=np.uint64)
    d = np.array([d], dtype=np.uint64)
    magic = np.array([2**64 - 1], dtype=np.uint64) // d + np.uint64(1)
    low = magic * x
    lo = (low & np.uint64(0xFFFFFFFF)) * d
    hi = (low >> np.uint64(32)) * d
    return (hi + (lo >> np.uint64(32))) >> np.uint64(32)


@pytest.mark.parametrize("d", [1, 2, 3, 1000, 1024, 65536, 2**31, 2**32 - 1])
def test_fastmod_matches_remainder(d):
    """Exact for every u32 dividend and every divisor 1 <= d < 2^32; at
    d = 1 the magic wraps to 0 and gives 0."""
    edges = np.array([0, d - 1, d, 2**32 - 1], dtype=np.uint64)
    x = np.concatenate([edges, _keys(d % 1009, 1 << 16).astype(np.uint64)])
    np.testing.assert_array_equal(_fastmod(x, d), x % np.uint64(d))


@pytest.mark.parametrize("max_chain", [0, 1, 2, 4096])
@pytest.mark.parametrize("share", [0.06, 0.25, 0.5, 0.9])
def test_chain_remap_is_order_independent(share, max_chain):
    """``chain_remap_impl`` of a permuted batch is the permuted result, and
    of a batch split in two the joined result: each key's answer depends
    only on its own walk and ``max_chain``, which is what lets the kernel's
    lanes take queued keys in any order."""
    n = 1021
    port = MementoWrapper(lambda m: make("binomial32", m), n, max_chain=max_chain,
                          chain_bits=32)
    rng = np.random.default_rng(int(share * 100) + max_chain)
    for b in rng.choice(n - 1, size=int(share * n), replace=False):
        port.remove_bucket(int(b))
    packed = torch.from_numpy(pack_removed_mask(port.removed, 1024).view(np.int32))
    state = torch.tensor([port.n_total, port.first_alive()], dtype=torch.int32)
    keys = torch.from_numpy(_keys(15 + max_chain).view(np.int32))
    base = torch.from_numpy(rng.integers(0, n, size=N_KEYS).astype(np.int32))
    whole = chain_remap_impl(keys, base, packed, state, max_chain)
    assert bool((whole != base).any())
    perm = torch.from_numpy(rng.permutation(N_KEYS))
    assert torch.equal(chain_remap_impl(keys[perm], base[perm], packed, state, max_chain),
                       whole[perm])
    cut = 1337
    parts = [chain_remap_impl(keys[s], base[s], packed, state, max_chain)
             for s in (slice(None, cut), slice(cut, None))]
    assert torch.equal(torch.cat(parts), whole)
