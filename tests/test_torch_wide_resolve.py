"""The plain versions behind the card's row-path resolve and global-count
``route_load`` against the JAX package, on the CPU.

resolve's row path (``resolve_rows_kernel``, r past the register columns)
stages a warp's rows at a stride of ``r | 1`` words; its plain version,
``resolve_columns``, is what the card's kernel is held to bit for bit.  Here
that plain version, through the port's ``route_replicas_bulk`` and
``placement_diff_bulk``, is held to the reference's passes at r = 17, 33
and 64 (odd rows, odd rows, and an even row padded to 65 words on the
card), on fleets of 64 and 1,024 slots whose alive count lies above r and,
at 64 slots, below it.  The reference's passes run eagerly
(``jax.disable_jit``) with a probe bound of 2: its jit grows with r and
the mask's words, minutes past r = 32 at 1,024 slots.

``route_load``'s global-count instance takes every capacity past 4,096
bins; its plain version is held to the reference's ``route_load_bulk`` at
16,384 slots, every key counted and every eighth, from an accumulator near
2^32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.placement import store as ref_store  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
from repro_torch.core.bulk import PlacementSpec  # noqa: E402
from repro_torch.core.placement_torch import resolve_columns  # noqa: E402
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.placement import store  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402

ENGINES = ("binomial", "jump")
#: r past the card kernel's eight register columns: rows of 17 and 33 words
#: (odd strides) and of 64 (staged at 65)
RS = (17, 33, 64)
#: (capacity, n, failed): n_alive above every r at 1,024 slots; at 64
#: slots above 17 and 33 and below 64
FLEETS = {64: (60, 8), 1024: (1000, 250)}
MAX_RESALT = 2
N_KEYS = 256


def _routers(engine, capacity):
    """(reference router, port router, the reference's and the port's fleet
    before the failures) over the same fleet events."""
    n, n_fail = FLEETS[capacity]
    rr = RefRouter(n, engine=engine, capacity=capacity)
    pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
    h = rr._fleet_host
    old_ref = type(h)(jnp.asarray(h.packed), jnp.asarray(h.table), jnp.asarray(h.state))
    old_port = store.StorePlacement(pr, r=1)._fleet_snapshot().to("cpu")
    victims = np.random.default_rng(n).choice(n - 1, size=n_fail, replace=False)
    with rr.coalesced_events(), pr.coalesced_events():
        for v in victims:
            rr.fail(int(v)), pr.fail(int(v))
    rr._check_routable(), pr._check_routable()
    return rr, pr, old_ref, old_port


def _keys(seed):
    keys = np.random.default_rng(seed).integers(0, 1 << 32, N_KEYS, dtype=np.uint32)
    return keys, torch.from_numpy(keys.view(np.int32))


def _reference_place(keys, fleet, spec, r):
    eng = ref_ops._engine(spec)
    with jax.disable_jit():
        return ref_store.route_replicas_impl(
            keys, fleet.packed, fleet.table, fleet.state, r=r, omega=spec.omega,
            n_words=spec.n_words, max_resalt=MAX_RESALT, route=eng.route)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("capacity", sorted(FLEETS))
@pytest.mark.parametrize("engine", ENGINES)
def test_wide_placement_matches_reference(engine, capacity, r):
    """The port's placement pass (the family route, then ``resolve_columns``)
    against the reference's ``route_replicas_impl``: replicas and exhausted
    flags equal; columns past n_alive are the defined duplicates."""
    keys, tkeys = _keys(r + capacity)
    rr, pr, _, _ = _routers(engine, capacity)
    want, want_ex = _reference_place(keys, rr._fleet_dev, rr.spec, r)
    got, got_ex = ops.route_replicas_bulk(
        tkeys, pr._fleet_dev, PlacementSpec(router=pr.spec, r=r, max_resalt=MAX_RESALT))
    assert got.dtype == torch.int32 and got.shape == (N_KEYS, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ex.numpy(), np.asarray(want_ex))
    distinct = np.array([len(set(row)) for row in got.numpy().tolist()])
    settled = ~got_ex.numpy()
    assert (distinct[settled] == min(r, pr.alive)).all()


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("capacity", sorted(FLEETS))
@pytest.mark.parametrize("engine", ENGINES)
def test_wide_migration_diff_matches_reference(engine, capacity, r):
    """The port's migration diff (both placements and the moved mask, which
    the card's row path computes against the staged old rows) against the
    reference's ``placement_diff_impl``, across the fleet's failures."""
    keys, tkeys = _keys(3 * r + capacity)
    rr, pr, old_ref, old_port = _routers(engine, capacity)
    spec = rr.spec
    eng = ref_ops._engine(spec)
    new = rr._fleet_dev
    with jax.disable_jit():
        want = ref_store.placement_diff_impl(
            keys, old_ref.packed, old_ref.table, old_ref.state, new.packed, new.table,
            new.state, r=r, omega=spec.omega, n_words=spec.n_words, max_resalt=MAX_RESALT,
            route=eng.route)
    got = ops.placement_diff_bulk(tkeys, old_port, pr._fleet_dev,
                                  PlacementSpec(router=pr.spec, r=r, max_resalt=MAX_RESALT))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[2].sum()) < got[2].numel()


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("engine", ENGINES)
def test_resolve_columns_matches_reference_resolution(engine, r):
    """``resolve_columns`` over the reference's own routed family columns
    (its placement at ``max_resalt`` 0 keeps every routed column): the
    reference's answer at the probe bound, with the moved mask against the
    healthy fleet's placement equal to the reference diff's."""
    keys, tkeys = _keys(5 * r)
    rr, pr, old_ref, old_port = _routers(engine, 64)
    spec = rr.spec
    eng = ref_ops._engine(spec)
    with jax.disable_jit():
        routed = ref_store.route_replicas_impl(
            keys, rr._fleet_dev.packed, rr._fleet_dev.table, rr._fleet_dev.state, r=r,
            omega=spec.omega, n_words=spec.n_words, max_resalt=0, route=eng.route)[0]
    want, want_ex = _reference_place(keys, rr._fleet_dev, spec, r)
    f = pr._fleet_dev
    old = ops.route_replicas_bulk(tkeys, old_port, PlacementSpec(router=pr.spec, r=r,
                                                                 max_resalt=MAX_RESALT))[0]
    base = torch.from_numpy(np.asarray(routed))
    got, got_ex, moved = resolve_columns(tkeys, base, f.table, f.state, MAX_RESALT, old)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_ex.numpy(), np.asarray(want_ex))
    np.testing.assert_array_equal(
        moved.numpy(), ~(got.numpy()[:, :, None] == old.numpy()[:, None, :]).any(-1))


#: the global-count instance's capacity held here, and its sample shifts
WIDE_CAPACITY = 16384


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("engine", ENGINES)
def test_route_load_plain_matches_reference_past_the_shared_histogram(engine, shift):
    """``route_load_plain`` (what the card's global-count instance is held
    to) against the reference's ``route_load_bulk`` at 16,384 slots, 12,000
    in service with a quarter failed: replica ids and u32 counts equal,
    counts wrapping from near 2^32."""
    n = 12000
    rr = RefRouter(n, engine=engine, capacity=WIDE_CAPACITY)
    pr = BatchRouter(n, engine=engine, capacity=WIDE_CAPACITY, device="cpu")
    victims = np.random.default_rng(shift).choice(n - 1, size=n // 4, replace=False)
    with rr.coalesced_events(), pr.coalesced_events():
        for v in victims:
            rr.fail(int(v)), pr.fail(int(v))
    rr._check_routable(), pr._check_routable()
    rng = np.random.default_rng(WIDE_CAPACITY + shift)
    keys = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    start = (np.uint64(1 << 32) - rng.integers(1, 1 << 10, WIDE_CAPACITY).astype(np.uint64)
             ).astype(np.uint32)
    want, want_counts = ref_ops.route_load_bulk(keys, rr._fleet_dev, jnp.asarray(start), rr.spec,
                                                sample_shift=shift)
    f = pr._fleet_dev
    kernels = BULK_ENGINES[engine].kernels
    counts = torch.from_numpy(start.view(np.int32).copy())
    got, got_counts = kernels.route_load_plain(torch.from_numpy(keys.view(np.int32)), f.packed,
                                               f.table, f.state, counts, pr.spec.omega, shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_counts.numpy().view(np.uint32), np.asarray(want_counts))
    assert (got_counts.numpy().view(np.uint32) < start).any()  # some bin wrapped
