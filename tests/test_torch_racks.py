"""R-way placement over failure domains (racks of DataNodes) on the CPU:
``StorePlacement(..., domains=FailureDomains)`` through ``place_keys``,
``place`` and ``plan_migration`` held exactly to the benchmark's plain
reference (``portbench/reference/racks.py``) on seeded keys, at a small
layout and at the published one (HDFS RS-6-3: 20 racks of 10, r = 9),
under random DataNode failures and a whole rack's; the guarantees
(distinct racks, a failure's moves kept in its rack, the degraded mode);
the node level's plain version against a route a rack for both engines;
and the router's two-level fleet (one upload a burst)."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.reference import racks as ref  # noqa: E402
from portbench.reference.hashing import u32  # noqa: E402
from repro_torch.core.bulk import FailureDomains, RackDomains  # noqa: E402
from repro_torch.core.placement_torch import (  # noqa: E402
    RESALT_SALT,
    family_salts,
    node_salts,
)
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.placement.store import StorePlacement  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.lifecycle.errors import (  # noqa: E402
    MODE_DEGRADED,
    MODE_NORMAL,
    PlacementDegradedError,
)

SMALL = (6, 4, 4)  # racks, DataNodes a rack, r
PUBLISHED = (20, 10, 9)


def _keys(seed: int, n: int) -> torch.Tensor:
    x = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32))


def _store(layout, engine="binomial", **kw):
    racks, per_rack, r = layout
    router = BatchRouter(racks * per_rack, engine=engine, omega=16, device="cpu")
    store = StorePlacement(router, r=r, domains=FailureDomains(racks, per_rack), **kw)
    return router, store, ref.Racks(ref.Layout(racks, per_rack))


def _burst(router, twin, events):
    with router.coalesced_events():
        for kind, node in events:
            getattr(router, kind)(node)
    for kind, node in events:
        twin.apply(kind, node)


def _random_failures(layout, seed: int, count: int) -> list:
    """``count`` distinct DataNodes."""
    n = layout[0] * layout[1]
    return [("fail", int(d)) for d in np.random.default_rng(seed).choice(n, count, replace=False)]


def _assert_matches(store, twin, keys, r):
    got, exhausted = store.place_keys(keys)
    want, want_ex = ref.place(u32(keys), twin.tensors("cpu"), 16, r)
    assert torch.equal(got.to(torch.int64), want)
    assert torch.equal(exhausted, want_ex)
    mine = [np.asarray(a).view(np.int32) for a in store.router.racks.host.leaves()]
    assert all(np.array_equal(a.reshape(b.shape), b) for a, b in zip(mine, twin.packed()))
    return got.to(torch.int64)


def _distinct_racks(nodes, per_rack) -> bool:
    racks = torch.div(nodes, per_rack, rounding_mode="floor")
    return bool(((racks[:, :, None] == racks[:, None, :]).sum(dim=(1, 2)) == nodes.shape[1]).all())


@pytest.mark.parametrize("layout, n_keys", [(SMALL, 1 << 11), (PUBLISHED, 1 << 12)],
                         ids=["6x4-r4", "20x10-r9"])
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_place_keys_matches_the_reference_under_failures(layout, n_keys, seed):
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(seed, n_keys)
    _assert_matches(store, twin, keys, r)
    fails = _random_failures(layout, seed, max(2, racks * per_rack // 10))
    _burst(router, twin, fails)
    got = _assert_matches(store, twin, keys, r)
    assert _distinct_racks(got, per_rack)
    # a whole rack down (its DataNodes not yet failed), then half of it back
    rack = 1 + seed % (racks - 2)
    down = [("fail", d) for d in range(rack * per_rack, (rack + 1) * per_rack)
            if d - rack * per_rack not in twin.node_levels[rack].removed]
    _burst(router, twin, down)
    assert router.racks.alive_racks == twin.rack_level.n_alive == racks - 1
    got = _assert_matches(store, twin, keys, r)
    assert not bool((torch.div(got, per_rack, rounding_mode="floor") == rack).any())
    assert _distinct_racks(got, per_rack)
    back = [("recover", node) for _, node in down[: len(down) // 2 + 1]]
    _burst(router, twin, back)
    assert router.racks.alive_racks == racks
    _assert_matches(store, twin, keys, r)
    # recover every failure, one event at a time (no coalescing)
    for _, node in fails:
        if (node % per_rack) in twin.node_levels[node // per_rack].removed:
            router.recover(node)
            twin.apply("recover", node)
    _assert_matches(store, twin, keys, r)


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
@pytest.mark.parametrize("r", [1, 3, 9])
def test_node_route_plain_is_the_route_of_each_rack(engine, r):
    """The node level's plain version is, column by column, the engine's
    plain fused route of the node key over the fleet of its rack."""
    kernels = BULK_ENGINES[engine].kernels
    plane = RackDomains(FailureDomains(5, 7))
    for node in (0, 3, 8, 9, 10, 11, 12, 13, 30):
        plane.fail(node)
    fleet = plane.host.to("cpu")
    keys = _keys(r, 3000)
    cols = torch.from_numpy(np.random.default_rng(r).integers(0, 5, (3000, r)).astype(np.int32))
    got, moved = kernels.node_route(keys, cols, fleet.packed, fleet.table, fleet.state, 7, 16)
    assert moved is None and got.shape == (3000, r) and got.dtype == torch.int32
    node_keys = ref.node_keys(u32(keys), r)
    for g in range(5):
        sel = cols == g
        want = kernels.route(node_keys[sel].to(torch.int32), fleet.packed[g], fleet.table[g],
                             fleet.state[g], 16)
        assert torch.equal(got[sel], g * 7 + want)
    old = torch.roll(got, 1, dims=0)
    _, moved = kernels.node_route(keys, cols, fleet.packed, fleet.table, fleet.state, 7, 16, old)
    assert torch.equal(moved, ~(got[:, :, None] == old[:, None, :]).any(dim=2))


def test_node_salts_are_their_own():
    fam = set(family_salts(256).tolist()) | {RESALT_SALT}
    nodes = node_salts(256).tolist()
    assert len(set(nodes)) == 256 and not fam & set(nodes)


@pytest.mark.parametrize("seed", range(6))
def test_a_failure_that_leaves_its_rack_alive_moves_only_inside_it(seed):
    """No rack column changes; in a rack with no failure before, exactly the
    failed DataNode's blocks move; in one that had a failure, the moves
    are that DataNode's blocks and blocks already diverted there; every
    moved block stays in its rack."""
    layout = PUBLISHED
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(100 + seed, 1 << 12)
    rng = np.random.default_rng(seed)
    earlier = int(rng.integers(0, racks - 1)) * per_rack + int(rng.integers(0, per_rack))
    _burst(router, twin, [("fail", earlier)])
    before, _ = store.place_keys(keys)
    before = before.to(torch.int64)
    for fresh in (False, True):
        rack = earlier // per_rack if not fresh else (earlier // per_rack + 1) % racks
        local = int(rng.choice([b for b in range(per_rack)
                                if b not in twin.node_levels[rack].removed]))
        node = rack * per_rack + local
        _burst(router, twin, [("fail", node)])
        after = _assert_matches(store, twin, keys, r)
        assert torch.equal(torch.div(after, per_rack, rounding_mode="floor"),
                           torch.div(before, per_rack, rounding_mode="floor"))
        moved = after != before
        held = before == node
        assert bool(held[moved].all()) if fresh else bool(
            (torch.div(before[moved], per_rack, rounding_mode="floor") == rack).all())
        assert bool(moved[held].all())
        assert not bool((after == node).any())
        before = after


@pytest.mark.parametrize("layout", [SMALL, PUBLISHED], ids=["6x4-r4", "20x10-r9"])
def test_plan_migration_is_the_reference_diff(layout):
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(5, 1 << 10)
    store.register(keys.numpy().view(np.uint32))
    old_twin = twin.copy()
    fails = _random_failures(layout, 9, 3) + [("fail", d) for d in range(per_rack, 2 * per_rack)]
    fails = list(dict.fromkeys(fails))
    _burst(router, twin, fails)
    plan = store.plan_migration()
    k = u32(keys)
    old, _ = ref.place(k, old_twin.tensors("cpu"), 16, r)
    new, _ = ref.place(k, twin.tensors("cpu"), 16, r)
    assert np.array_equal(plan.keys, keys.numpy().view(np.uint32))
    assert np.array_equal(plan.old, old.numpy()) and np.array_equal(plan.new, new.numpy())
    assert np.array_equal(plan.moved, ref.moved(new, old).numpy())
    assert plan.moved_pairs > 0


def test_fewer_alive_racks_than_r_is_the_degraded_mode():
    layout = SMALL
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(11, 512)
    down = [("fail", d) for d in range(0, 3 * per_rack)]  # racks 0-2: three of six alive
    _burst(router, twin, down)
    assert store.n_distinct == 3 < r
    batch = store.place(keys)
    assert batch.mode == MODE_DEGRADED and batch.n_distinct == 3
    got = torch.from_numpy(np.asarray(batch.replicas, np.int64))
    want, _ = ref.place(u32(keys), twin.tensors("cpu"), 16, r)
    assert torch.equal(got, want)
    racks_of = torch.div(got, per_rack, rounding_mode="floor")
    assert bool((racks_of >= 3).all())  # alive racks only
    head = racks_of[:, :3]  # the alive racks, each once; the rest repeat them
    assert _distinct_racks(head * per_rack, per_rack)
    strict = StorePlacement(router, r=r, strict=True, domains=store.spec.domains)
    with pytest.raises(PlacementDegradedError):
        strict.place(keys)
    _burst(router, twin, [("recover", 0)])
    assert store.place(keys).mode == MODE_NORMAL


def test_the_router_uploads_both_levels_once_a_burst():
    router, store, twin = _store(PUBLISHED)
    before = router.uploads
    with router.coalesced_events():
        for node in (3, 4, 50, 51, 52):
            router.fail(node)
    assert router.uploads == before + 1
    router.recover(3)
    assert router.uploads == before + 2
    dev = router.racks_dev
    assert dev.packed.shape == (20, 1) and dev.table.shape == (20, 16) and dev.state.shape == (20, 2)
    assert dev.racks.table.shape == (32,) and dev.nodes == 10
    assert [int(x) for x in dev.state[5]] == [10, 7]


def test_the_layout_is_fixed_and_checked():
    router, store, _ = _store(SMALL)
    with pytest.raises(ValueError, match="fixed layout"):
        router.scale_up()
    with pytest.raises(ValueError, match="fixed layout"):
        router.scale_down()
    for route in (lambda: router.route_keys(_keys(0, 8)), lambda: router.route(7),
                  lambda: router.route_ids(np.arange(8, dtype=np.uint64))):
        with pytest.raises(ValueError, match="no flat fleet"):
            route()
    router.attach_domains(FailureDomains(6, 4))  # the same layout: nothing changes
    with pytest.raises(ValueError, match="tracks"):
        router.attach_domains(FailureDomains(4, 6))
    other = BatchRouter(24, omega=16, device="cpu")
    with pytest.raises(ValueError, match="DataNodes"):
        other.attach_domains(FailureDomains(5, 4))
    for bad in ((0, 4), (6, 0)):
        with pytest.raises(ValueError):
            FailureDomains(*bad)
    assert (FailureDomains(20, 10).rack_capacity, FailureDomains(20, 10).node_capacity) == (32, 16)
    assert (FailureDomains(8, 1).rack_capacity, FailureDomains(8, 1).node_capacity) == (8, 1)


def test_domains_attached_after_failures_replay_them():
    router = BatchRouter(24, omega=16, device="cpu")
    for node in (9, 2, 5, 6, 7, 4):
        router.fail(node)
    store = StorePlacement(router, r=4, domains=FailureDomains(6, 4))
    twin = ref.Racks(ref.Layout(6, 4))
    for node in (2, 4, 5, 6, 7, 9):
        twin.apply("fail", node)
    assert router.racks.alive_racks == 5
    _assert_matches(store, twin, _keys(3, 256), 4)


@pytest.mark.parametrize("layout", [SMALL, PUBLISHED], ids=["6x4-r4", "20x10-r9"])
def test_the_last_datanode_and_the_last_rack_fail_and_recover(layout):
    """No DataNode is special: the last one fails and recovers, then every
    DataNode of the last rack, one burst each way, each state held to the
    reference; the router keeps no flat fleet to hold them back."""
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(17, 1 << 10)
    last = racks * per_rack - 1
    _burst(router, twin, [("fail", last)])
    assert router.alive == last and store.n_alive == last
    got = _assert_matches(store, twin, keys, r)
    assert not bool((got == last).any())
    _burst(router, twin, [("recover", last)])
    assert bool((_assert_matches(store, twin, keys, r) == last).any())
    rack = [("fail", d) for d in range((racks - 1) * per_rack, racks * per_rack)]
    _burst(router, twin, rack)
    assert router.racks.alive_racks == racks - 1 and store.n_distinct == racks - 1
    got = _assert_matches(store, twin, keys, r)
    assert not bool((torch.div(got, per_rack, rounding_mode="floor") == racks - 1).any())
    assert _distinct_racks(got, per_rack)
    _burst(router, twin, [("recover", node) for _, node in rack])
    assert router.racks.alive_racks == racks and router.alive == racks * per_rack
    _assert_matches(store, twin, keys, r)


@pytest.mark.parametrize("seed", range(3))
def test_a_block_leaves_its_base_only_while_the_base_is_down(seed):
    """Under random bursts (failures, then their recovery), every column
    sits on its base DataNode while that is alive; between two epochs under
    one rack level a block moves only where its base is down at either."""
    layout = PUBLISHED
    racks, per_rack, r = layout
    router, store, twin = _store(layout)
    keys = _keys(300 + seed, 1 << 11)
    rng = np.random.default_rng(seed)
    _burst(router, twin, _random_failures(layout, seed, 20))
    before = _assert_matches(store, twin, keys, r)
    for _ in range(4):
        alive = [d for d in range(racks * per_rack) if d not in router.domain.removed]
        down = [("fail", int(d)) for d in rng.choice(alive, 2, replace=False)]
        for events in (down, [("recover", node) for _, node in down]):
            dead_before = set(router.domain.removed)
            level = (list(twin.rack_level.slots), twin.rack_level.n_alive)
            _burst(router, twin, events)
            after = _assert_matches(store, twin, keys, r)
            rack_of = torch.div(after, per_rack, rounding_mode="floor")
            base = ref.nodes(u32(keys), rack_of, twin.tensors("cpu"), 16)[1]
            dead_now = torch.tensor([b in router.domain.removed for b in range(racks * per_rack)])
            assert torch.equal(after[~dead_now[base]], base[~dead_now[base]])
            if level == (list(twin.rack_level.slots), twin.rack_level.n_alive):
                dead_then = torch.tensor([b in dead_before for b in range(racks * per_rack)])
                assert torch.equal(rack_of, torch.div(before, per_rack, rounding_mode="floor"))
                moved = after != before
                assert bool((dead_then[base] | dead_now[base])[moved].all())
            before = after
