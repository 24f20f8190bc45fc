"""The port's R-way placement tier (``repro_torch.placement.store``,
``PlacementRepairer``) and placement planners (``assignment``, ``elastic``)
against the JAX package's, on the CPU, tolerance 0: the plain placement
passes against ``repro.kernels.ops.route_replicas_bulk`` and
``placement_diff_bulk`` (both engines, capacities 32, 64 and 1024, so
``n_words`` 1, 2 and 32; ``n_alive`` below, at and above ``r``; the default
and a too-small ``max_resalt``), and the host plane over the same event
streams: placements, modes, typed errors, reads, migration plans,
``sync_targets`` triples and realigned holders, repair task sequences,
``lost``/``completed`` and replay parity."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import bits as ref_bits  # noqa: E402
from repro.core.bulk import PlacementSpec as RefPlacementSpec  # noqa: E402
from repro.core.bulk import RouterSpec as RefRouterSpec  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.placement import assignment as ref_assignment  # noqa: E402
from repro.placement import elastic as ref_elastic  # noqa: E402
from repro.placement import store as ref_store  # noqa: E402
from repro.serving import lifecycle as R  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
from repro_torch.core.bulk import PlacementSpec, RouterSpec  # noqa: E402
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.interop import store_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.placement import assignment, elastic, store  # noqa: E402
from repro_torch.serving import lifecycle as P  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402

ENGINES = ("binomial", "jump")
KEYS = np.random.default_rng(3).integers(0, 1 << 32, size=512, dtype=np.uint32)


@dataclasses.dataclass
class Side:
    router: object
    mgr: object
    store: object


class Pair:
    """A reference and a port placement tier over the same fleet, each with
    its ``LifecycleManager``; ``both(path, *args)`` calls the same method
    on both and requires the same answer (or the same typed error)."""

    def __init__(self, n, engine="binomial", r=3, capacity=64, **kw):
        rr = RefRouter(n, engine=engine, capacity=capacity)
        pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
        self.ref = Side(rr, R.LifecycleManager(rr, R.LifecycleConfig(min_alive_floor=1)),
                        ref_store.StorePlacement(rr, r=r, **kw))
        self.port = Side(pr, P.LifecycleManager(pr, P.LifecycleConfig(min_alive_floor=1)),
                         store.StorePlacement(pr, r=r, **kw))

    def both(self, path, *args):
        obj, name = path.split(".")
        out = []
        for side in (self.ref, self.port):
            try:
                out.append(getattr(getattr(side, obj), name)(*args))
            except Exception as e:  # noqa: BLE001 - compared below
                out.append(e)
        want, got = out
        if isinstance(want, Exception):
            assert type(got).__name__ == type(want).__name__, got
            assert (str(got), vars(got)) == (str(want), vars(want))
            return got
        assert norm(got) == norm(want)
        return got

    def fail(self, *slots):
        for s in slots:
            self.both("mgr.fail", s)

    def same_holders(self):
        np.testing.assert_array_equal(self.port.store.holders, self.ref.store.holders)
        np.testing.assert_array_equal(self.port.store.keys, self.ref.store.keys)
        assert self.port.store.holders.dtype == np.int64


def norm(x):
    """Answers of either package as plain values."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().tolist()
    if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        return np.asarray(x).tolist()
    if dataclasses.is_dataclass(x):
        return norm(dataclasses.asdict(x))
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def distinct(rows) -> np.ndarray:
    return np.array([len(set(row)) for row in np.asarray(rows).tolist()])


# -- the placement passes against the reference's ops --------------------------


def fleets(engine, capacity):
    """(label, reference router, port router) with n_alive below, at and
    above r = 3 (the port's router built from the same events)."""
    out = []
    for label, n, fail in (("below", 3, [1]), ("at", 3, []), ("above", min(capacity, 1000), None)):
        rr = RefRouter(n, engine=engine, capacity=capacity)
        pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
        if fail is None:
            fail = np.random.default_rng(capacity).choice(n - 1, size=n // 4, replace=False).tolist()
        with rr.coalesced_events(), pr.coalesced_events():
            for s in fail:
                rr.fail(int(s)), pr.fail(int(s))
        rr._check_routable(), pr._check_routable()
        out.append((label, rr, pr))
    return out


@pytest.mark.parametrize("max_resalt", [None, 1])
@pytest.mark.parametrize("capacity", [32, 64, 1024])
@pytest.mark.parametrize("engine", ENGINES)
def test_route_replicas_matches_reference_ops(engine, capacity, max_resalt):
    keys = np.random.default_rng(capacity).integers(0, 1 << 32, 4096, dtype=np.uint32)
    tkeys = torch.from_numpy(keys.view(np.int32))
    route = BULK_ENGINES[engine].kernels.route_plain
    for label, rr, pr in fleets(engine, capacity):
        pspec = PlacementSpec(router=pr.spec, r=3, max_resalt=max_resalt)
        want, want_ex = ref_ops.route_replicas_bulk(
            keys, rr._fleet_dev, RefPlacementSpec(router=rr.spec, r=3, max_resalt=max_resalt))
        f = pr._fleet_dev
        got, got_ex = store.route_replicas_impl(
            tkeys, f.packed, f.table, f.state, r=3, omega=pr.spec.omega,
            max_resalt=pspec.resolved_max_resalt, route=route)
        assert got.dtype == torch.int32 and got.shape == (keys.size, 3), label
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=label)
        np.testing.assert_array_equal(got_ex.numpy(), np.asarray(want_ex), err_msg=label)
        via_ops = ops.route_replicas_bulk(tkeys, f, pspec)
        assert torch.equal(via_ops[0], got) and torch.equal(via_ops[1], got_ex)
        if label == "below" and max_resalt is None:
            # n_alive = 2 < r: the third column is a defined duplicate, not
            # an exhaustion
            assert (distinct(got) == 2).all() and not got_ex.any()


@pytest.mark.parametrize("capacity", [64, 1024])
@pytest.mark.parametrize("engine", ENGINES)
def test_placement_diff_matches_reference_ops(engine, capacity):
    keys = np.random.default_rng(5).integers(0, 1 << 32, 4096, dtype=np.uint32)
    tkeys = torch.from_numpy(keys.view(np.int32))
    n = min(capacity // 2, 600)
    rr = RefRouter(n, engine=engine, capacity=capacity)
    pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
    old_ref, old_port = rr._fleet_host, pr._fleet_host
    old_ref = type(old_ref)(old_ref.packed.copy(), old_ref.table.copy(), old_ref.state.copy())
    old_port = store.StorePlacement(pr, r=3)._fleet_snapshot().to("cpu")
    for s in (3, 7, n // 2):
        rr.fail(s), pr.fail(s)
    rr.scale_up(), pr.scale_up()
    want = ref_ops.placement_diff_bulk(keys, old_ref, rr._fleet_dev, RefPlacementSpec(router=rr.spec))
    pspec = PlacementSpec(router=pr.spec)
    got = ops.placement_diff_bulk(tkeys, old_port, pr._fleet_dev, pspec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    route = BULK_ENGINES[engine].kernels.route_plain
    o, f = old_port, pr._fleet_dev
    impl = store.placement_diff_impl(tkeys, o.packed, o.table, o.state, f.packed, f.table,
                                     f.state, r=3, omega=16, max_resalt=3, route=route)
    for g, w in zip(impl, got):
        assert torch.equal(g, w)
    assert 0 < int(got[2].sum()) < got[2].numel()


def _wide_fleets(engine, capacity):
    """(reference router, port router, the port's fleet before the
    failures): n_alive above 32 and, at capacity 64, below 9, so columns
    past n_alive are the defined duplicates."""
    out = []
    cases = ((60, 8), (12, 4)) if capacity == 64 else ((1000, 250),)
    for n, fail in cases:
        rr = RefRouter(n, engine=engine, capacity=capacity)
        pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
        h = rr._fleet_host
        old_ref = type(h)(h.packed.copy(), h.table.copy(), h.state.copy())
        old_port = store.StorePlacement(pr, r=1)._fleet_snapshot().to("cpu")
        victims = np.random.default_rng(n).choice(n - 1, size=fail, replace=False)
        with rr.coalesced_events(), pr.coalesced_events():
            for v in victims:
                rr.fail(int(v)), pr.fail(int(v))
        rr._check_routable(), pr._check_routable()
        out.append((rr, pr, old_ref, old_port))
    return out


@pytest.mark.parametrize("r,diff", [(9, True), (16, False)])
@pytest.mark.parametrize("engine", ENGINES)
def test_wide_replication_matches_reference_ops(engine, r, diff):
    """r past the card kernel's register columns (``MAX_R`` = 8), at
    capacity 64: placement (and at r = 9 the migration diff) against the
    reference's ops.  (The reference's jit of these passes grows with r and
    ``n_words``: 4 s at r = 9 and 21 s at r = 16 for 64 slots, minutes at
    r = 32 or 1024 slots; those cases are held against the reference's
    scalar control plane below.)"""
    keys = np.random.default_rng(r).integers(0, 1 << 32, 1024, dtype=np.uint32)
    tkeys = torch.from_numpy(keys.view(np.int32))
    for rr, pr, old_ref, old_port in _wide_fleets(engine, 64):
        ref_pspec, pspec = RefPlacementSpec(router=rr.spec, r=r), PlacementSpec(router=pr.spec, r=r)
        want = ref_ops.route_replicas_bulk(keys, rr._fleet_dev, ref_pspec)
        got = ops.route_replicas_bulk(tkeys, pr._fleet_dev, pspec)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (distinct(got[0]) == min(r, pr.alive)).all() and not got[1].any()
        if diff:
            want = ref_ops.placement_diff_bulk(keys, old_ref, rr._fleet_dev, ref_pspec)
            got = ops.placement_diff_bulk(tkeys, old_port, pr._fleet_dev, pspec)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _reference_scalar_placement(domain, key: int, r: int) -> list[int]:
    """One key's placement from the reference's scalar control plane: each
    salted family located by its ``FailureDomain``, a collision re-salted
    into the table's alive prefix and probed as ``route_replicas_impl``
    specifies (store.py:131-178)."""
    n_alive, slots = domain.alive_count, domain.replacement_table.slots
    cols = []
    for salt in ref_store.family_salts(r).tolist():
        fam = ref_bits.mix32(key ^ salt)
        b = domain.locate(fam)
        if b in cols:
            q = ref_bits.mulhi32(ref_bits.mix32(fam ^ int(ref_store.RESALT_SALT)), n_alive)
            for _ in range(r):
                if slots[q] not in cols:
                    b = slots[q]
                    break
                q = q + 1 - n_alive if q + 1 >= n_alive else q + 1
        cols.append(b)
    return cols


@pytest.mark.parametrize("capacity,r", [(64, 32), (1024, 9), (1024, 16), (1024, 32)])
@pytest.mark.parametrize("engine", ENGINES)
def test_wide_replication_matches_reference_scalar_plane(engine, capacity, r):
    """r = 9, 16 and 32 where the reference's jit is too slow to compile in
    a test: the plain passes against a placement computed key by key from
    the reference's ``FailureDomain``, and the moved mask against the
    placements' membership."""
    keys = np.random.default_rng(r + capacity).integers(0, 1 << 32, 256, dtype=np.uint32)
    tkeys = torch.from_numpy(keys.view(np.int32))
    for rr, pr, _, old_port in _wide_fleets(engine, capacity):
        pspec = PlacementSpec(router=pr.spec, r=r)
        got, ex = ops.route_replicas_bulk(tkeys, pr._fleet_dev, pspec)
        want = [_reference_scalar_placement(rr.domain, int(k), r) for k in keys]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not ex.any() and (distinct(got) == min(r, pr.alive)).all()
        old, new, moved, _ = ops.placement_diff_bulk(tkeys, old_port, pr._fleet_dev, pspec)
        assert torch.equal(new, got)
        member = (new.numpy()[:, :, None] == old.numpy()[:, None, :]).any(-1)
        np.testing.assert_array_equal(moved.numpy(), ~member)


def test_family_salts_and_constants_match_reference():
    for r in (1, 3, 8):
        np.testing.assert_array_equal(store.family_salts(r), ref_store.family_salts(r))
    assert store.RESALT_SALT == int(ref_store.RESALT_SALT)
    assert store.NO_HOLDER == ref_store.NO_HOLDER
    assert np.unique(store.family_salts(8)).size == 8


def test_placement_spec_matches_reference():
    for kw in (dict(r=0), dict(router=dict(capacity=4), r=5), dict(max_resalt=-1)):
        args = dict(kw)
        rs = args.pop("router", None)
        with pytest.raises(ValueError) as want:
            RefPlacementSpec(**args, **({} if rs is None else {"router": RefRouterSpec(**rs)}))
        with pytest.raises(ValueError) as got:
            PlacementSpec(**args, **({} if rs is None else {"router": RouterSpec(**rs)}))
        assert str(got.value) == str(want.value)
    assert PlacementSpec(r=4).resolved_max_resalt == 4
    assert PlacementSpec(r=4, max_resalt=9).resolved_max_resalt == 9
    hash(PlacementSpec(r=4))


# -- the host plane -------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_place_matches_reference_through_failures(engine):
    p = Pair(8, engine)
    batch = p.both("store.place", KEYS)
    assert batch.mode == "normal" and batch.n_distinct == 3 and (distinct(batch.replicas) == 3).all()
    p.fail(2, 5)
    batch = p.both("store.place", KEYS)
    assert not {2, 5} & set(np.asarray(batch.replicas).reshape(-1).tolist())


@pytest.mark.parametrize("n_alive", (2, 3, 4, 5, 8, 16))
@pytest.mark.parametrize("engine", ENGINES)
def test_distinctness_across_fleet_sizes_matches_reference(engine, n_alive):
    batch = Pair(n_alive, engine).both("store.place", KEYS)
    assert (distinct(batch.replicas) == min(3, n_alive)).all()


def test_r_equals_n_total_matches_reference():
    batch = Pair(4, r=4, capacity=4).both("store.place", KEYS)
    assert (np.sort(batch.replicas, axis=1) == np.arange(4)).all()


def test_typed_degradation_matches_reference():
    p = Pair(8)
    p.fail(0, 1, 2, 3, 4, 5)
    batch = p.both("store.place", KEYS)
    assert (batch.mode, batch.n_distinct) == ("degraded", 2)
    strict = Pair(4, strict=True)
    strict.fail(1, 2)
    assert isinstance(strict.both("store.place", KEYS), P.PlacementDegradedError)
    gone = Pair(2)
    gone.both("store.register", KEYS[:32])
    gone.fail(0, 1)
    assert isinstance(gone.both("store.place", KEYS), P.FleetUnavailableError)
    assert isinstance(gone.both("store.read", 0), P.FleetUnavailableError)


@pytest.mark.parametrize("capacity", [64, 1024])
def test_resalt_exhaustion_matches_reference(capacity):
    p = Pair(4, r=2, max_resalt=0, capacity=capacity)
    keys = np.arange(1024, dtype=np.uint32)
    err = p.both("store.place", keys)
    assert isinstance(err, P.PlacementExhaustedError) and err.n_keys > 0 and err.max_resalt == 0
    replicas, exhausted = p.both("store.place_keys", keys)
    assert exhausted.any() and ((distinct(replicas) == 1) == exhausted.numpy()).all()


def test_degraded_reads_match_reference():
    p = Pair(8)
    p.both("store.register", KEYS[:64])
    p.both("store.read", 3)
    holders = p.port.store.holders[0].tolist()
    p.fail(*holders[1:])
    found, mode = p.both("store.read", 0)
    assert found.tolist() == [holders[0]] and mode == "degraded"
    p.both("store.reachable_counts")
    p.both("store.reachable_mask")


@pytest.mark.parametrize("engine", ENGINES)
def test_migration_plan_matches_reference(engine):
    p = Pair(16, engine, capacity=32)
    p.both("store.register", KEYS)
    p.both("mgr.scale_up")
    plan = p.both("store.plan_migration")
    assert plan.epoch == p.port.router.routing_epoch and 0 < plan.moved_pairs < plan.total_pairs
    want = p.ref.store.plan_migration()
    assert plan.moved_fraction == want.moved_fraction
    assert plan.per_shard_moves() == want.per_shard_moves()
    mv, ref_mv = plan.as_movement_plan(), want.as_movement_plan()
    assert (mv.moved_count, mv.total_keys, mv.destinations(), mv.sources()) == (
        ref_mv.moved_count, ref_mv.total_keys, ref_mv.destinations(), ref_mv.sources())
    assert norm(mv.moves) == norm(ref_mv.moves)


@pytest.mark.parametrize("engine", ENGINES)
def test_sync_targets_matches_reference_on_messy_holders(engine):
    """Holders with stale, duplicated, retired and missing entries (as a
    store mid-repair holds them): the same triples, in the same order, and
    the same realigned rows, including which stale copy fills which
    missing column."""
    rng = np.random.default_rng(11)
    p = Pair(12, engine, r=4, capacity=16)
    p.both("store.register", KEYS)
    messy = rng.integers(-1, 15, size=p.port.store.holders.shape)
    messy[::3, 1] = messy[::3, 0]  # duplicates
    p.port.store._holders = messy.copy()
    p.ref.store._holders = messy.copy()
    p.fail(3, 7)
    p.both("mgr.scale_down")
    p.both("store.sync_targets")
    p.same_holders()
    p.both("store.reachable_counts")


def test_sync_targets_purges_retired_slots_like_reference():
    p = Pair(4, capacity=4)
    p.both("store.register", KEYS[:64])
    p.fail(3)  # the top slot: a LIFO retirement
    p.both("store.sync_targets")
    p.same_holders()
    assert (p.port.store.holders < 3).all()


def test_movement_plan_and_planners_match_reference():
    keys = np.arange(6, dtype=np.uint64)
    before, after = np.array([0, 1, 2, 0, 1, 2]), np.array([0, 1, 3, 3, 1, 2])
    a = ref_assignment.MovementPlan.from_diff(keys, before, after)
    b = assignment.MovementPlan.from_diff(keys, before, after)
    assert (b.moved_count, b.total_keys, b.destinations(), b.sources(), b.moved_fraction) == (
        a.moved_count, a.total_keys, a.destinations(), a.sources(), a.moved_fraction)
    assert norm(b.moves) == norm(a.moves)
    m, rm = elastic.plan_expert_migration(256, 16, 18), ref_elastic.plan_expert_migration(256, 16, 18)
    assert norm(m.plan.moves) == norm(rm.plan.moves) and m.bytes_moved == rm.bytes_moved
    assert (m.old_devices, m.new_devices, m.num_experts) == (16, 18, 256)
    s, rs = elastic.plan_shard_reassignment(1024, 8, 6), ref_elastic.plan_shard_reassignment(1024, 8, 6)
    assert norm(s.moves) == norm(rs.moves) and s.sources() <= {6, 7}


@pytest.mark.parametrize("old,new", [(16, 17), (16, 20), (17, 16), (16, 8)])
def test_assignment_resize_matches_reference(old, new):
    a, ra = assignment.Assignment(range(2048), old), ref_assignment.Assignment(range(2048), old)
    assert a.table() == ra.table() and a.load() == ra.load()
    plan, want = a.resize(new), ra.resize(new)
    assert norm(plan.moves) == norm(want.moves) and plan.moved_fraction == want.moved_fraction
    if new > old:
        assert plan.destinations() <= set(range(old, new))
    else:
        assert plan.sources() <= set(range(new, old))


def test_failure_domain_matches_reference_table_domain():
    fd = elastic.FailureDomain(12, engine="binomial32")
    rd = ref_elastic.FailureDomain(12, engine="binomial32", chain_bits=32, resolve="table")
    keys = range(6000)
    for event in (("fail", 3), ("fail", 0), ("scale_up",), ("recover", 3), ("scale_down",)):
        assert getattr(fd, event[0])(*event[1:]) == getattr(rd, event[0])(*event[1:])
        assert [fd.locate(k) for k in keys] == [rd.locate(k) for k in keys]


# -- repair -----------------------------------------------------------------------


def repairers(p, budget):
    return (R.PlacementRepairer(p.ref.store, p.ref.mgr, budget_per_tick=budget),
            P.PlacementRepairer(p.port.store, p.port.mgr, budget_per_tick=budget))


def same_ticks(rr, pr, n=None):
    """Tick both until drained (or ``n`` times): the same tasks."""
    done = []
    for _ in range(10_000 if n is None else n):
        if not rr.backlog and n is None:
            break
        want, got = rr.tick(), pr.tick()
        assert norm(got) == norm(want)
        done += got
    assert (pr.backlog, pr.lost, pr.completed, pr.batches) == (
        rr.backlog, rr.lost, rr.completed, rr.batches)
    return done


def test_repairer_budget_and_oldest_first_match_reference():
    p = Pair(8)
    p.both("store.register", KEYS)
    rr, pr = repairers(p, 5)
    p.fail(1)
    assert pr.backlog == rr.backlog > 0
    first = same_ticks(rr, pr, 1)
    assert 0 < len(first) <= 5
    p.fail(3)  # new under-replication, a later epoch
    done = same_ticks(rr, pr)
    assert [t.epoch for t in done] == sorted(t.epoch for t in done)
    assert max(pr.batches) <= 5 and (p.port.store.reachable_counts() == 3).all()
    p.same_holders()


@pytest.mark.parametrize("engine", ENGINES)
def test_repair_after_churn_matches_reference(engine):
    p = Pair(8, engine, capacity=16)
    p.both("store.register", KEYS)
    rr, pr = repairers(p, 16)
    p.fail(2)
    same_ticks(rr, pr, 3)
    p.both("mgr.scale_up")
    p.fail(5)
    same_ticks(rr, pr, 2)
    p.both("mgr.recover", 2)
    same_ticks(rr, pr)
    assert (p.port.store.reachable_counts() == min(3, p.port.mgr.n_alive)).all()
    p.same_holders()


def test_repair_of_a_lost_key_matches_reference():
    """Every holder of some keys fails at once: their tasks count in
    ``lost``, as the reference counts them."""
    p = Pair(5)
    p.both("store.register", KEYS)
    rr, pr = repairers(p, 64)
    p.both("mgr.apply", [("fail", 0), ("fail", 1), ("fail", 2)])
    same_ticks(rr, pr)
    assert pr.lost == rr.lost > 0
    p.same_holders()


def test_repairer_ticks_through_manager_and_checks_router():
    p = Pair(8)
    p.both("store.register", KEYS[:64])
    rr, pr = repairers(p, 1_000_000)
    p.fail(4)
    assert pr.backlog == rr.backlog > 0
    p.both("mgr.tick")
    assert pr.backlog == 0 and (p.port.store.reachable_counts() == 3).all()
    other = store.StorePlacement(BatchRouter(8, device="cpu"), r=3)
    with pytest.raises(ValueError, match="SAME router"):
        P.PlacementRepairer(other, p.port.mgr)
    with pytest.raises(ValueError, match="budget_per_tick"):
        P.PlacementRepairer(p.port.store, p.port.mgr, budget_per_tick=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_placement_replay_parity_matches_reference(engine):
    p = Pair(8, engine, capacity=16)
    p.both("store.register", KEYS)
    rr, pr = repairers(p, 64)
    p.fail(1)
    p.both("mgr.scale_up")
    snaps = p.both("mgr.snapshot")
    p.fail(6)
    p.both("mgr.recover", 1)
    same_ticks(rr, pr)
    pr.verify_placement_replay()
    pr.verify_placement_replay(snaps)
    assert p.port.mgr.journal.to_jsonl() == p.ref.mgr.journal.to_jsonl()
    p.port.store._holders[:] = 0  # holders are not what replay checks
    pr.verify_placement_replay()


def test_store_crosses_over_from_reference():
    p = Pair(8)
    p.both("store.register", KEYS)
    rr, _ = repairers(p, 7)
    p.ref.mgr.fail(2)
    rr.tick()  # the reference store, mid-repair
    port = store_from_numpy(p.port.router, p.ref.store.keys, p.ref.store.holders)
    p.port.mgr.fail(2)
    np.testing.assert_array_equal(port.holders, p.ref.store.holders)
    assert port.r == 3 and norm(port.sync_targets()) == norm(p.ref.store.sync_targets())
    np.testing.assert_array_equal(port.holders, p.ref.store.holders)
