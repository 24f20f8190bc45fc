"""The CUDA routing kernels on the card: each kernel instance against its
plain torch version (bit-exact), also at ragged sizes around the warp-chunk
kernels' widths, the dynamic-n lookup at the edges of its runtime n and
with n rewritten on the device, the MoE router's fused key build
(``lookup_router``) and its dynamic-n path,
``BatchRouter`` on the card against the plain-version router, a 2-layer
hash-routed MoE ``ServingTier`` on the card against the same tier on the CPU,
the R-way placement kernels (the family route and ``resolve``, also past
the register columns at r = 9, 16 and 32) against their plain versions, the
placement tier with its lifecycle and repairer on the card against the same
tier on the CPU, the instrumented route (``route_load``) against its plain
version on both sides of its shared-histogram threshold, and the streaming
front end over a monitored router on the card against the same on the CPU.
Needs a CUDA card and ``nvcc``; skips elsewhere.
Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.binomial import binomial_lookup32  # noqa: E402
from repro_torch.core.bulk import FleetState  # noqa: E402
from repro_torch.core.jump import jump_lookup32  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.core.bulk import PlacementSpec  # noqa: E402
from repro_torch.placement.store import StorePlacement  # noqa: E402
from repro_torch.serving import lifecycle as L  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.engine import Request, ServingTier  # noqa: E402
from repro_torch.serving.router import SessionRouter  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fleet(engine, n, capacity, n_fail, seed):
    plane = SessionRouter(n, engine=BULK_ENGINES[engine].scalar_engine)
    for b in np.random.default_rng(seed).choice(n - 1, size=n_fail, replace=False):
        plane.fail(int(b))
    return FleetState.pack(plane.domain, capacity).to("cuda")


def _u32(seed, size, device):
    x = np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.parametrize("fleet", [(1000, 1024, 0), (1000, 1024, 250), (3000, 4096, 900), (2, 64, 0)])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_kernels_match_plain(cuda, engine, fleet):
    k = BULK_ENGINES[engine].kernels
    f = _fleet(engine, *fleet, seed=fleet[2])
    keys, hi = _u32(1, 1 << 16, cuda), _u32(2, 1 << 16, cuda)
    fl = (f.packed, f.table, f.state)
    for omega in (1, 16):
        pairs = [
            (k.route(keys, *fl, omega), k.route_plain(keys, *fl, omega)),
            (k.ingest(keys, hi, *fl, omega), k.ingest_plain(keys, hi, *fl, omega)),
            (k.lookup_dyn(keys, f.state[:1], omega), k.lookup_dyn_plain(keys, f.state[:1], omega)),
        ]
        for got, want in pairs:
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want.to(torch.int32))


#: runtime n at the dynamic-n lookup's edges: n <= 1 (zeros, from a launch),
#: the jump chains' exact-f32 edge (2^23) and the first n past it, and the
#: top of the int32 n the JAX package shares (2^31 - 1)
DYN_NS = (0, 1, 2, 1000, 1025, 1 << 23, (1 << 23) + 1, (1 << 31) - 1)
ORACLE32 = {"binomial": binomial_lookup32, "jump": jump_lookup32}


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_lookup_dyn_edges(cuda, engine):
    k = BULK_ENGINES[engine].kernels
    keys = _u32(10, 1 << 16, cuda)
    sample = keys[:512].cpu().numpy().view(np.uint32)
    for n in DYN_NS:
        n_dev = torch.tensor([n], dtype=torch.int32, device=cuda)
        for omega in (1, 16):
            launched = k.launches["lookup_dyn"]
            got = k.lookup_dyn(keys, n_dev, omega)
            assert k.launches["lookup_dyn"] == launched + 1
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, k.lookup_dyn_plain(keys, n_dev, omega).to(torch.int32))
            want = [ORACLE32[engine](int(x), n, omega) for x in sample]
            np.testing.assert_array_equal(got[:512].cpu().numpy(), want)


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_lookup_dyn_reads_n_rewritten_on_device(cuda, engine):
    """One n tensor, rewritten by a device write between two launches while
    the host never synchronises: each launch reads the n of its turn."""
    k = BULK_ENGINES[engine].kernels
    keys = _u32(11, 1 << 16, cuda)
    n = torch.tensor([1000], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = k.lookup_dyn(keys, n)
        n.fill_(1025)
        second = k.lookup_dyn(keys, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, value in ((first, 1000), (second, 1025)):
        want = k.lookup_dyn_plain(keys, torch.tensor([value], dtype=torch.int32, device=cuda))
        assert torch.equal(got, want.to(torch.int32))


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_moe_dynamic_n_router_matches_default(cuda, engine):
    """``moe.route`` with ``router_dynamic_n`` (one lookup_dyn launch) gives
    the default call's expert ids (lookup_router) at the serve path's router
    shapes."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine))
    dynamic = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_dynamic_n=True))
    kernels = BULK_ENGINES[engine].kernels
    rng = np.random.default_rng(12)
    for shape in ((16, 8), (16, 1)):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape)).to(cuda)
        x = torch.zeros((*shape, cfg.d_model), device=cuda)
        before = kernels.launches["lookup_dyn"]
        got = moe.route(None, x, tokens, 3, dynamic)[0]
        assert kernels.launches["lookup_dyn"] == before + 1
        assert torch.equal(got, moe.route(None, x, tokens, 3, cfg)[0])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_batch_router_on_card(cuda, engine, fused):
    kernels = BULK_ENGINES[engine].kernels
    kernels.reset_launches()
    gpu = BatchRouter(100, engine=engine, fused=fused)
    cpu = BatchRouter(100, engine=engine, fused=fused, device="cpu")
    keys = _u32(3, 50000, cuda)
    ids = np.random.default_rng(4).integers(0, 2**64, size=5000, dtype=np.uint64)
    for event in (None, ("fail", 7), ("fail", 99), ("scale_up",), ("recover", 7), ("scale_down",)):
        if event:
            getattr(gpu, event[0])(*event[1:]), getattr(cpu, event[0])(*event[1:])
        out = gpu.route_keys(keys)
        assert out.is_cuda
        np.testing.assert_array_equal(out.cpu().numpy(), cpu.route_keys_np(keys.cpu().numpy()))
        np.testing.assert_array_equal(gpu.route_ids(ids).cpu().numpy(), cpu.route_ids(ids).numpy())
    kinds = ("route", "ingest") if fused else ("lookup_dyn",)
    assert all(kernels.launches[kind] > 0 for kind in kinds)


def test_wrappers_refuse_non_int32_on_card(cuda):
    """What the kernels do not take: r = 0, non-int32 keys, a short state.
    r = 9 (past resolve's register columns) is taken."""
    k = BULK_ENGINES["binomial"].kernels
    f = _fleet("binomial", 10, 64, 0, 0)
    keys = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="r >= 1"):
        k.route_family(keys, 0, f.packed, f.table, f.state)
    with pytest.raises(ValueError, match="r >= 1"):
        k.resolve(keys, torch.zeros((8, 0), dtype=torch.int32, device=cuda), f.table, f.state, 0)
    base = k.route_family(keys, 9, f.packed, f.table, f.state)
    assert base.shape == (8, 9)
    out, ex, _ = k.resolve(keys, base, f.table, f.state, 9)
    assert out.shape == (8, 9) and not ex.any()
    with pytest.raises(ValueError, match="int32"):
        k.route(torch.zeros(8, dtype=torch.int64, device=cuda), f.packed, f.table, f.state)
    with pytest.raises(ValueError, match="n_total, n_alive"):
        k.route(torch.zeros(8, dtype=torch.int32, device=cuda), f.packed, f.table, f.state[:1])


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_lookup_vec_matches_plain(cuda, engine):
    k = BULK_ENGINES[engine].kernels
    keys = _u32(5, 1 << 16, cuda)
    for n in (2, 3, 11, 127, 128, 129, 1000, 1025, 65536, 100000):
        for omega in (1, 4, 16, 32):
            got = k.lookup_vec(keys, n, omega)
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, k.lookup_vec_plain(keys, n, omega))
    launched = k.launches["lookup_vec"]
    assert not k.lookup_vec(keys, 1).any() and k.launches["lookup_vec"] == launched


#: ragged key counts around a warp (32), a warp's chunk (256 = 32 lanes x 8
#: keys), a block's pass (2,048) and beyond
TAIL_SIZES = (1, 31, 33, 255, 257, 2047, 2049, 4097)


@pytest.mark.parametrize("size", TAIL_SIZES)
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_redesigned_kernels_at_tail_sizes(cuda, engine, size):
    k = BULK_ENGINES[engine].kernels
    keys, hi = _u32(7, size, cuda), _u32(8, size, cuda)
    for fleet in ((1000, 1024, 250), (2, 64, 0)):
        f = _fleet(engine, *fleet, seed=fleet[2])
        fl = (f.packed, f.table, f.state)
        for omega in (1, 16):
            assert torch.equal(k.route(keys, *fl, omega), k.route_plain(keys, *fl, omega).to(torch.int32))
            assert torch.equal(k.ingest(keys, hi, *fl, omega),
                               k.ingest_plain(keys, hi, *fl, omega).to(torch.int32))
            assert torch.equal(k.lookup_dyn(keys, f.state[:1], omega),
                               k.lookup_dyn_plain(keys, f.state[:1], omega).to(torch.int32))
    for n in (2, 128, 1000, 1025, 100000, (1 << 23) + 1):
        for omega in (1, 16):
            assert torch.equal(k.lookup_vec(keys, n, omega), k.lookup_vec_plain(keys, n, omega))


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_lookup_router_matches_plain_at_serve_shapes(cuda, engine):
    """The router's calls in a serve: decode and prefill groups of 1-16
    requests, int64 ids as the serving path gives them and int32 ids."""
    k = BULK_ENGINES[engine].kernels
    rng = np.random.default_rng(9)
    before = k.launches["lookup_vec"]
    calls = 0
    for shape in ((1, 1), (8, 1), (16, 1), (8, 8), (16, 8)):
        tokens = torch.from_numpy(rng.integers(0, 151936, size=shape)).to(cuda)
        for salt in (0, 1, 93):
            want = k.lookup_router_plain(tokens, salt, 8, 128)
            for ids in (tokens, tokens.to(torch.int32)):
                got = k.lookup_router(ids, salt, 8, 128)
                assert got.is_cuda and got.dtype == torch.int32 and got.shape == (*shape, 8)
                assert torch.equal(got, want)
                calls += 1
    assert k.launches["lookup_vec"] - before == calls


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_hash_routed_serving_on_card(cuda, engine):
    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = M.params_to(params, cuda)
    gpu = ServingTier(cfg, on_card, 3, max_len=16, engine=engine)
    cpu = ServingTier(cfg, params, 3, max_len=16, engine=engine, device="cpu")
    rng = np.random.default_rng(6)
    reqs = [Request(f"s-{i}", rng.integers(0, cfg.vocab_size, size=6).astype(np.int32), 4)
            for i in range(12)]
    kernels = BULK_ENGINES[engine].kernels
    kernels.reset_launches()
    for failed in (None, 1):
        if failed is not None:
            gpu.fail(failed), cpu.fail(failed)
        got, want = gpu.serve(reqs), cpu.serve(reqs)
        assert sorted(got) == sorted(want)
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid])
    assert kernels.launches["lookup_vec"] > 0 and kernels.launches["route"] == 2


#: (n, capacity, failed): n_alive above r, at r = 3, and below it
PLACEMENT_FLEETS = ((1000, 1024, 250), (3, 64, 0), (3, 64, 1), (40000, 65536, 10000))


@pytest.mark.parametrize("max_resalt", [None, 0, 1])
@pytest.mark.parametrize("r", [1, 3, 5, 8, 9, 16, 32])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_placement_kernels_match_plain(cuda, engine, r, max_resalt):
    """The family route (all r columns in one launch) and resolve (with and
    without the moved mask) against their plain versions, bit-exact, also
    at ragged sizes; one launch each."""
    k = BULK_ENGINES[engine].kernels
    for fleet in PLACEMENT_FLEETS:
        f = _fleet(engine, *fleet, seed=fleet[2] + 1)
        old = _fleet(engine, fleet[0], fleet[1], 0, 0)
        mr = r if max_resalt is None else max_resalt
        for size in (1 << 14, 1, 33, 257, 4097):
            keys = _u32(size + r, size, cuda)
            before = dict(k.launches)
            base = k.route_family(keys, r, f.packed, f.table, f.state)
            assert base.shape == (size, r) and base.dtype == torch.int32
            assert torch.equal(base, k.route_family_plain(keys, r, f.packed, f.table, f.state)
                               .to(torch.int32))
            prev, _, _ = k.resolve(keys, k.route_family(keys, r, old.packed, old.table, old.state),
                                   old.table, old.state, mr)
            got = k.resolve(keys, base, f.table, f.state, mr, prev)
            want = k.resolve_plain(keys, base, f.table, f.state, mr, prev)
            for g, w in zip(got, want):
                assert g.is_cuda and torch.equal(g, w)
            alone = k.resolve(keys, base, f.table, f.state, mr)
            assert alone[2] is None and torch.equal(alone[0], got[0]) and torch.equal(alone[1], got[1])
            assert k.launches["route_family"] - before["route_family"] == 2
            assert k.launches["resolve"] - before["resolve"] == 3


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_placement_entry_points_launch_as_documented(cuda, engine):
    k = BULK_ENGINES[engine].kernels
    router = BatchRouter(1000, engine=engine, capacity=1024)
    pspec = PlacementSpec(router=router.spec, r=3)
    keys = _u32(21, 1 << 16, cuda)
    old = router._fleet_dev
    router.fail(17), router.fail(500)
    k.reset_launches()
    rep, ex = ops.route_replicas_bulk(keys, router._fleet_dev, pspec)
    assert (k.launches["route_family"], k.launches["resolve"]) == (1, 1)
    o, n, moved, ex2 = ops.placement_diff_bulk(keys, old, router._fleet_dev, pspec)
    assert (k.launches["route_family"], k.launches["resolve"]) == (3, 3)
    assert torch.equal(n, rep) and torch.equal(ex, ex2) and not ex.any()
    f = router._fleet_dev
    from repro_torch.placement.store import placement_diff_impl
    want = placement_diff_impl(keys, old.packed, old.table, old.state, f.packed, f.table, f.state,
                               r=3, omega=16, max_resalt=3, route=k.route_plain)
    for g, w in zip((o, n, moved, ex2), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("r", [3, 16])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_placement_tier_on_card_matches_cpu(cuda, engine, r):
    """StorePlacement + LifecycleManager + PlacementRepairer on the card
    against the same tier on the CPU (plain versions): the same journal,
    placements, migration plan, repair tasks, lost and completed; also at
    r = 16, past resolve's register columns."""
    keys = np.random.default_rng(8).integers(0, 1 << 32, 1 << 14, dtype=np.uint32)
    sides = []
    for device in ("cuda", "cpu"):
        clock = L.ManualClock()
        router = BatchRouter(100, engine=engine, capacity=128, device=device)
        mgr = L.LifecycleManager(router, clock=clock)
        store = StorePlacement(router, r=r)
        store.register(keys)
        rep = L.PlacementRepairer(store, mgr, budget_per_tick=512)
        plan = tasks = None
        for s in range(100):
            mgr.heartbeat(s)
        clock.advance(mgr.config.heartbeat.fail_after + 1)
        for s in range(100):
            if s not in (3, 40, 41, 77):
                mgr.heartbeat(s)
        mgr.tick()
        plan = store.plan_migration()
        tasks = []
        while rep.backlog:
            tasks += rep.tick()
        rep.verify_placement_replay()
        sides.append((mgr.journal.to_jsonl(), store.place(keys).replicas, plan.new, plan.moved,
                      [dataclasses.astuple(t) for t in tasks], rep.lost, rep.completed,
                      store.holders.copy()))
    for got, want in zip(*sides):
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


#: (n, capacity, failed) of the route_load cases: below the shared-histogram
#: threshold (4,096 bins) and above it
LOAD_FLEETS = ((1000, 1024, 250), (3, 64, 0), (6000, 8192, 1500), (40000, 65536, 10000))


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_route_load_matches_plain(cuda, engine, shift):
    """The instrumented route against its plain version: replica ids
    bit-exact with ``route``, counts bit-exact (wrapping from near 2^32),
    advanced in place, one launch each, at ragged sizes."""
    k = BULK_ENGINES[engine].kernels
    rng = np.random.default_rng(shift)
    for fleet in LOAD_FLEETS:
        f = _fleet(engine, *fleet, seed=fleet[2] + 3)
        fl = (f.packed, f.table, f.state)
        for size in (1, 33, 4097, 1 << 18):
            keys = _u32(size, size, cuda)
            start = (2**32 - rng.integers(1, 1024, fleet[1])).astype(np.uint32)
            counts = torch.from_numpy(start.view(np.int32)).to(cuda)
            want_reps, want = k.route_load_plain(keys, *fl, counts, sample_shift=shift)
            before = k.launches["route_load"]
            reps, got = k.route_load(keys, *fl, counts, sample_shift=shift)
            assert got is counts and k.launches["route_load"] == before + 1
            assert torch.equal(reps, k.route(keys, *fl))
            assert torch.equal(reps, want_reps.to(torch.int32))
            assert torch.equal(got, want)


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_streaming_front_end_on_card_matches_cpu(cuda, engine):
    """A front end over a monitored router, a lifecycle manager and a
    placement, on one scripted virtual timeline: the card's results,
    registry bytes and drained counts equal the CPU's; every dispatch is one
    route_load launch."""
    from repro_torch import observability as O
    from repro_torch.serving import streaming as S

    keys = np.random.default_rng(1).integers(0, 1 << 32, 400)
    sides = []
    for device in ("cuda", "cpu"):
        clock = S.VirtualClockUs()
        router = BatchRouter(40, engine=engine, capacity=64, device=device)
        mgr = L.LifecycleManager(router, clock=clock.seconds_view())
        store = StorePlacement(router, r=3)
        store.register(np.arange(1024, dtype=np.uint32))
        L.PlacementRepairer(store, mgr, budget_per_tick=64)
        reg = O.MetricsRegistry(clock=clock)
        mon = O.LoadMonitor(router, metrics=reg, config=O.LoadConfig(drain_every=8))
        fe = S.StreamingFrontEnd(mgr, store=store, clock=clock, metrics=reg,
                                 service_model=lambda n: 300)
        kernels = BULK_ENGINES[engine].kernels
        kernels.reset_launches()
        served = []
        for i, key in enumerate(keys):
            fe.submit(S.StreamRequest(key=int(key), deadline_us=clock.now_us() + 20_000,
                                      tenant=f"t{i % 8}"))
            clock.advance_us(40)
            served += fe.pump()
            if i == 200:
                mgr.fail(7)
        served += fe.drain()
        reads = [fe.read(i) for i in range(0, 1024, 16)]
        mon.drain()
        if device == "cuda":
            assert kernels.launches["route_load"] == fe.batcher.dispatches > 0
        sides.append(([(r.request.key, r.replica, r.t_complete_us, r.epoch) for r in served],
                      [(r.shard, r.hedged) for r in reads], O.to_json(reg, trace=fe.tracer, monitor=mon),
                      mon.totals.tolist()))
    assert sides[0] == sides[1]
