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
version on both sides of its shared-histogram threshold, the streaming
front end over a monitored router on the card against the same on the CPU,
the chain-mode remap (``chain_remap``) against its plain version and the
scalar chain oracle, a reduced DeepSeek-V3 ``ServingTier`` (MLA, the
hash router, shared experts) on the card against the same tier on the CPU,
and the reduced Starcoder2, RecurrentGemma and Mamba2 tiers and the
MusicGen and Qwen2-VL embeds models on the card against the CPU, one
train step of the reduced hash-routed Qwen3 on the card against the CPU,
a bf16 checkpoint round trip on the card, and the constant-time
certifier's graph targets and SASS gate on the card.
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
from repro_torch.core.bulk import ChainFleet, FleetState, RouterSpec  # noqa: E402
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
    plane = SessionRouter(n, engine=BULK_ENGINES[engine].scalar_engine, chain_bits=32,
                          resolve="table", allow_empty=True)
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
#: threshold (4,096 bins), at it, one bin past it, and above it
LOAD_FLEETS = ((1000, 1024, 250), (3, 64, 0), (3000, 4096, 750), (3000, 4097, 750),
               (6000, 8192, 1500), (40000, 65536, 10000))


def _load_fleet(engine, n, capacity, n_fail, seed):
    """The fleet's (packed, table, state) for route_load.  A capacity that is
    not a power of two (no fleet has one) takes the first ``capacity``
    bins of the next power of two's table and the mask words for them; with
    ``n`` below it they route as the whole table does."""
    size = 1 << (capacity - 1).bit_length()
    f = _fleet(engine, n, size, n_fail, seed)
    return f.packed[:(capacity + 31) // 32], f.table[:capacity], f.state


def _check_route_load(k, keys, fl, capacity, shift, rng):
    """One route_load call against its plain version and route, from an
    accumulator near 2^32: ids and counts bit-exact, one launch, in place."""
    start = (2**32 - rng.integers(1, 1024, capacity)).astype(np.uint32)
    counts = torch.from_numpy(start.view(np.int32)).to(keys.device)
    want_reps, want = k.route_load_plain(keys, *fl, counts, sample_shift=shift)
    before = k.launches["route_load"]
    reps, got = k.route_load(keys, *fl, counts, sample_shift=shift)
    assert got is counts and k.launches["route_load"] == before + 1
    assert torch.equal(reps, k.route(keys, *fl))
    assert torch.equal(reps, want_reps.to(torch.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_route_load_matches_plain(cuda, engine, shift):
    """The instrumented route against its plain version: replica ids
    bit-exact with ``route``, counts bit-exact (wrapping from near 2^32),
    advanced in place, one launch each, at ragged sizes."""
    k = BULK_ENGINES[engine].kernels
    rng = np.random.default_rng(shift)
    for fleet in LOAD_FLEETS:
        fl = _load_fleet(engine, *fleet, seed=fleet[2] + 3)
        for size in (1, 33, 4097, 1 << 18):
            _check_route_load(k, _u32(size, size, cuda), fl, fleet[1], shift, rng)


def _load_grid(engine, n, capacity):
    """route_load's grid (blocks) for n keys at this capacity."""
    from repro_torch.kernels import build

    return build.library().routing_route_load_grid(BULK_ENGINES[engine].kernels.engine_id, n,
                                                   capacity)


#: the shared-histogram launch's edges: (keys, the grid it must launch); a
#: tile is 256 keys at one key a lane, and "pass" is a full pass of the
#: resident grid (every warp one chunk of 256 keys)
LOAD_EDGES = {
    "one_tile": (256, 1),
    "seven_tiles": (7 * 256, 7),
    "fourteen_tiles_ragged": (13 * 256 + 5, 14),
    "resident_pass": ("pass", None),
    "resident_pass_and_one": ("pass+1", None),
}


@pytest.mark.parametrize("edge", sorted(LOAD_EDGES))
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_route_load_launch_edges(cuda, engine, shift, edge):
    """The shared-histogram instance at its launch's edges, on the fleet of
    1000 in capacity 1024 with 250 failed: one tile (one block), seven
    tiles, fourteen with a ragged last one, a full pass of the resident grid
    (every warp one chunk) and one key past it (a warp takes a second
    chunk); bit-exact with the plain version and route."""
    k = BULK_ENGINES[engine].kernels
    size, grid = LOAD_EDGES[edge]
    if isinstance(size, str):
        grid = _load_grid(engine, 1 << 40, 1024)
        size = grid * 256 * 8 + (size == "pass+1")
    assert _load_grid(engine, size, 1024) == grid
    fl = _load_fleet(engine, 1000, 1024, 250, seed=253)
    _check_route_load(k, _u32(size, size, cuda), fl, 1024, shift, np.random.default_rng(size))


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


#: (n, capacity, failed) of the chain checks: 0, 6, 25, 50 and 90 % failed
CHAIN_FLEETS = ((1000, 1024, 0), (1000, 1024, 60), (1000, 1024, 250), (1000, 1024, 500),
                (40, 64, 20), (1000, 1024, 900))


@pytest.mark.parametrize("max_chain", [0, 1, 2, 8, 4096])
@pytest.mark.parametrize("fleet", CHAIN_FLEETS)
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_chain_remap_matches_plain_and_oracle(cuda, engine, fleet, max_chain):
    n, capacity, n_fail = fleet
    plane = SessionRouter(n, engine=BULK_ENGINES[engine].scalar_engine, chain_bits=32,
                          max_chain=max_chain)
    for b in np.random.default_rng(n_fail).choice(n - 1, size=n_fail, replace=False):
        plane.fail(int(b))
    chain = ChainFleet.pack(plane.domain, capacity)
    dev, host = chain.to(cuda), chain.to("cpu")
    k = BULK_ENGINES[engine].kernels
    spec = RouterSpec(engine, capacity)
    for size in (1, 33, 4097, 1 << 18):
        keys = _u32(size, size, cuda)
        before = k.launches["chain_remap"]
        got = ops.route_chain_bulk(keys, dev, spec)
        assert k.launches["chain_remap"] - before == 1
        want = ops.route_chain_bulk(keys.cpu(), host, spec)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    sample = keys[:2048].cpu().numpy().view(np.uint32)
    assert got[:2048].cpu().numpy().tolist() == [plane.domain.locate(int(x)) for x in sample]
    # past a pass of the kernel's resident grid its warps' rings carry from
    # chunk to chunk: held against the plain version on the card
    keys = _u32(5, (1 << 22) + 33, cuda)
    base = k.lookup_dyn(keys, dev.state[:1])
    got = k.chain_remap(keys, base, dev.packed, dev.state, max_chain)
    assert torch.equal(got, k.chain_remap_plain(keys, base, dev.packed, dev.state, max_chain))
    sample = keys[-2048:].cpu().numpy().view(np.uint32)
    assert got[-2048:].cpu().numpy().tolist() == [plane.domain.locate(int(x)) for x in sample]


def test_chain_remap_reads_first_alive_from_device(cuda):
    """Rewriting the device scalars between two launches re-aims the
    exhausted lanes without a host copy of them."""
    plane = SessionRouter(100, engine="binomial32", chain_bits=32)
    for b in range(0, 99, 2):
        plane.fail(b)
    chain = ChainFleet.pack(plane.domain, 128).to(cuda)
    k = BULK_ENGINES["binomial"].kernels
    keys = _u32(3, 1 << 16, cuda)
    buckets = k.lookup_dyn(keys, chain.state[:1])
    first = k.chain_remap(keys, buckets, chain.packed, chain.state, 0)
    chain.state[1] = 7
    second = k.chain_remap(keys, buckets, chain.packed, chain.state, 0)
    removed = first != buckets
    assert bool(removed.any()) and bool((first[removed] == 1).all())
    assert bool((second[removed] == 7).all()) and torch.equal(first[~removed], second[~removed])


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_deepseek_v3_serving_on_card(cuda, engine):
    cfg = reduced_config("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    gpu = ServingTier(cfg, M.params_to(params, cuda), 3, max_len=16, engine=engine)
    cpu = ServingTier(cfg, params, 3, max_len=16, engine=engine, device="cpu")
    rng = np.random.default_rng(8)
    reqs = [Request(f"s-{i}", rng.integers(0, cfg.vocab_size, size=6).astype(np.int32), 4)
            for i in range(12)]
    for failed in (None, 1):
        if failed is not None:
            gpu.fail(failed), cpu.fail(failed)
        got, want = gpu.serve(reqs), cpu.serve(reqs)
        assert sorted(got) == sorted(want)
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid])
    prompts = torch.from_numpy(np.stack([r.prompt for r in reqs]))
    _, on_card = M.prefill(gpu.replicas[0].params, {"tokens": prompts.to(cuda)}, cfg, 16)
    _, on_cpu = M.prefill(params, {"tokens": prompts}, cfg, 16)
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "recurrentgemma-9b", "mamba2-1.3b"])
def test_lm_family_serving_on_card(cuda, arch):
    """The reduced token-input families through ``ServingTier`` on the card
    against the same tier on the CPU, with prompts of 24 tokens: past the
    reduced window of 16 (the ring cache) and three SSD chunks of 8."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    gpu = ServingTier(cfg, M.params_to(params, cuda), 3, max_len=32)
    cpu = ServingTier(cfg, params, 3, max_len=32, device="cpu")
    rng = np.random.default_rng(9)
    reqs = [Request(f"s-{i}", rng.integers(0, cfg.vocab_size, size=24).astype(np.int32), 4)
            for i in range(12)]
    for failed in (None, 1):
        if failed is not None:
            gpu.fail(failed), cpu.fail(failed)
        got, want = gpu.serve(reqs), cpu.serve(reqs)
        assert sorted(got) == sorted(want)
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid])


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_embeds_family_on_card(cuda, arch):
    """The reduced embeds-input families (sinusoidal positions, M-RoPE):
    prefill and three decode steps on the card against the CPU, logits
    within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = M.params_to(params, cuda)
    rng = np.random.default_rng(10)
    embeds = torch.from_numpy(rng.standard_normal((3, 27, cfg.d_model)).astype(np.float32))
    batch = {"embeds": embeds[:, :24]}
    if cfg.input_mode == "embeds_mrope":
        t = torch.arange(24, dtype=torch.int32)
        batch["positions"] = torch.stack([t, t // 2, t % 3])[:, None].expand(3, 3, 24).contiguous()
    results = []
    for p, dev in ((on_card, cuda), (params, "cpu")):
        cache, logits = M.prefill(p, {k: v.to(dev) for k, v in batch.items()}, cfg, 28)
        steps = [logits.cpu()]
        for t in range(24, 27):
            cache, logits = M.decode_step(p, cache, {"embeds": embeds[:, t:t + 1].to(dev)}, cfg)
            steps.append(logits.cpu())
        results.append(torch.stack(steps))
    np.testing.assert_allclose(results[0].numpy(), results[1].numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_train_step_on_card_matches_cpu(cuda, engine):
    """One AdamW step of the reduced hash-routed Qwen3 (grad_accum 2, an
    active clip, int8 compression) on the card against the CPU: every state
    leaf and metric within 1e-4 of max(1, |CPU|); the forward launched
    lookup_router once per MoE layer and microbatch."""
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="hash",
                                                           router_hash_engine=engine))
    params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, size=(4, 17)))
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    hp = TrainHparams(grad_accum=2, clip_norm=0.05, compression="int8")
    kernels = BULK_ENGINES[engine].kernels
    out = {}
    for dev in (cuda, torch.device("cpu")):
        opt = make_optimizer("adamw", lr=1e-3, warmup=0, total=10)
        state = make_train_state(tree_map(lambda t: t.to(dev, copy=True), params), opt, hp)
        kernels.reset_launches()
        out[dev.type] = make_train_step(cfg, opt, hp)(state, {k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            n_moe = sum(k == "attn_moe" for k in cfg.layer_kinds())
            assert kernels.launches["lookup_vec"] == n_moe * hp.grad_accum
    (got, gm), (want, wm) = out["cuda"], out["cpu"]
    for k in wm:
        np.testing.assert_allclose(gm[k].cpu().numpy(), wm[k].numpy(), atol=1e-4, rtol=1e-4)
    # int8 rounds each element to a level of its leaf's quantum (max|g|/127,
    # at least twice the largest residual): where the two devices' gradients
    # straddle a rounding boundary, one element's level differs by one, its
    # residual by a quantum (more than half the largest residual), and
    # Adam's first step, near lr * sign(g), may move that element by up to
    # the learning rate more or less; every other element within 1e-4
    pairs = [(k, a.cpu().double(), b.double()) for (k, a), (_, b) in
             zip(flatten_with_path(got), flatten_with_path(want))]
    flipped = {}
    for key, a, b in pairs:
        if key.startswith("['comp_err']"):
            d, top = (a - b).abs(), float(b.abs().max())
            off = d > top / 2
            assert int(off.sum()) <= max(1, b.numel() // 1000), key
            assert float(d.max()) <= 2 * top * (1 + 1e-3) + 1e-4, key
            flipped[key.removeprefix("['comp_err']")] = off
    for key, a, b in pairs:
        path = next((key.removeprefix(p) for p in ("['comp_err']", "['params']", "['opt']['m']",
                                                   "['opt']['v']", "['opt']['master']")
                     if key.startswith(p)), None)
        off = flipped.get(path, torch.zeros(b.shape, dtype=torch.bool))
        d = (a - b).abs()
        assert float(torch.where(off, 0.0, d).max()) <= 1e-4 * max(1.0, float(b.abs().max())), key
        assert float(torch.where(off, d, 0.0).max()) <= 10 * 1e-3, key


def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A bf16 train state on the card saved and restored onto the card:
    every leaf bit for bit, dtype and device kept."""
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_train_state
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(reduced_config("deepseek-v3-671b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = M.init_train_params(torch.Generator(cuda).manual_seed(0), cfg)
    state = make_train_state(params, make_optimizer("adamw"))
    mgr = CheckpointManager(str(tmp_path), n_nodes=3)
    mgr.save(2, state)
    back = mgr.restore(mgr.latest_step(), state)
    n_bf16 = 0
    for (key, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(state)):
        assert a.dtype == b.dtype and a.device == b.device, key
        if a.dtype == torch.bfloat16:
            n_bf16 += 1
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key
    assert n_bf16 > 0


def test_certifier_on_card(cuda):
    """Every graph target of both engines on the card: the ``/cuda`` ones
    flat in ω with one launch of their kernel, the composite paths through
    the kernels, none skipped, the chain baseline waived."""
    from repro_torch.analysis.certify import certify_all
    from repro_torch.analysis.report import PASS, SKIPPED, WAIVED

    report = certify_all(device="cuda")
    assert report.ok, report.render()
    for t in report.targets:
        statuses = {c.status for c in t.checks}
        if t.target == "chain/memento_remap":
            assert statuses == {PASS, WAIVED, SKIPPED}  # unroll-affine: not ω-parameterised
        else:
            assert statuses == {PASS}, (t.engine, t.target, t.to_dict())
        if t.target.endswith("/cuda"):
            (affine,) = [c for c in t.checks if c.invariant == "unroll-affine"]
            assert "flat" in affine.detail and "launches per call" in affine.detail


def test_sass_gate_on_card(cuda):
    """The SASS gate on the built library: every back edge of every kernel
    function a tagged loop or the compiler's own, healthy and storm fleets
    flat (launches and launched shapes too), each function within its
    budget, the chain remap's walk waived."""
    from repro_torch.analysis.report import PASS, WAIVED
    from repro_torch.analysis.sass_gate import FUNCTIONS, gate_all, library_sass, loop_table

    gates = {g.engine: g for g in gate_all(device="cuda")}
    for engine in ("binomial", "jump"):
        assert {c.status for c in gates[engine].checks} == {PASS}, gates[engine].to_dict()
        assert gates[engine].op_count > 0
    chain = {c.invariant: c.status for c in gates["chain"].checks}
    assert chain == {"sass-loops-declared": WAIVED, "sass-op-budget": PASS}
    table = loop_table(list(FUNCTIONS))
    assert all(not fl.undeclared and fl.loops for fl in table.values())
    sizes = {name: fn.size for name, fn in library_sass().items()}
    for (engine, kind), prefix in FUNCTIONS.items():
        (size,) = [n for name, n in sizes.items() if name.startswith(prefix)]
        assert table[f"{kind}[{engine}]"].size == size


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_launch_log_reads_the_launched_shapes(cuda, engine):
    """The library's launch log gives the (grid, items) of each launch a
    call made, in order, and is emptied by the read: a monitored route's one
    launch at the grid ``routing_route_load_grid`` reckons, and the chain
    path's two, the remap's at ``routing_chain_grid``'s."""
    from repro_torch.analysis.sass_gate import clear_launches, fleet_of, take_launches
    from repro_torch.kernels import build

    n, capacity, keys = 1000, 1024, _u32(7, 1 << 20, cuda)
    spec = RouterSpec(engine, capacity, 16)
    fleet = fleet_of(engine, n, capacity, range(1, 500, 2), cuda)
    chain = fleet_of(engine, n, capacity, range(1, 500, 2), cuda, chain=True)
    counts = torch.zeros(capacity, dtype=torch.int32, device=cuda)
    clear_launches()
    ops.route_load_bulk(keys, fleet, counts, spec)
    ((grid, items),) = take_launches()
    assert grid == _load_grid(engine, keys.numel(), capacity) and 1 <= items
    assert take_launches() == []
    ops.route_chain_bulk(keys, chain, spec)
    shapes = take_launches()
    assert len(shapes) == 2
    assert shapes[1][0] == build.library().routing_chain_grid(keys.numel())
