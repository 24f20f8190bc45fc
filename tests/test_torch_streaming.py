"""The port's streaming front end (``repro_torch.serving.streaming``) against
the JAX package's, on the CPU, tolerance 0.  Each case of the reference's
``tests/test_streaming.py`` runs through both packages on the same scripted
``VirtualClockUs`` timeline, with an injected service model: batch close,
the one-deep overlap, the deadline-miss bound, token buckets, typed sheds,
``LifecycleDispatch`` routing only alive slots and ticking repairs, hedged
reads and breakers, and the backwards-clock errors.  Every ``StreamResult``
is compared field by field, and so are ``stats()`` and the registries'
JSON bytes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.observability as RO  # noqa: E402
import repro.serving.lifecycle as RL  # noqa: E402
import repro.serving.streaming as RS  # noqa: E402
from repro.placement.store import StorePlacement as RefStore  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
import repro_torch.observability as PO  # noqa: E402
import repro_torch.serving.lifecycle as PL  # noqa: E402
import repro_torch.serving.streaming as PS  # noqa: E402
from repro_torch.placement.store import StorePlacement  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402


class Side:
    """One package's streaming tier, lifecycle, placement and router."""

    def __init__(self, obs, lifecycle, streaming, store, router):
        self.obs, self.L, self.S, self.Store, self._router = obs, lifecycle, streaming, store, router

    def router(self, n, **kw):
        return self._router(n, **kw)


REF = Side(RO, RL, RS, RefStore, RefRouter)
PORT = Side(PO, PL, PS, StorePlacement, lambda n, **kw: BatchRouter(n, device="cpu", **kw))


def both(fn):
    """``fn(side)`` for the reference and the port; the answers must agree
    (``StreamResult``s field by field).  Returns the reference's."""
    want, got = fn(REF), fn(PORT)
    assert plain(got) == plain(want)
    return want


def plain(x):
    if hasattr(x, "t_complete_us"):  # a StreamResult
        q = x.request
        return ("result", q.key, q.deadline_us, q.tenant, q.arrival_us, x.replica,
                x.t_dispatch_us, x.t_complete_us, x.epoch, x.mode, x.latency_us,
                x.deadline_miss_us)
    if hasattr(x, "hedged"):  # a HedgedRead
        return ("read", x.key_index, x.shard, x.mode, x.hedged, x.latency_us, list(x.holders))
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x), {k: v for k, v in vars(x).items()})
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def submit(side, b, **kw):
    """Submit a request; returns None or the typed shed."""
    try:
        b.submit(side.S.StreamRequest(**kw))
    except side.L.AdmissionRejectedError as e:
        return e
    return None


class _EchoHandle:
    def __init__(self, reps):
        self._reps = reps

    def result(self):
        return self._reps, 0, "normal"


def _echo_dispatch(keys_u32):
    """Dispatch stub: replica = key % 4 (deterministic, device-free)."""
    return _EchoHandle(np.asarray(keys_u32, np.int64) % 4)


def _batcher(side, service_us=500, **cfg):
    clock = side.S.VirtualClockUs()
    config = side.S.StreamConfig(**{
        "max_batch": 8, "max_wait_us": 1_000, "service_bound_us": 1_000, **cfg})
    b = side.S.MicroBatcher(_echo_dispatch, config=config, clock=clock,
                            service_model=lambda n: service_us)
    return b, clock


def _state(side, b):
    return (b.dispatches, b.served, b.open_depth, b.inflight_depth, b.service_ewma_us,
            b.admission.admitted, b.admission.shed_by_reason, b.admission.shed_by_tenant,
            side.obs.to_json(b.metrics))


# ---------------------------------------------------------------------------
# micro-batcher core
# ---------------------------------------------------------------------------


def test_batch_closes_at_max_batch_and_window():
    def run(side):
        b, clock = _batcher(side, max_batch=4)
        for _ in range(4):
            submit(side, b, key=7, deadline_us=clock.now_us() + 10_000)
        assert b.dispatches == 1
        submit(side, b, key=7, deadline_us=clock.now_us() + 10_000)
        clock.advance_us(1_001)
        out = b.pump()
        assert b.dispatches == 2
        clock.advance_us(10_000)
        out += b.pump() + b.drain()
        assert len(out) == 5 and all(r.deadline_miss_us == 0 for r in out)
        return out, _state(side, b)

    both(run)


def test_results_carry_routing_and_timing():
    def run(side):
        b, clock = _batcher(side, max_batch=2, service_us=400)
        submit(side, b, key=9, deadline_us=clock.now_us() + 5_000)
        submit(side, b, key=10, deadline_us=clock.now_us() + 5_000)
        clock.advance_us(400)
        out = b.pump()
        assert [r.replica for r in out] == [1, 2] and out[0].latency_us == 400
        return out

    both(run)


def test_pipeline_overlaps_one_deep():
    def run(side):
        b, clock = _batcher(side, max_batch=2, service_us=2_000)
        seen = []
        for _ in range(3):
            submit(side, b, key=7, deadline_us=clock.now_us() + 10_000)
            seen.append((b.open_depth, b.inflight_depth, b.dispatch_eta_us(clock.now_us())))
        for dt in (500, 600, 1_000):
            clock.advance_us(dt)
            seen.append((b.pump(), b.dispatches, b.open_depth))
        assert seen[-2][1:] == (1, 1) and seen[-1][1] == 2
        return seen, _state(side, b)

    both(run)


def test_deadline_miss_bounded_by_one_window_under_backlog():
    keys = np.random.default_rng(3).integers(1 << 32, size=300)

    def run(side):
        b, clock = _batcher(side, max_batch=4, service_us=900, service_bound_us=1_000)
        served, sheds = [], []
        for k in keys:
            sheds.append(submit(side, b, key=int(k), deadline_us=clock.now_us() + 2_500))
            clock.advance_us(60)
            served.extend(b.pump())
        served.extend(b.drain())
        assert served and max(r.deadline_miss_us for r in served) <= 1_000
        assert b.admission.shed_total > 0
        return served, sheds, _state(side, b)

    both(run)


# ---------------------------------------------------------------------------
# degenerate edges and admission
# ---------------------------------------------------------------------------


def test_zero_request_batch_window_is_noop():
    def run(side):
        b, clock = _batcher(side)
        for _ in range(5):
            clock.advance_us(2_000)
            assert b.pump() == []
        assert b.drain() == [] and (b.dispatches, b.served) == (0, 0)
        return _state(side, b)

    both(run)


def test_max_batch_one_dispatches_every_submit():
    def run(side):
        b, clock = _batcher(side, max_batch=1, service_us=100)
        for i in range(3):
            submit(side, b, key=i, deadline_us=clock.now_us() + 10_000)
            clock.advance_us(150)
        out = b.pump() + b.drain()
        assert [r.request.key for r in out] == [0, 1, 2] and b.dispatches == 3
        return out

    both(run)


def test_all_requests_past_deadline_on_arrival():
    def run(side):
        b, clock = _batcher(side)
        clock.advance_us(5_000)
        sheds = [submit(side, b, key=1, deadline_us=clock.now_us() - 1) for _ in range(4)]
        assert all(e.reason == side.L.SHED_PAST_DEADLINE for e in sheds)
        assert b.dispatches == 0
        return sheds, _state(side, b)

    both(run)


def test_single_tenant_bucket_exhaustion():
    def run(side):
        b, clock = _batcher(side, max_batch=64, tenant_rate_per_s=10.0, tenant_burst=2.0)
        sheds = [submit(side, b, key=7, deadline_us=clock.now_us() + 10_000, tenant="hog")
                 for _ in range(5)]
        assert [e is None for e in sheds] == [True, True, False, False, False]
        sheds.append(submit(side, b, key=7, deadline_us=clock.now_us() + 10_000, tenant="quiet"))
        clock.advance_us(150_000)
        sheds.append(submit(side, b, key=7, deadline_us=clock.now_us() + 10_000, tenant="hog"))
        assert sheds[-2:] == [None, None]
        return sheds, _state(side, b)

    both(run)


def test_infeasible_deadline_shed_at_admission():
    def run(side):
        b, clock = _batcher(side, service_bound_us=2_000)
        e = submit(side, b, key=7, deadline_us=clock.now_us() + 500)
        assert e.reason == side.L.SHED_INFEASIBLE
        return e

    both(run)


def test_late_requests_shed_typed_at_batch_close():
    def run(side):
        b, clock = _batcher(side, max_batch=4, service_us=1_500, service_bound_us=1_500)
        submit(side, b, key=7, deadline_us=clock.now_us() + 1_700)
        clock.advance_us(1_300)
        assert b.pump() == [] and b.dispatches == 0
        assert b.admission.shed_by_reason[side.L.SHED_LATE] == 1
        return b.drain(), _state(side, b)

    both(run)


def test_token_bucket_refill_and_burst_cap():
    def run(side):
        tb = side.S.TokenBucket(rate_per_s=100.0, burst=5.0)
        takes = [tb.try_take(0) for _ in range(6)] + [tb.try_take(10_000), tb.try_take(10_001)]
        tb2 = side.S.TokenBucket(rate_per_s=100.0, burst=5.0)
        tb2.try_take(10_000_000)
        with pytest.raises(ValueError) as e:
            side.S.TokenBucket(rate_per_s=0, burst=1)
        return takes, tb.tokens, tb2.tokens, str(e.value)

    assert both(run)[0] == [True] * 5 + [False, True, False]


def test_configs_refuse_what_the_reference_refuses():
    def run(side):
        out = []
        for cls, kw in ((side.S.StreamConfig, dict(max_batch=0)),
                        (side.S.StreamConfig, dict(max_wait_us=-1)),
                        (side.S.StreamConfig, dict(service_bound_us=0)),
                        (side.S.StreamConfig, dict(hedge_after_us=-1)),
                        (side.S.AdmissionConfig, dict(service_bound_us=0)),
                        (side.S.BreakerConfig, dict(trip_after=0)),
                        (side.S.BreakerConfig, dict(cooldown_us=0))):
            with pytest.raises(ValueError) as e:
                cls(**kw)
            out.append(str(e.value))
        cfg = side.S.StreamConfig(tenant_rate_per_s=5.0)
        return out, vars(cfg.admission()), vars(side.S.BreakerConfig())

    both(run)


# ---------------------------------------------------------------------------
# the real dispatch path (lifecycle-wrapped router)
# ---------------------------------------------------------------------------


def test_lifecycle_dispatch_routes_alive_only_and_ticks_repairs():
    keys = np.random.default_rng(0).integers(0, 1 << 32, 256, np.uint32)
    stream = np.random.default_rng(1).integers(0, 1 << 32, 40)

    def run(side):
        clock = side.S.VirtualClockUs()
        router = side.router(6, engine="binomial")
        mgr = side.L.LifecycleManager(router, side.L.LifecycleConfig(min_alive_floor=1),
                                      clock=clock.seconds_view())
        store = side.Store(router, r=3)
        store.register(keys)
        side.L.PlacementRepairer(store, mgr, budget_per_tick=512)
        fe = side.S.StreamingFrontEnd(
            mgr, store=store,
            config=side.S.StreamConfig(max_batch=8, max_wait_us=500, service_bound_us=2_000),
            clock=clock, service_model=lambda n: 300)
        mgr.fail(2)
        backlog0 = mgr._placement.backlog
        served = []
        for k in stream:
            fe.submit(side.S.StreamRequest(key=int(k), deadline_us=clock.now_us() + 10_000))
            clock.advance_us(400)
            served.extend(fe.pump())
        served.extend(fe.drain())
        assert len(served) == 40 and {r.replica for r in served} <= set(range(6)) - {2}
        assert all(r.epoch == mgr.epoch for r in served)
        assert mgr._placement.backlog == 0 and (store.reachable_counts() == 3).all()
        return (backlog0, served, fe.stats(), store.holders,
                side.obs.to_json(fe.metrics, trace=fe.tracer), fe.tracer.count("lifecycle_tick"))

    both(run)


def test_front_end_with_a_load_monitor_counts_what_it_serves():
    """The front end over a monitored router: every dispatch is the
    instrumented launch, and the drained counts are the served replicas'."""
    stream = np.random.default_rng(2).integers(0, 1 << 32, 100)

    def run(side):
        clock = side.S.VirtualClockUs()
        router = side.router(10, engine="jump")
        mgr = side.L.LifecycleManager(router, clock=clock.seconds_view())
        reg = side.obs.MetricsRegistry(clock=clock)
        mon = side.obs.LoadMonitor(router, metrics=reg, config=side.obs.LoadConfig(drain_every=5))
        fe = side.S.StreamingFrontEnd(mgr, config=side.S.StreamConfig(max_batch=16),
                                      clock=clock, service_model=lambda n: 200, metrics=reg)
        served = []
        for k in stream:
            fe.submit(side.S.StreamRequest(key=int(k), deadline_us=clock.now_us() + 20_000,
                                           tenant=f"t{int(k) % 3}"))
            clock.advance_us(90)
            served.extend(fe.pump())
        served.extend(fe.drain())
        mon.drain()
        assert mon.total_keys == len(served) == 100
        np.testing.assert_array_equal(
            mon.totals, np.bincount([r.replica for r in served], minlength=router.capacity))
        return served, fe.stats(), side.obs.to_json(reg, trace=fe.tracer, monitor=mon)

    both(run)


def test_stream_on_the_cpu_takes_the_plain_path_without_pinning():
    router = BatchRouter(6, device="cpu")
    mgr = PL.LifecycleManager(router)
    dispatch = PS.LifecycleDispatch(mgr)
    handle = dispatch(np.array([1, 2, 3, 4], np.uint32))
    reps, epoch, mode = handle.result()
    assert reps.dtype == np.int64 and (epoch, mode) == (0, "normal")
    np.testing.assert_array_equal(reps, router.route_keys_np(np.array([1, 2, 3, 4], np.uint32)))
    assert dispatch._staging == [None, None]


# ---------------------------------------------------------------------------
# hedged reads + breakers
# ---------------------------------------------------------------------------


def _hedging_rig(side, r=3, n=6):
    clock = side.S.VirtualClockUs()
    router = side.router(n, engine="binomial")
    mgr = side.L.LifecycleManager(router, clock=clock.seconds_view())
    store = side.Store(router, r=r)
    store.register(np.random.default_rng(7).integers(0, 1 << 32, 64, np.uint32))
    return clock, router, mgr, store


def test_suspect_primary_hedges_to_next_holder():
    def run(side):
        clock, router, mgr, store = _hedging_rig(side)
        primary = int(store.holders[0, 0])
        board = side.S.BreakerBoard(mgr.detector, clock)
        reader = side.S.HedgedReader(store, mgr.detector, board, hedge_after_us=300,
                                     probe=lambda s: 900 if s == primary else 120)
        healthy = reader.read(0)
        for s in mgr.detector.slots:
            if s != primary:
                mgr.heartbeat(s)
        clock.advance_us(4_000_000)
        mgr.tick()
        assert mgr.detector.state_of(primary) == side.L.SUSPECT
        out = reader.read(0)
        assert out.hedged and out.shard != primary and out.latency_us == 420
        return healthy, out, reader.reads, reader.hedge_launched, reader.hedge_won

    both(run)


def test_breaker_trips_on_flaps_and_reroutes_before_removal():
    def run(side):
        clock, router, mgr, store = _hedging_rig(side)
        primary = int(store.holders[0, 0])
        board = side.S.BreakerBoard(mgr.detector, clock, side.S.BreakerConfig(
            trip_after=3, window_us=60_000_000, cooldown_us=5_000_000))
        reader = side.S.HedgedReader(store, mgr.detector, board, hedge_after_us=300,
                                     probe=lambda s: 120)
        for _ in range(3):
            for s in mgr.detector.slots:
                if s != primary:
                    mgr.heartbeat(s)
            clock.advance_us(4_000_000)
            mgr.tick()
            board.observe()
            mgr.heartbeat(primary)
            mgr.tick()
            board.observe()
        assert board.trips == 1 and board.is_open(primary)
        out = reader.read(0)
        assert out.shard != primary
        opened = board.open_slots
        clock.advance_us(5_000_001)
        assert not board.is_open(primary)
        return out, opened, reader.read(0), board.trips, side.obs.to_json(board.metrics)

    both(run)


def test_front_end_read_needs_a_store():
    def run(side):
        clock = side.S.VirtualClockUs()
        mgr = side.L.LifecycleManager(side.router(4), clock=clock.seconds_view())
        fe = side.S.StreamingFrontEnd(mgr, clock=clock)
        with pytest.raises(RuntimeError) as e:
            fe.read(0)
        assert mgr.tracer is fe.tracer
        return str(e.value), fe.stats()

    both(run)


# ---------------------------------------------------------------------------
# the clocks
# ---------------------------------------------------------------------------


class _Warpable:
    def __init__(self, t=100.0):
        self.t = t

    def now(self):
        return self.t


def test_backwards_clock_is_typed_error():
    def run(side):
        clk = _Warpable()
        det = side.L.FailureDetector([0, 1, 2], side.L.HeartbeatConfig(), clk)
        clk.t = 101.0
        det.heartbeat(0)
        det.poll()
        clk.t = 42.0
        errs = []
        for fn in (det.poll, lambda: det.heartbeat(1), lambda: det.register(9)):
            with pytest.raises(side.L.ClockWentBackwardsError) as e:
                fn()
            errs.append(e.value)
        clk.t = 102.0
        det.heartbeat(1)
        return errs, det.poll()

    both(run)


def test_virtual_clock_rejects_negative_advance():
    def run(side):
        clock = side.S.VirtualClockUs(5)
        with pytest.raises(ValueError, match="backwards") as e:
            clock.advance_us(-1)
        wall = side.S.WallClockUs().now_us()
        assert isinstance(wall, int) and wall > 0
        return str(e.value), clock.now_us(), clock.seconds_view().now()

    both(run)
