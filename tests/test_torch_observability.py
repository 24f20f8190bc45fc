"""The port's observability tier (``repro_torch.observability``) against the
JAX package's, on the CPU, tolerance 0: the registry's semantics on
``VirtualClockUs``, the instrumented route's replica ids and counts against
``repro.kernels.ops.route_load_bulk`` (sample shifts 0, 3 and 6, both sides
of the reference's one-hot/scatter switch at 2^17 sampled keys, capacities
64, 1024 and 65,536, an accumulator that wraps past 2^32), the load
monitor's drain protocol, the envelopes and alarms, the live disruption
tracker, and the JSON and Prometheus bytes under one scripted virtual
timeline.  Each case runs the reference's test through both packages on the
same inputs and compares what they answer."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.observability as RO  # noqa: E402
import repro.serving.streaming as RS  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.observability.load import _ONEHOT_MAX  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
import repro_torch.observability as PO  # noqa: E402
import repro_torch.serving.streaming as PS  # noqa: E402
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402

ENGINES = ("binomial", "jump")


class Side:
    """One package's observability tier and router."""

    def __init__(self, obs, streaming, router):
        self.obs, self.streaming, self._router = obs, streaming, router

    def router(self, n, **kw):
        return self._router(n, **kw)


REF = Side(RO, RS, RefRouter)
PORT = Side(PO, PS, lambda n, **kw: BatchRouter(n, device="cpu", **kw))
SIDES = (REF, PORT)


def both(fn):
    """Run ``fn(side)`` for the reference and the port; their answers must
    agree.  Returns the reference's."""
    want, got = (fn(side) for side in SIDES)
    assert _plain(got) == _plain(want)
    return want


def _plain(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().tolist()
    if isinstance(x, (np.ndarray, jax.Array)):
        return np.asarray(x).tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def _raises(fn, exc=ValueError):
    """The message ``fn`` raises with."""
    with pytest.raises(exc) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    def run(side):
        clock = side.streaming.VirtualClockUs()
        reg = side.obs.MetricsRegistry(clock=clock)
        c = reg.counter("reqs_total", tenant="a")
        c.inc()
        c.inc(4)
        clock.advance_us(10)
        g = reg.gauge("depth")
        g.set(7)
        h = reg.histogram("lat_us", bounds=(10, 100))
        for v in (5, 50, 500):
            h.observe(v)
        assert (c.value, g.value, h.count, h.sum, h.bucket_counts) == (5, 7, 3, 555, [1, 1, 1])
        assert h.mean == pytest.approx(185.0)
        assert reg.counter("reqs_total", tenant="a") is c
        assert reg.counter("reqs_total", tenant="b") is not c
        return side.obs.to_json(reg), side.obs.to_prometheus(reg)

    both(run)


def test_counter_rejects_negative_and_kind_is_pinned():
    def run(side):
        reg = side.obs.MetricsRegistry()
        reg.counter("x_total").inc()
        return (_raises(lambda: reg.counter("x_total").inc(-1)),
                _raises(lambda: reg.gauge("x_total")))

    both(run)


def test_histogram_bounds_pinned_at_first_creation():
    def run(side):
        reg = side.obs.MetricsRegistry()
        h = reg.histogram("lat", bounds=(1, 2))
        assert reg.histogram("lat") is h
        return (_raises(lambda: reg.histogram("lat", bounds=(1, 2, 3))),
                _raises(lambda: reg.histogram("bad", bounds=(2, 1))), h.bounds)

    both(run)


def test_family_and_total_aggregate_views():
    def run(side):
        reg = side.obs.MetricsRegistry()
        reg.counter("shed_total", tenant="a", reason="late").inc(2)
        reg.counter("shed_total", tenant="b", reason="late").inc(3)
        reg.counter("shed_total", tenant="a", reason="rate").inc(5)
        return (reg.total("shed_total"), reg.total("shed_total", tenant="a"),
                reg.total("shed_total", reason="late"), sorted(reg.family("shed_total")),
                reg.total("never_seen"))

    assert both(run)[:3] == (10, 7, 5)


def test_registry_timestamps_come_from_the_injected_clock():
    def run(side):
        clock = side.streaming.VirtualClockUs()
        reg = side.obs.MetricsRegistry(clock=clock)
        c = reg.counter("ticks_total")
        clock.advance_us(123)
        c.inc()
        view = clock.seconds_view()
        return (c.last_update_us, view.now(), _raises(lambda: clock.advance_us(-1)),
                side.streaming.US_PER_S)

    assert both(run)[0] == 123


def test_span_trace_ring_and_monotone_counts():
    def run(side):
        t = side.obs.SpanTrace(capacity=4)
        for i in range(10):
            t.record("request", i, i + 1, tenant="a", replica=i % 3)
        t.record("admit", 100, 100)
        return (t.count("request"), t.count("admit"), t.count(), t.dropped,
                [(s.name, s.t_start_us, s.t_end_us, s.tenant, s.tags) for s in t.spans()])

    assert both(run)[:4] == (10, 1, 11, 7)


# ---------------------------------------------------------------------------
# the instrumented route
# ---------------------------------------------------------------------------


def _fleet_pair(engine, capacity, seed):
    """A reference and a port router over the same fleet, a quarter of its
    replicas failed."""
    n = min(capacity * 3 // 4, 3000)
    rr = RefRouter(n, engine=engine, capacity=capacity)
    pr = BatchRouter(n, engine=engine, capacity=capacity, device="cpu")
    victims = np.random.default_rng(seed).choice(n - 1, size=n // 4, replace=False)
    with rr.coalesced_events(), pr.coalesced_events():
        for s in victims:
            rr.fail(int(s)), pr.fail(int(s))
    rr._check_routable(), pr._check_routable()
    return rr, pr


def _near_wrap(rng, capacity):
    """A u32 accumulator whose every bin starts within 2^10 of 2^32."""
    return (np.uint64(1 << 32) - rng.integers(1, 1 << 10, capacity).astype(np.uint64)).astype(np.uint32)


#: (capacity, sample shift): every shift at 64 and 1024 slots; at 65,536
#: slots the reference's route takes ~30 s to compile per shift, so the
#: default sampled shift only (``test_count_on_both_sides_of_the_onehot_switch``
#: covers the count at that capacity)
LOAD_CASES = [(64, 0), (64, 3), (64, 6), (1024, 0), (1024, 3), (1024, 6), (65536, 6)]


@pytest.mark.parametrize("capacity,shift", LOAD_CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_route_load_matches_reference_ops(engine, capacity, shift):
    """``ops.route_load_bulk`` against the reference's on the same fleet,
    keys and starting accumulator: replica ids and counts bit-exact, the
    counts wrapping past 2^32; the ids equal the bare route's."""
    rng = np.random.default_rng(capacity + shift)
    rr, pr = _fleet_pair(engine, capacity, capacity)
    n_keys = 2048 if capacity > 1024 else 4096
    keys = rng.integers(0, 1 << 32, n_keys, dtype=np.uint32)
    start = _near_wrap(rng, capacity)
    want, want_counts = ref_ops.route_load_bulk(keys, rr._fleet_dev, jnp.asarray(start), rr.spec,
                                                sample_shift=shift)
    tkeys = torch.from_numpy(keys.view(np.int32))
    counts = torch.from_numpy(start.view(np.int32).copy())
    got, got_counts = ops.route_load_bulk(tkeys, pr._fleet_dev, counts, pr.spec, sample_shift=shift)
    assert got_counts is counts  # advanced in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_counts.numpy().view(np.uint32), np.asarray(want_counts))
    assert torch.equal(got, ops.route_bulk(tkeys, pr._fleet_dev, pr.spec))
    assert (got_counts.numpy().view(np.uint32) < start).any()  # some bin wrapped


def _identity_route(keys, *args, **kw):
    """A "route" giving each key back as its replica, so that the count alone
    is under test at any size."""
    if isinstance(keys, torch.Tensor):
        return keys.to(torch.int32)
    return keys.astype(jnp.int32)


@functools.cache
def _ref_count(sample_shift):
    return jax.jit(functools.partial(RO.route_with_load_impl, omega=16, n_words=1,
                                     route=_identity_route, sample_shift=sample_shift))


@pytest.mark.parametrize("capacity,shift,extra", [
    (capacity, shift, extra) for capacity in (64, 1024) for shift in (0, 3, 6) for extra in (0, 1)
] + [(65536, 0, 1), (65536, 3, 1)])
def test_count_on_both_sides_of_the_onehot_switch(capacity, shift, extra):
    """The reference counts ``_ONEHOT_MAX`` sampled replicas by a one-hot
    sum and one more by a scatter (``extra`` = 1); the plain version gives
    the same integers on both sides, from an accumulator near 2^32.  (At
    65,536 slots the one-hot side would hold 2^33 comparisons: scatter
    only.)"""
    sampled = _ONEHOT_MAX + extra
    n = (sampled - 1) * (1 << shift) + 1  # exactly `sampled` stride samples
    rng = np.random.default_rng(shift * 2 + extra)
    replicas = rng.integers(0, capacity, n, dtype=np.uint32)
    start = _near_wrap(rng, capacity)
    none = jnp.zeros(1, jnp.int32)
    _, want = _ref_count(shift)(jnp.asarray(replicas), none, none, none, jnp.asarray(start))
    counts = torch.from_numpy(start.view(np.int32).copy())
    z = torch.zeros(1, dtype=torch.int32)
    reps, got = PO.route_with_load_impl(torch.from_numpy(replicas.view(np.int32)), z, z, z, counts,
                                        omega=16, route=_identity_route, sample_shift=shift)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert torch.equal(counts, torch.from_numpy(start.view(np.int32)))  # not modified
    want_hist = np.bincount(replicas[:: 1 << shift], minlength=capacity).astype(np.uint64) << np.uint64(shift)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ((start.astype(np.uint64) + want_hist) & 0xFFFFFFFF).astype(np.uint32))


def test_route_load_refuses_what_it_does_not_take():
    """Shifts past u32 and an accumulator of another length than the
    fleet's capacity."""
    k = BULK_ENGINES["binomial"].kernels
    z = torch.zeros(4, dtype=torch.int32)
    for bad in (-1, 32):
        with pytest.raises(ValueError, match="sample_shift"):
            k.route_load(z, z, z, z[:2], z, sample_shift=bad)
    with pytest.raises(ValueError, match="capacity"):
        k.route_load(z, z, z, z[:2], z[:3])
    assert k.launches["route_load"] == 0


# ---------------------------------------------------------------------------
# the load monitor: drains, cadence, detach, sampling
# ---------------------------------------------------------------------------


def _monitored(side, engine, n, config, capacity=None, **kw):
    router = side.router(n, engine=engine, **({} if capacity is None else {"capacity": capacity}))
    return router, side.obs.LoadMonitor(router, config=config, **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_instrumented_route_bit_exact_and_bincount_parity(engine):
    keys = np.random.default_rng(7).integers(0, 1 << 32, size=4096, dtype=np.uint32)

    def run(side):
        plain = side.router(12, engine=engine, capacity=64)
        router, mon = _monitored(side, engine, 12, side.obs.LoadConfig(drain_every=1 << 30),
                                 capacity=64)
        for r in (plain, router):
            r.fail(3)
            r.fail(7)
        expect = np.asarray(plain.route_keys_np(keys))
        got = np.asarray(router.route_keys_np(keys))
        np.testing.assert_array_equal(got, expect)
        window = mon.drain()
        assert window.dtype == np.uint32
        np.testing.assert_array_equal(window, np.bincount(expect, minlength=64).astype(np.uint32))
        assert mon.total_keys == keys.size and mon.totals.dtype == np.uint64
        return got, window, mon.totals

    both(run)


@pytest.mark.parametrize("engine", ENGINES)
def test_drain_cadence_and_zero_upload_reset(engine):
    """Three batches drain once; the drain copies the window to the host and
    zeroes the accumulator in place (the same tensor, the same storage: no
    new tensor is made or uploaded), as the reference's reset re-points at
    its pinned zeros without an upload."""
    keys = np.arange(256, dtype=np.uint32)

    def run(side):
        reg = side.obs.MetricsRegistry(clock=side.streaming.VirtualClockUs())
        router, mon = _monitored(side, engine, 8, side.obs.LoadConfig(drain_every=3), metrics=reg)
        acc = mon.counts_dev
        for _ in range(2):
            router.route_keys(keys)
        assert mon.drains == 0
        router.route_keys(keys)
        out = (mon.drains, mon.total_keys, mon.metrics.total("load_keys_total"),
               mon.metrics.gauge("load_peak_over_mean").value, mon.totals.tolist(),
               side.obs.to_json(mon.metrics))
        assert out[:3] == (1, 3 * keys.size, 3 * keys.size) and out[3] >= 1.0
        assert int(np.asarray(mon.counts_dev).sum()) == 0
        if side is PORT:
            assert mon.counts_dev is acc and mon.counts_dev.data_ptr() == acc.data_ptr()
        mon.reset()
        assert mon.total_keys == 0 and not mon.totals.any()
        if side is PORT:
            assert mon.counts_dev is acc and not acc.any()
        router.route_keys(keys[:10])
        return out, mon.drain().tolist()

    both(run)


def test_detach_restores_uninstrumented_dispatch():
    keys = np.arange(128, dtype=np.uint32)

    def run(side):
        router, mon = _monitored(side, "binomial", 8, side.obs.LoadConfig(drain_every=1 << 30))
        router.route_keys(keys)
        mon.detach()
        router.route_keys(keys)
        mon.drain()
        return mon.total_keys

    assert both(run) == keys.size
    router = BatchRouter(8, device="cpu")
    mon = PO.LoadMonitor(router)
    k = BULK_ENGINES["binomial"].kernels
    mon.detach()
    assert router._load_monitor is None and k.launches["route_load"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_sampled_accumulate_is_scaled_stride_bincount(engine):
    rng = np.random.default_rng(11)
    bulk = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
    small = rng.integers(0, 1 << 32, size=512, dtype=np.uint32)

    def run(side):
        plain = side.router(12, engine=engine)
        router, mon = _monitored(side, engine, 12, side.obs.LoadConfig(
            drain_every=1 << 30, exact_cutoff=1024, sample_shift=3))
        cap = router.capacity
        expect_bulk = np.asarray(plain.route_keys_np(bulk))
        expect_small = np.asarray(plain.route_keys_np(small))
        np.testing.assert_array_equal(np.asarray(router.route_keys_np(bulk)), expect_bulk)
        np.testing.assert_array_equal(np.asarray(router.route_keys_np(small)), expect_small)
        window = mon.drain().astype(np.int64)
        scaled = np.bincount(expect_bulk[::8], minlength=cap) * 8
        exact = np.bincount(expect_small, minlength=cap)
        np.testing.assert_array_equal(window, scaled + exact)
        assert int(window.sum()) == bulk.size + small.size
        return window

    both(run)


def test_effective_shift_honors_exact_cutoff():
    def run(side):
        _, mon = _monitored(side, "binomial", 8, side.obs.LoadConfig(exact_cutoff=1 << 15,
                                                                        sample_shift=6))
        out = [mon.effective_shift(n) for n in (0, 1 << 15, (1 << 15) + 1, 1 << 24)]
        mon.detach()
        return out

    assert both(run) == [0, 0, 6, 6]


def test_load_config_defaults_and_refusals():
    bad = (dict(sample_shift=-1), dict(exact_cutoff=-1), dict(drain_every=0),
           dict(balance_mult=0), dict(disruption_slack=-1.0), dict(n_probe=0))
    both(lambda side: [_raises(lambda kw=kw: side.obs.LoadConfig(**kw)) for kw in bad])
    assert both(lambda side: vars(side.obs.LoadConfig())) == vars(RO.LoadConfig())


def test_attach_rejects_two_pass_baseline():
    both(lambda side: _raises(lambda: side.obs.LoadMonitor(
        side.router(8, engine="binomial", fused=False))))


def test_probe_set_and_metrics_names_match_reference():
    def run(side):
        _, mon = _monitored(side, "jump", 16, side.obs.LoadConfig(n_probe=64, probe_seed=5))
        return mon.tracker._probe_host

    both(run)


# ---------------------------------------------------------------------------
# theory-bound alarms
# ---------------------------------------------------------------------------


def test_envelope_helpers():
    def run(side):
        o = side.obs
        return ([o.expected_peak_over_mean(m, n) for m in (0, 1, 100, 1 << 20) for n in (0, 1, 8, 64)],
                [o.disruption_bound(d, a, b, s) for d in (0, 1, 100) for a, b in ((16, 16), (4, 4), (0, 0))
                 for s in (0.5, 2.0)])

    env, bounds = both(run)
    assert env[-1] > 1.0 and bounds[0] == 0.0 and bounds[-1] == 1.0


def _alarm_fields(a):
    return type(a).__name__, str(a), {k: v for k, v in vars(a).items() if not k.startswith("_")}


def test_balance_alarm_fires_on_skew_and_holds_on_uniform():
    def run(side):
        alarms = []
        _, mon = _monitored(side, "binomial", 8, side.obs.LoadConfig(drain_every=1 << 30,
                                                                        min_alarm_keys=100),
                            on_alarm=alarms.append)
        alive = mon._alive_slots()
        mon.totals[alive] = 1_000
        mon._check_balance(mon.peak_over_mean(alive), alive)
        assert alarms == []
        mon.totals[:] = 0
        mon.totals[alive[0]] = 8_000
        ratio = mon.peak_over_mean(alive)
        assert ratio == pytest.approx(len(alive))
        mon._check_balance(ratio, alive)
        (alarm,) = alarms
        assert isinstance(alarm, side.obs.BalanceDriftAlarm)
        assert alarm.peak_over_mean > alarm.threshold > alarm.expected
        return _alarm_fields(alarm), mon.metrics.total("balance_alarms_total")

    assert both(run)[1] == 1


def test_balance_alarm_raises_without_callback():
    def run(side):
        _, mon = _monitored(side, "binomial", 4, side.obs.LoadConfig(drain_every=1 << 30,
                                                                        min_alarm_keys=1))
        alive = mon._alive_slots()
        mon.totals[alive[0]] = 5_000
        with pytest.raises(side.obs.BalanceDriftAlarm, match="peak/mean") as e:
            mon._check_balance(mon.peak_over_mean(alive), alive)
        return _alarm_fields(e.value)

    both(run)


def test_disruption_alarm_fires_on_seeded_pathological_remap():
    def run(side):
        alarms = []
        _, mon = _monitored(side, "binomial", 16, side.obs.LoadConfig(drain_every=1 << 30,
                                                                         n_probe=256),
                            on_alarm=alarms.append)
        prev = np.zeros(256, np.int32)
        moved = mon.tracker.observe(prev, prev + 1, 1, 16, 16, epoch=9)
        (alarm,) = alarms
        assert isinstance(alarm, side.obs.DisruptionBoundAlarm) and alarm.epoch == 9
        now = prev.copy()
        now[:16] = 1
        mon.tracker.observe(prev, now, 1, 16, 16)
        assert len(alarms) == 1
        return (moved, _alarm_fields(alarm), mon.metrics.gauge("load_moved_fraction").value,
                mon.metrics.total("disruption_alarms_total"))

    assert both(run)[0] == 1.0


def test_alarm_delivery_raises_without_callback():
    def run(side):
        a = side.obs.DisruptionBoundAlarm(0.5, 0.25, delta_events=1, n_before=8, n_after=7)
        seen = []
        side.obs.deliver(a, seen.append)
        assert seen == [a] and isinstance(a, side.obs.ObservabilityAlarm)
        return _raises(lambda: side.obs.deliver(a, None), side.obs.DisruptionBoundAlarm)

    both(run)


@pytest.mark.parametrize("engine", ENGINES)
def test_live_tracker_stays_inside_bound_on_single_fail(engine):
    keys = np.arange(64, dtype=np.uint32)

    def run(side):
        alarms = []
        reg = side.obs.MetricsRegistry(clock=side.streaming.VirtualClockUs())
        router, mon = _monitored(side, engine, 16, side.obs.LoadConfig(drain_every=1 << 30),
                                 on_alarm=alarms.append, metrics=reg)
        router.route_keys(keys)
        mon.drain()
        router.fail(5)
        router.route_keys(keys)
        mon.drain()
        assert alarms == []
        frac = mon.metrics.gauge("load_moved_fraction").value
        bound = mon.metrics.gauge("load_moved_bound").value
        assert 0.0 < frac <= bound
        return frac, bound, mon.tracker._routes, side.obs.to_json(mon.metrics, monitor=mon)

    both(run)


def test_tracker_probes_bypass_the_monitored_launch():
    """The probes go through the bare route (``route``), never the
    instrumented one, so they never reach the accumulator."""
    router = BatchRouter(16, device="cpu")
    mon = PO.LoadMonitor(router, config=PO.LoadConfig(drain_every=1 << 30))
    mon.drain()  # baselines the probes: 512 keys routed
    router.fail(3)
    mon.drain()
    assert mon.total_keys == 0 and mon.metrics.gauge("load_moved_fraction").value > 0


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _small_stack(side):
    clock = side.streaming.VirtualClockUs()
    reg = side.obs.MetricsRegistry(clock=clock)
    reg.counter("served_total", tenant="a").inc(3)
    reg.gauge("depth").set(2)
    reg.histogram("lat_us", bounds=(10, 100)).observe(42)
    trace = side.obs.SpanTrace(capacity=8)
    trace.record("request", 0, 42, tenant="a")
    return reg, trace


def test_snapshot_and_json_shape():
    def run(side):
        reg, trace = _small_stack(side)
        snap = side.obs.snapshot(reg, trace=trace)
        assert snap["trace"]["recorded"] == 1 and snap["trace"]["spans"][0]["tenant"] == "a"
        text = side.obs.to_json(reg, trace=trace)
        assert side.obs.to_json(reg, trace=trace) == text
        return snap, text, side.obs.to_json(reg, trace=trace, indent=2, sort_keys=False)

    both(run)


def test_prometheus_exposition():
    def run(side):
        reg, _ = _small_stack(side)
        text = side.obs.to_prometheus(reg)
        for line in ("# TYPE served_total counter", 'served_total{tenant="a"} 3',
                     'lat_us_bucket{le="100"} 1', 'lat_us_bucket{le="+Inf"} 1', "lat_us_sum 42"):
            assert line in text
        return text, side.obs.to_prometheus(side.obs.MetricsRegistry())

    both(run)


@pytest.mark.parametrize("engine", ENGINES)
def test_export_bytes_match_reference_on_a_virtual_timeline(engine):
    """One scripted ``VirtualClockUs`` timeline through a monitored router:
    batches of mixed sizes (exact and sampled), a failure, drains on the
    cadence and on demand, spans and latency observations; ``to_json`` with
    the trace and the monitor, and ``to_prometheus``, give the reference's
    bytes."""
    rng = np.random.default_rng(17)
    # two batch sizes (each is one compile of the reference's route), one
    # above the exact cutoff
    batches = [rng.integers(0, 1 << 32, size=int(s), dtype=np.uint32)
               for s in rng.choice([300, 2500], size=12)]
    gaps = rng.integers(1, 500, size=len(batches)).tolist()

    def run(side):
        clock = side.streaming.VirtualClockUs(1_000)
        reg = side.obs.MetricsRegistry(clock=clock)
        trace = side.obs.SpanTrace(capacity=16)
        alarms = []
        router = side.router(40, engine=engine, capacity=64)
        mon = side.obs.LoadMonitor(router, metrics=reg, on_alarm=alarms.append, config=side.obs.LoadConfig(
            drain_every=4, exact_cutoff=1024, sample_shift=3, min_alarm_keys=1 << 30))
        for i, (keys, gap) in enumerate(zip(batches, gaps)):
            clock.advance_us(gap)
            t0 = clock.now_us()
            router.route_keys(keys)
            clock.advance_us(37 * (i + 1))
            reg.histogram("batch_us").observe(clock.now_us() - t0)
            reg.counter("batches_total", tenant=f"t{i % 3}").inc()
            trace.record("dispatch", t0, clock.now_us(), size=keys.size)
            if i == 5:
                router.fail(11)
        mon.drain()
        reg.gauge("load_alarms").set(len(alarms))
        return (side.obs.to_json(reg, trace=trace, monitor=mon), side.obs.to_prometheus(reg),
                mon.totals, mon.drains)

    want, got = run(REF), run(PORT)
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] >= 3
