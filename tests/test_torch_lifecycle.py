"""The port's fleet lifecycle (``repro_torch.serving.lifecycle``: journal,
failure detector, ``LifecycleManager``) and span trace against the JAX
package's, on the CPU: the same event streams and heartbeat patterns must
give the same journal bytes, snapshots, replays, detector transitions at the
same clock times, routed ids, epochs, modes and typed errors (tolerance 0)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.observability.trace import SpanTrace as RefSpanTrace  # noqa: E402
from repro.placement.elastic import FailureDomain as RefDomain  # noqa: E402
from repro.serving import lifecycle as R  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import lifecycle_from_json  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.observability.trace import SpanTrace  # noqa: E402
from repro_torch.placement.elastic import FailureDomain  # noqa: E402
from repro_torch.serving import lifecycle as P  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.engine import ServingTier  # noqa: E402

ENGINES = ("binomial", "jump")


def ref_domain(n):
    return RefDomain(n, engine="binomial32", chain_bits=32, resolve="table", allow_empty=True)


def port_domain(n):
    return FailureDomain(n, engine="binomial32", chain_bits=32, resolve="table", allow_empty=True)


def same_state(a, b) -> None:
    assert a.total_count == b.total_count
    assert a.removed == b.removed
    ra, rb = a.replacement_table, b.replacement_table
    assert (ra.slots, ra.pos, ra.n_alive) == (rb.slots, rb.pos, rb.n_alive)


def pair(n, engine="binomial", **kw):
    return RefRouter(n, engine=engine, **kw), BatchRouter(n, engine=engine, device="cpu", **kw)


def same_error(fn_ref, fn_port):
    """Both raise: the same class name, message and attributes."""
    with pytest.raises(Exception) as want:
        fn_ref()
    with pytest.raises(Exception) as got:
        fn_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert vars(got.value) == vars(want.value)


# -- journal ------------------------------------------------------------------


def test_journal_epochs_and_bytes_match_reference():
    ref, port = R.MembershipJournal(4), P.MembershipJournal(4)
    for kind, slot in (("fail", 2), ("recover", 2), ("scale_up", 4)):
        a, b = ref.record(kind, slot), port.record(kind, slot)
        assert (b.epoch, b.kind, b.slot) == (a.epoch, a.kind, a.slot)
        assert b.to_json() == a.to_json()
    assert port.epoch == ref.epoch == 3
    assert [e.to_json() for e in port.events(since=1)] == [e.to_json() for e in ref.events(since=1)]
    assert port.to_jsonl() == ref.to_jsonl()


def test_journal_rejects_what_the_reference_rejects():
    same_error(lambda: R.MembershipJournal(2).record("explode", 0),
               lambda: P.MembershipJournal(2).record("explode", 0))
    same_error(lambda: R.MembershipJournal(2).events(since=-1),
               lambda: P.MembershipJournal(2).events(since=-1))
    same_error(lambda: R.MembershipJournal(0), lambda: P.MembershipJournal(0))
    same_error(lambda: R.MembershipJournal.from_jsonl(""), lambda: P.MembershipJournal.from_jsonl(""))


def test_journal_jsonl_crosses_over_both_ways():
    ref = R.MembershipJournal(6)
    for kind, slot in (("fail", 1), ("scale_up", 6), ("recover", 1)):
        ref.record(kind, slot)
    port = lifecycle_from_json(ref.to_jsonl())
    assert isinstance(port, P.MembershipJournal)
    assert port.to_jsonl() == ref.to_jsonl()
    back = R.MembershipJournal.from_jsonl(port.to_jsonl())
    assert back.events() == ref.events()


def test_journal_jsonl_detects_epoch_corruption_like_reference():
    j = R.MembershipJournal(3)
    j.record("fail", 0)
    lines = j.to_jsonl().splitlines()
    tampered = "\n".join([lines[0], lines[1].replace('"epoch": 1', '"epoch": 7')])
    same_error(lambda: R.MembershipJournal.from_jsonl(tampered),
               lambda: P.MembershipJournal.from_jsonl(tampered))


def test_snapshot_json_matches_and_crosses_over():
    d, e = ref_domain(5), port_domain(5)
    d.fail(2), e.fail(2)
    a, b = R.JournalSnapshot.capture(1, d), P.JournalSnapshot.capture(1, e)
    assert b.to_json() == a.to_json()
    assert P.JournalSnapshot.from_json(b.to_json()) == b
    got = lifecycle_from_json(a.to_json())
    assert isinstance(got, P.JournalSnapshot) and got == b


def test_replay_checks_scale_determinism_like_reference():
    for kind in ("scale_up", "scale_down"):
        same_error(lambda: R.apply_event(ref_domain(3), R.MembershipEvent(1, kind, 99)),
                   lambda: P.apply_event(port_domain(3), P.MembershipEvent(1, kind, 99)))


def _drive(domain, journal, d) -> None:
    """One decision -> one valid membership event (``tests/test_lifecycle.py``'s
    interpreter), mirrored into the journal."""
    cap = 8 + journal.n_initial
    total, removed = domain.total_count, sorted(domain.removed)
    alive = [s for s in range(total) if s not in domain.removed]
    ops = []
    if alive:
        ops.append(("fail", alive[d % len(alive)]))
    if removed:
        ops.append(("recover", removed[d % len(removed)]))
    if total < cap:
        ops.append(("scale_up", None))
    if len(alive) > 1 or (len(alive) == 1 and (total - 1) not in domain.removed):
        ops.append(("scale_down", None))
    kind, slot = ops[d % len(ops)]
    if kind in ("fail", "recover"):
        getattr(domain, kind)(slot)
    else:
        slot = getattr(domain, kind)()
    journal.record(kind, slot)


SEEDED_STREAMS = [
    (1, [0]),
    (4, [0, 1, 2, 3, 0, 1]),
    (6, list(np.random.default_rng(7).integers(0, 1 << 16, 40))),
    (3, list(np.random.default_rng(8).integers(0, 1 << 16, 60))),
    (12, list(np.random.default_rng(9).integers(0, 1 << 16, 80))),
]


@pytest.mark.parametrize("n_initial,decisions", SEEDED_STREAMS)
def test_replay_parity_matches_reference(n_initial, decisions):
    crash_at = len(decisions) // 2
    sides = []
    for mk, J in ((ref_domain, R), (port_domain, P)):
        live, journal, snaps = mk(n_initial), J.MembershipJournal(n_initial), {}
        for i, d in enumerate(decisions):
            _drive(live, journal, int(d))
            if i == crash_at:
                snaps[journal.epoch] = J.JournalSnapshot.capture(journal.epoch, live)
        same_state(J.replay(journal, mk), live)
        revived = J.MembershipJournal.from_jsonl(journal.to_jsonl())
        same_state(J.replay(revived, mk), live)
        for epoch, snap in snaps.items():
            same_state(J.restore(snap, mk, journal.events(since=epoch)), live)
            assert J.JournalSnapshot.capture(epoch, J.replay(journal, mk, upto=epoch)) == snap
        sides.append((live, journal, snaps))
    (rl, rj, rs), (pl, pj, ps) = sides
    same_state(rl, pl)
    assert pj.to_jsonl() == rj.to_jsonl()
    assert {e: s.to_json() for e, s in ps.items()} == {e: s.to_json() for e, s in rs.items()}


# -- failure detector ---------------------------------------------------------


class Detectors:
    """A reference and a port detector over the same slots, each on its own
    ``ManualClock``, driven in lockstep: every poll must emit the same
    events and every slot must sit in the same state."""

    def __init__(self, slots, cfg=None):
        self.clocks = (R.ManualClock(), P.ManualClock())
        self.ref = R.FailureDetector(slots, None if cfg is None else R.HeartbeatConfig(**cfg),
                                     self.clocks[0])
        self.port = P.FailureDetector(slots, None if cfg is None else P.HeartbeatConfig(**cfg),
                                      self.clocks[1])

    def advance(self, dt):
        assert self.clocks[1].advance(dt) == self.clocks[0].advance(dt)

    def beat(self, *slots):
        for s in slots:
            self.ref.heartbeat(s), self.port.heartbeat(s)
        self.check()

    def poll(self):
        want, got = self.ref.poll(), self.port.poll()
        assert got == want
        self.check()
        return got

    def check(self):
        assert self.port.slots == self.ref.slots
        assert [self.port.state_of(s) for s in self.port.slots] == [
            self.ref.state_of(s) for s in self.ref.slots]


def test_detector_states_are_the_reference_names():
    assert (P.ALIVE, P.SUSPECT, P.REMOVED, P.QUARANTINED) == (
        R.ALIVE, R.SUSPECT, R.REMOVED, R.QUARANTINED)
    assert dataclasses.asdict(P.HeartbeatConfig()) == dataclasses.asdict(R.HeartbeatConfig())


def test_detector_quiet_fleet_and_hysteresis():
    d = Detectors(range(4))
    for _ in range(10):
        d.advance(1.0)
        d.beat(0, 1, 2, 3)
        assert d.poll() == []
    d.advance(4.0)  # > suspect_after, < fail_after
    assert d.poll() == []
    assert d.port.state_of(0) == P.SUSPECT
    d.beat(0)
    assert d.port.state_of(0) == P.ALIVE


def test_detector_fail_once_quarantine_and_readmit():
    d = Detectors(range(3))
    cfg = d.port.config
    d.advance(cfg.fail_after + 0.5)
    d.beat(0, 2)
    assert d.poll() == [("fail", 1)]
    d.advance(1.0)
    d.beat(0, 2)
    assert d.poll() == []
    d.beat(1)
    assert d.port.state_of(1) == P.QUARANTINED
    events = []
    for _ in range(int(cfg.readmit_after) + 1):
        d.advance(1.0)
        d.beat(0, 1, 2)
        events += d.poll()
    assert events == [("recover", 1)]


def test_detector_quarantine_gap_and_silence():
    d = Detectors([0, 1])
    cfg = d.port.config
    d.advance(cfg.fail_after + 1)
    assert d.poll() == [("fail", 0), ("fail", 1)]
    d.beat(0, 1)
    d.advance(cfg.readmit_after - 1)
    d.beat(0)  # gap > suspect_after: slot 0's window restarts
    assert d.poll() == []  # slot 1 went quiet in quarantine: removed, no event
    assert (d.port.state_of(0), d.port.state_of(1)) == (P.QUARANTINED, P.REMOVED)
    events = []
    for _ in range(int(cfg.readmit_after) + 1):
        d.advance(1.0)
        d.beat(0)
        events += d.poll()
    assert events == [("recover", 0)]


def test_detector_flap_backoff_matches_reference():
    cfg = dict(readmit_after=4.0, flap_window=1000.0, flap_backoff=2.0, max_readmit_after=10.0)
    d = Detectors([0], cfg)
    latencies = []
    for _ in range(3):
        d.advance(d.port.config.fail_after + 0.5)
        assert d.poll() == [("fail", 0)]
        d.beat(0)
        for t in range(1, 100):
            d.advance(1.0)
            d.beat(0)
            if d.poll() == [("recover", 0)]:
                latencies.append(t)
                break
    assert latencies[0] < latencies[1] <= latencies[2] <= 11


def test_detector_register_forget_mark_removed_and_clock():
    d = Detectors([0, 1])
    d.ref.register(2), d.port.register(2)
    d.ref.forget(1), d.port.forget(1)
    d.ref.forget(1), d.port.forget(1)
    d.ref.mark_removed(2), d.port.mark_removed(2)
    d.check()
    d.beat(2)
    assert d.port.state_of(2) == P.QUARANTINED
    for c in d.clocks:
        c._t -= 1.0  # the clock goes back
    same_error(d.ref.poll, d.port.poll)


@pytest.mark.parametrize("bad", [
    dict(heartbeat_interval=0), dict(suspect_after=1.0, heartbeat_interval=2.0),
    dict(fail_after=1.0), dict(readmit_after=0), dict(flap_backoff=0.5),
])
def test_heartbeat_config_validation_matches_reference(bad):
    same_error(lambda: R.HeartbeatConfig(**bad), lambda: P.HeartbeatConfig(**bad))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detector_seeded_beats_match_reference(seed):
    """``tests/test_lifecycle.py``'s alternation property stream: random
    gaps and beat patterns over three slots, polled after each step."""
    d = Detectors(range(3))
    for x in np.random.default_rng(seed).integers(0, 1 << 8, 300).tolist():
        d.advance(0.5 + (x % 8) * 0.5)
        d.beat(*[s for s in range(3) if (x >> (4 + s)) & 1])
        d.poll()


# -- lifecycle manager --------------------------------------------------------


def test_manager_rejects_late_attach_and_bad_config():
    ref, port = pair(4)
    ref.fail(1), port.fail(1)
    same_error(lambda: R.LifecycleManager(ref), lambda: P.LifecycleManager(port))
    same_error(lambda: R.LifecycleConfig(min_alive_floor=0), lambda: P.LifecycleConfig(min_alive_floor=0))


def count_uploads(router) -> list:
    """Counts the host-to-device copies of the router's fleet state."""
    copies, to = [], router._fleet_host.to
    router._fleet_host.to = lambda device: (copies.append(1), to(device))[1]
    return copies


@pytest.mark.parametrize("engine", ENGINES)
def test_manager_storm_is_one_upload_and_matches_reference(engine):
    ref, port = pair(8, engine)
    rm, pm = R.LifecycleManager(ref), P.LifecycleManager(port)
    copies = count_uploads(port)
    storm = [("fail", 1), ("fail", 2), ("recover", 1), ("fail", 5), ("fail", 3)]
    want, got = rm.apply(storm), pm.apply(storm)
    assert len(copies) == 1
    assert [e.to_json() for e in got] == [e.to_json() for e in want]
    assert pm.epoch == port.routing_epoch == rm.epoch == len(storm)
    keys = np.random.default_rng(3).integers(0, 1 << 32, 2048, dtype=np.uint32)
    np.testing.assert_array_equal(pm.route_keys_np(keys).replicas, rm.route_keys_np(keys).replicas)
    pm.verify_replay()
    assert pm.journal.to_jsonl() == rm.journal.to_jsonl()
    same_error(lambda: rm.apply([("teleport", 1)]), lambda: pm.apply([("teleport", 1)]))


def test_manager_modes_and_typed_errors_match_reference():
    ref, port = pair(4)
    cfg = dict(min_alive_floor=2)
    rm, pm = R.LifecycleManager(ref, R.LifecycleConfig(**cfg)), P.LifecycleManager(
        port, P.LifecycleConfig(**cfg))
    keys = np.arange(64, dtype=np.uint32)

    def same_batch():
        a, b = rm.route_keys_np(keys), pm.route_keys_np(keys)
        assert (b.epoch, b.mode) == (a.epoch, a.mode)
        np.testing.assert_array_equal(b.replicas, np.asarray(a.replicas))

    same_batch()
    for slot in (0, 1, 2):
        rm.fail(slot), pm.fail(slot)
        assert pm.mode == rm.mode
        same_batch()
    rm.fail(3), pm.fail(3)
    assert pm.mode == rm.mode == P.MODE_UNAVAILABLE
    same_error(lambda: rm.route_keys_np(keys), lambda: pm.route_keys_np(keys))
    rm.recover(3), pm.recover(3)
    same_batch()
    strict = P.LifecycleConfig(min_alive_floor=3, strict_floor=True)
    ref2, port2 = pair(4)
    rm2 = R.LifecycleManager(ref2, R.LifecycleConfig(min_alive_floor=3, strict_floor=True))
    pm2 = P.LifecycleManager(port2, strict)
    for slot in (1, 2):
        rm2.fail(slot), pm2.fail(slot)
    same_error(lambda: rm2.route_keys_np(keys[:8]), lambda: pm2.route_keys_np(keys[:8]))


def test_manager_scale_events_and_detector_match_reference():
    ref, port = pair(4)
    rm, pm = R.LifecycleManager(ref), P.LifecycleManager(port)
    assert pm.scale_up() == rm.scale_up() == 4
    assert pm.detector.state_of(4) == P.ALIVE
    assert pm.scale_down() == rm.scale_down() == 4
    rm.fail(3), pm.fail(3)  # a LIFO retirement: the detector follows
    assert pm.detector.slots == rm.detector.slots == (0, 1, 2)
    pm.verify_replay()
    assert pm.journal.to_jsonl() == rm.journal.to_jsonl()


@pytest.mark.parametrize("engine", ENGINES)
def test_manager_tick_coalesces_expiries_like_reference(engine):
    ref, port = pair(6, engine)
    rc, pc = R.ManualClock(), P.ManualClock()
    rm, pm = R.LifecycleManager(ref, clock=rc), P.LifecycleManager(port, clock=pc)
    copies = count_uploads(port)
    for c in (rc, pc):
        c.advance(pm.config.heartbeat.fail_after + 1)
    for s in (0, 2, 5):
        rm.heartbeat(s), pm.heartbeat(s)
    want, got = rm.tick(), pm.tick()
    assert [e.to_json() for e in got] == [e.to_json() for e in want]
    assert [(e.kind, e.slot) for e in got] == [("fail", 1), ("fail", 3), ("fail", 4)]
    assert len(copies) == 1
    assert pm.tick() == rm.tick() == []
    pm.verify_replay()


def test_manager_tick_records_a_span_like_reference():
    ref, port = pair(5)
    rc, pc = R.ManualClock(2.5), P.ManualClock(2.5)
    rt, pt = RefSpanTrace(8), SpanTrace(8)
    rm = R.LifecycleManager(ref, clock=rc, tracer=rt)
    pm = P.LifecycleManager(port, clock=pc, tracer=pt)
    for c in (rc, pc):
        c.advance(10.0)
    rm.tick(), pm.tick()
    assert [dataclasses.asdict(s) for s in pt.spans()] == [dataclasses.asdict(s) for s in rt.spans()]
    assert pt.count("lifecycle_tick") == rt.count("lifecycle_tick") == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_manager_routes_stamped_like_reference(engine):
    ref, port = pair(5, engine)
    rm, pm = R.LifecycleManager(ref), P.LifecycleManager(port)
    sessions = [f"sess-{i}" for i in range(32)]
    a, b = rm.route_batch(sessions), pm.route_batch(sessions)
    assert (b.epoch, b.mode) == (a.epoch, a.mode) == (0, "normal")
    np.testing.assert_array_equal(b.replicas, a.replicas)
    rm.fail(2), pm.fail(2)
    keys = np.arange(64, dtype=np.uint32)
    a, b = rm.route_keys(keys), pm.route_keys(keys)
    assert isinstance(b.replicas, torch.Tensor) and b.epoch == a.epoch == 1
    np.testing.assert_array_equal(b.replicas.numpy(), np.asarray(a.replicas))


@pytest.mark.parametrize("max_chain", [0, 1, 4096])
def test_manager_replay_after_churn_matches_reference(max_chain):
    """The port's domain takes no ``max_chain`` (table resolution only);
    the reference's replay is the same whatever ``max_chain`` its router
    carries, and equal to the port's."""
    rng = np.random.default_rng(42)
    ref = RefRouter(8, engine="binomial", max_chain=max_chain)
    port = BatchRouter(8, engine="binomial", device="cpu")
    rm, pm = R.LifecycleManager(ref), P.LifecycleManager(port)
    for _ in range(60):
        alive = [s for s in range(ref.domain.total_count) if s not in ref.domain.removed]
        tomb = sorted(ref.domain.removed)
        roll = rng.random()
        if roll < 0.45 and alive:
            s = int(rng.choice(alive))
            rm.fail(s), pm.fail(s)
        elif roll < 0.8 and tomb:
            s = int(rng.choice(tomb))
            rm.recover(s), pm.recover(s)
        elif ref.domain.total_count < ref.spec.capacity:
            assert pm.scale_up() == rm.scale_up()
    pm.verify_replay()
    pm.verify_replay(pm.snapshot())
    assert pm.snapshot().to_json() == rm.snapshot().to_json()
    revived = P.MembershipJournal.from_jsonl(rm.journal.to_jsonl())
    rebuilt = P.replay(revived, pm._domain_factory)
    same_state(rebuilt, R.replay(rm.journal, rm._domain_factory))
    same_state(rebuilt, port.domain)


def test_verify_replay_catches_a_diverged_router():
    port = BatchRouter(6, device="cpu")
    pm = P.LifecycleManager(port)
    pm.fail(2)
    port.fail(4)  # bypasses the journal
    with pytest.raises(AssertionError, match="removed"):
        pm.verify_replay()


def test_errors_match_reference():
    assert (P.MODE_NORMAL, P.MODE_DEGRADED, P.MODE_UNAVAILABLE) == (
        R.MODE_NORMAL, R.MODE_DEGRADED, R.MODE_UNAVAILABLE)
    assert (P.SHED_PAST_DEADLINE, P.SHED_INFEASIBLE, P.SHED_RATE_LIMITED, P.SHED_LATE) == (
        R.SHED_PAST_DEADLINE, R.SHED_INFEASIBLE, R.SHED_RATE_LIMITED, R.SHED_LATE)
    cases = [
        ("FleetUnavailableError", (), dict(epoch=7)),
        ("FleetUnavailableError", ("all holders failed",), dict(epoch=None)),
        ("FleetDegradedError", (1, 3), dict(epoch=2)),
        ("PlacementDegradedError", (2, 3), dict(epoch=5)),
        ("ClockWentBackwardsError", (), dict(now=1.0, last=2.5)),
        ("AdmissionRejectedError", ("rate_limited",), dict(tenant="t", deadline_us=5, now_us=9)),
        ("AdmissionRejectedError", ("past_deadline",), {}),
        ("PlacementExhaustedError", (4, 0), dict(epoch=1)),
    ]
    for name, args, kw in cases:
        a, b = getattr(R, name)(*args, **kw), getattr(P, name)(*args, **kw)
        assert (str(b), vars(b)) == (str(a), vars(a))
        assert isinstance(b, P.LifecycleError) and isinstance(b, RuntimeError)
    assert P.__all__ == R.__all__


def test_span_trace_matches_reference():
    ref, port = RefSpanTrace(3), SpanTrace(3)
    for i in range(5):
        for t in (ref, port):
            t.record("admit" if i % 2 else "read", i, i + 2, tenant="a" if i < 3 else None, n=i)
    assert [dataclasses.asdict(s) for s in port.spans()] == [dataclasses.asdict(s) for s in ref.spans()]
    assert [dataclasses.asdict(s) for s in port.spans("admit", "a")] == [
        dataclasses.asdict(s) for s in ref.spans("admit", "a")]
    assert (port.count(), port.count("read"), port.dropped) == (ref.count(), ref.count("read"), ref.dropped)
    assert port.spans()[0].tag("n") == 2 and port.spans()[0].duration_us == 2
    same_error(lambda: RefSpanTrace(0), lambda: SpanTrace(0))


def test_serving_tier_lifecycle_journals_like_reference():
    """``ServingTier.attach_lifecycle``: heartbeats, ``serve`` ticking the
    detector first, and tier-level events, journaled as a reference
    ``LifecycleManager`` journals the same events."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    tier = ServingTier(cfg, params, 4, max_len=8, device="cpu")
    with pytest.raises(RuntimeError, match="attach_lifecycle"):
        tier.heartbeat(0)
    pc = P.ManualClock()
    pm = tier.attach_lifecycle(clock=pc)
    rc = R.ManualClock()
    rm = R.LifecycleManager(RefRouter(4, engine="binomial"), clock=rc)
    for c in (rc, pc):
        c.advance(rm.config.heartbeat.fail_after + 1)
    for s in (0, 1, 3):
        rm.heartbeat(s), tier.heartbeat(s)
    assert tier.serve([]) == {}  # the tick fails slot 2 before routing
    rm.tick()
    assert pm.n_alive == 3 and tier.router.domain.removed == {2}
    tier.recover(2), rm.recover(2)
    assert tier.scale_up(params) == rm.scale_up() == 4 and len(tier.replicas) == 5
    tier.fail(4), rm.fail(4)  # the top slot: a LIFO retirement
    assert len(tier.replicas) == 4
    assert pm.journal.to_jsonl() == rm.journal.to_jsonl()
    pm.verify_replay()
