"""The seeded fleet-trouble storylines of ``tests/chaos.py`` — all nine:
the five routing kinds, the two placement kinds and the two streaming
kinds — driven through the JAX package's objects and the port's
(``device="cpu"``) in lockstep, seed for seed.  Every call the storyline
makes goes to both sides and must give the same answer: routed ids, epochs
and modes, detector events, placements, reads, repair tasks, served
``StreamResult``s, sheds, hedged reads, drained load windows, or the same
typed error.  At the end both sides must hold the same journal bytes,
snapshot, holders and ``lost``/``completed`` counts, and the streaming
kinds the same registry, trace and load-monitor JSON bytes, with the
reference's telemetry-fidelity checks (invariants 11-14) passing on the
reference's side of each answer.

The storylines themselves (``chaos._STORYLINES``) only call the runner
interface; the runners here build both sides instead of ``chaos.py``'s,
which build the reference alone."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from chaos import (  # noqa: E402
    _STORYLINES,
    N_PROBE,
    PLACEMENT_KINDS,
    PROBE_KEYS,
    STREAMING_KINDS,
    ScenarioResult,
    _StreamingRunner,
)
from repro import observability as RO  # noqa: E402
from repro.placement.store import StorePlacement as RefStore  # noqa: E402
from repro.serving import lifecycle as R  # noqa: E402
from repro.serving import streaming as RS  # noqa: E402
from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
from repro_torch import observability as PO  # noqa: E402
from repro_torch.placement.store import StorePlacement  # noqa: E402
from repro_torch.serving import lifecycle as P  # noqa: E402
from repro_torch.serving import streaming as PS  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402

ROUTING_KINDS = ("storm", "flap", "cascade", "crash_recover", "mixed")
ENGINES = ("binomial", "jump")
SEEDS = (11, 23)


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
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _side(x, i):
    return x.pair[i] if isinstance(x, Twin) else x


def _object(x) -> bool:
    """An object of either package (kept as a twin), not a plain value."""
    return type(x).__module__.startswith("repro.") and not isinstance(x, (tuple, list))


class Twin:
    """A reference object and its port counterpart, driven in lockstep.

    Reading an attribute reads both: objects come back as twins, values are
    compared and the reference's is returned.  Calling a method calls both
    (each with its own side of any twin argument) and compares the answers;
    if either raises, both must raise the same typed error, and the
    reference's is raised, so the storylines' ``except`` clauses see it.
    """

    def __init__(self, ref, port):
        self.pair = (ref, port)

    def __getattr__(self, name):
        a, b = (getattr(x, name) for x in self.pair)
        if callable(a) and not _object(a):
            return lambda *args, **kw: self._call(a, b, args, kw)
        return _answer(a, b)

    @staticmethod
    def _call(a, b, args, kw):
        outs = []
        for i, fn in enumerate((a, b)):
            try:
                outs.append((fn(*(_side(v, i) for v in args),
                                **{k: _side(v, i) for k, v in kw.items()}), None))
            except Exception as e:  # noqa: BLE001 - compared below
                outs.append((None, e))
        (ra, ea), (rb, eb) = outs
        if ea is not None or eb is not None:
            assert ea is not None and eb is not None, f"one side raised: {ea!r} / {eb!r}"
            assert (type(eb).__name__, str(eb)) == (type(ea).__name__, str(ea))
            raise ea
        return _answer(ra, rb)


def _agrees(got, want) -> bool:
    """``got`` equals ``want``; a port dataclass may leave out fields of the
    reference's that only its TPU layout has (``RouterSpec``'s tiling)."""
    if isinstance(got, dict) and isinstance(want, dict):
        return all(k in want and _agrees(v, want[k]) for k, v in got.items())
    if isinstance(got, list) and isinstance(want, list):
        return len(got) == len(want) and all(map(_agrees, got, want))
    return got == want


def _answer(a, b):
    if dataclasses.is_dataclass(a) or not _object(a):
        assert _agrees(norm(b), norm(a)), (b, a)
    return Twin(a, b) if _object(a) else a


class Lockstep:
    """The runner interface the routing storylines call, over twins of a
    ``LifecycleManager``-wrapped ``BatchRouter`` on a ``ManualClock``."""

    def __init__(self, kind: str, engine: str, seed: int, n_initial: int):
        self.rng = np.random.default_rng(seed)
        self.clock = Twin(R.ManualClock(), P.ManualClock())
        self.router = Twin(RefRouter(n_initial, engine=engine),
                           BatchRouter(n_initial, engine=engine, device="cpu"))
        self.mgr = Twin(*(
            L.LifecycleManager(r, L.LifecycleConfig(min_alive_floor=1), clock=c)
            for L, r, c in zip((R, P), self.router.pair, self.clock.pair)))
        self.res = ScenarioResult(kind=kind, engine=engine, seed=seed)
        self.probe()

    @property
    def total(self) -> int:
        return self.router.domain.total_count

    @property
    def removed(self) -> frozenset:
        return self.router.domain.removed

    @property
    def alive_slots(self) -> list:
        rm = self.removed
        return [s for s in range(self.total) if s not in rm]

    def _flag(self, msg: str) -> None:
        self.res.violations.append(msg)

    def probe(self, event=None) -> None:
        self.res.route_attempts += 1
        try:
            self.mgr.route_keys_np(PROBE_KEYS)
        except R.FleetUnavailableError:
            self.res.route_unavailable += 1

    def check_replay(self) -> None:
        self.res.replay_checks += 1
        self.mgr.verify_replay()
        self.mgr.verify_replay(self.mgr.snapshot())

    def crash_and_rebuild(self, snapshot, tail_from: int) -> None:
        """Both sides rebuilt from the journal text alone, then from the
        snapshot and the tail."""
        self.res.replay_checks += 1
        text = self.mgr.journal.to_jsonl()
        for L, mgr in zip((R, P), self.mgr.pair):
            rebuilt = L.replay(L.MembershipJournal.from_jsonl(text), mgr._domain_factory)
            assert rebuilt.replacement_table.slots == mgr.router.domain.replacement_table.slots
            assert rebuilt.removed == mgr.router.domain.removed
        self.mgr.verify_replay(snapshot)

    def fail_one(self, slot: int) -> None:
        self.mgr.fail(slot)
        self.res.events += 1
        self.probe()

    def recover_one(self, slot: int) -> None:
        self.mgr.recover(slot)
        self.res.events += 1
        self.probe()

    def storm(self, transitions) -> None:
        self.mgr.apply(transitions)
        self.res.events += len(transitions)
        self.probe()

    def maybe_scale_up(self) -> None:
        if self.total < self.router.spec.capacity:
            self.mgr.scale_up()
            self.res.events += 1
            self.probe()

    def maybe_scale_down(self) -> None:
        n = self.router.domain.alive_count
        if n > 1 or (n == 1 and (self.total - 1) not in self.removed):
            self.mgr.scale_down()
            self.res.events += 1
            self.probe()


class PlacementLockstep(Lockstep):
    """The runner interface the placement storylines call: twins of an
    R-way ``StorePlacement`` holding the probe keys and its
    ``PlacementRepairer``."""

    REPAIR_BUDGET = 8

    def __init__(self, kind: str, engine: str, seed: int, n_initial: int, r: int):
        super().__init__(kind, engine, seed, n_initial)
        self.store = Twin(RefStore(self.router.pair[0], r=r),
                          StorePlacement(self.router.pair[1], r=r))
        self.store.register(PROBE_KEYS)
        self.repairer = Twin(*(
            L.PlacementRepairer(s, m, budget_per_tick=self.REPAIR_BUDGET)
            for L, s, m in zip((R, P), self.store.pair, self.mgr.pair)))
        self.check_durability()

    @property
    def n_alive(self) -> int:
        return self.router.domain.alive_count

    def probe(self, event=None) -> None:
        pass  # the placement storylines check durability instead

    def check_durability(self) -> None:
        self.res.route_attempts += 1
        try:
            self.store.reachable_counts()
            self.store.place(PROBE_KEYS[:16])
        except R.FleetUnavailableError:
            self.res.route_unavailable += 1

    def check_replay(self) -> None:
        self.res.replay_checks += 1
        self.repairer.verify_placement_replay()
        self.repairer.verify_placement_replay(self.mgr.snapshot())

    def tick_repair(self) -> list:
        done = self.repairer.tick()
        self.res.repair_copies += len(done)
        return done

    def quiesce(self) -> None:
        while self.repairer.backlog:
            self.tick_repair()
        self.store.reachable_counts()

    def fail(self, slot: int) -> None:
        self.mgr.fail(slot)
        self.res.events += 1
        self.check_durability()

    def storm(self, transitions) -> None:
        self.mgr.apply(transitions)
        self.res.events += len(transitions)
        self.check_durability()

    def recover_all(self) -> None:
        back = sorted(self.removed)
        if back:
            self.storm([("recover", s) for s in self.rng.permutation(back).tolist()])

    def maybe_scale_up(self) -> bool:
        if self.total >= self.router.spec.capacity:
            return False
        self.mgr.scale_up()
        self.res.events += 1
        self.check_durability()
        return True

    def pick_alive(self) -> int | None:
        alive = self.alive_slots
        return int(self.rng.choice(alive)) if alive else None


class StreamingLockstep(_StreamingRunner):
    """The runner interface the streaming storylines call (``chaos.py``'s
    ``_StreamingRunner``, whose checks it inherits): twins of a
    ``StreamingFrontEnd`` over a lifecycle-wrapped router and an R-way
    placement on one ``VirtualClockUs`` per side, each side with its own
    registry, span trace and ``LoadMonitor``.  The injected service model is
    shared; each side's read probe asks its own detector."""

    def __init__(self, kind: str, engine: str, seed: int, n_initial: int):
        self.rng = np.random.default_rng(seed)
        self.clock = Twin(RS.VirtualClockUs(), PS.VirtualClockUs())
        self.router = Twin(RefRouter(n_initial, engine=engine),
                           BatchRouter(n_initial, engine=engine, device="cpu"))
        hb = {R: self.HB, P: P.HeartbeatConfig(**dataclasses.asdict(self.HB))}
        self.mgr = Twin(*(
            L.LifecycleManager(r, L.LifecycleConfig(min_alive_floor=1, heartbeat=hb[L]),
                               clock=c.seconds_view())
            for L, r, c in zip((R, P), self.router.pair, self.clock.pair)))
        r = min(3, n_initial - 1)
        self.store = Twin(RefStore(self.router.pair[0], r=r),
                          StorePlacement(self.router.pair[1], r=r))
        self.store.register(PROBE_KEYS)
        self.repairer = Twin(*(
            L.PlacementRepairer(s, m, budget_per_tick=64)
            for L, s, m in zip((R, P), self.store.pair, self.mgr.pair)))
        self.metrics = Twin(*(O.MetricsRegistry(clock=c) for O, c in zip((RO, PO), self.clock.pair)))
        self.trace = Twin(RO.SpanTrace(capacity=1 << 15), PO.SpanTrace(capacity=1 << 15))
        self.alarms, self.port_alarms = [], []
        self.monitor = Twin(*(
            O.LoadMonitor(router, metrics=m, config=O.LoadConfig(drain_every=1 << 30),
                          on_alarm=alarms.append)
            for O, router, m, alarms in zip((RO, PO), self.router.pair, self.metrics.pair,
                                            (self.alarms, self.port_alarms))))
        self.total_served = 0
        self.res = ScenarioResult(kind=kind, engine=engine, seed=seed)
        self.spike_mult = 1.0

    def make_frontend(self, rate_per_s=None):
        def on_events(events):
            self.res.events += len(events)

        sides = []
        for i, (S, L, mgr, store, clock, metrics, trace) in enumerate(zip(
                (RS, PS), (R, P), self.mgr.pair, self.store.pair, self.clock.pair,
                self.metrics.pair, self.trace.pair)):
            def probe(shard, detector=mgr.detector, suspect=L.SUSPECT):
                try:
                    slow = detector.state_of(int(shard)) == suspect
                except KeyError:
                    slow = False
                return 900 if slow else 120

            sides.append(S.StreamingFrontEnd(
                mgr, store=store,
                config=S.StreamConfig(max_batch=self.MAX_BATCH, max_wait_us=self.MAX_WAIT_US,
                                      service_bound_us=self.SERVICE_BOUND_US, hedge_after_us=300,
                                      tenant_rate_per_s=rate_per_s),
                clock=clock,
                breaker_config=S.BreakerConfig(trip_after=3, window_us=30_000_000,
                                               cooldown_us=2_000_000),
                dispatch_fn=S.LifecycleDispatch(mgr, on_events=on_events if i == 0 else None),
                service_model=self._service_model, probe=probe, metrics=metrics, tracer=trace))
        return Twin(*sides)

    def drive(self, fe, n_requests: int, gap_us: int, slo_us: int, jitter: float = 0.2):
        """``chaos.py``'s open-loop arrivals, each request a twin (one object
        per side, so each side stamps its own arrival)."""
        served = shed = 0
        for _ in range(n_requests):
            fields = dict(key=int(self.rng.integers(0, 1 << 32)),
                          deadline_us=self.clock.now_us() + slo_us,
                          tenant=f"t{int(self.rng.integers(0, 4))}")
            try:
                fe.submit(Twin(RS.StreamRequest(**fields), PS.StreamRequest(**fields)))
            except R.AdmissionRejectedError:
                shed += 1
            lo, hi = (1 - jitter) * gap_us, (1 + jitter) * gap_us
            self.clock.advance_us(max(1, int(self.rng.uniform(lo, hi))))
            served += self._consume(fe.pump())
        served += self._consume(fe.drain())
        return served, shed


def run_lockstep(kind: str, engine: str, seed: int):
    """``chaos.run_scenario``'s set-up (fleet size, replication factor) with
    the lockstep runners."""
    n_initial = int(np.random.default_rng(seed).integers(4, 17))
    if kind in STREAMING_KINDS:
        runner = StreamingLockstep(kind, engine, seed, max(n_initial, 6))
    elif kind in PLACEMENT_KINDS:
        rep = 3 if kind == "repair_race" else 2 + seed % 2
        runner = PlacementLockstep(kind, engine, seed, max(n_initial, rep + 2), rep)
    else:
        runner = Lockstep(kind, engine, seed, n_initial)
    _STORYLINES[kind](runner)
    return runner


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ROUTING_KINDS + PLACEMENT_KINDS + STREAMING_KINDS)
def test_storyline_in_lockstep(kind, engine, seed):
    run = run_lockstep(kind, engine, seed)
    assert run.res.violations == [] and run.res.events > 0 and run.res.replay_checks > 0
    ref, port = run.mgr.pair
    assert port.journal.to_jsonl() == ref.journal.to_jsonl()
    assert port.journal.epoch == port.router.routing_epoch == ref.router.routing_epoch
    assert port.snapshot().to_json() == ref.snapshot().to_json()
    np.testing.assert_array_equal(port.router._fleet_host.packed, ref.router._fleet_host.packed[0, :port.router.n_words])
    if kind in PLACEMENT_KINDS + STREAMING_KINDS:
        rs, ps = run.store.pair
        np.testing.assert_array_equal(ps.holders, rs.holders)
        rr, pr = run.repairer.pair
        assert (pr.lost, pr.completed, pr.batches) == (rr.lost, rr.completed, rr.batches)
        assert ps.keys.size == N_PROBE
    if kind in PLACEMENT_KINDS:
        assert pr.completed == run.res.repair_copies > 0
    if kind in STREAMING_KINDS:
        (rm, pm), (rt, pt), (rmon, pmon) = run.metrics.pair, run.trace.pair, run.monitor.pair
        assert PO.to_json(pm, trace=pt, monitor=pmon) == RO.to_json(rm, trace=rt, monitor=rmon)
        assert PO.to_prometheus(pm) == RO.to_prometheus(rm)
        assert run.port_alarms == run.alarms == []
        assert run.total_served > 0 and pmon.total_keys == run.total_served
    if kind == "flap":
        assert run.res.recovery_latencies
