"""LifecycleManager: journal + detector + degradation around a BatchRouter —
the counterpart of ``repro.serving.lifecycle.manager``.

The robustness layer of the serving tier (DESIGN.md §12).  Composition, not
inheritance: the manager *wraps* a ``BatchRouter`` (anything with the fleet
-event + route surface works) and adds

* **journaling** — every membership event that flows through the manager is
  epoch-stamped into a ``MembershipJournal``; ``snapshot()`` +
  ``verify_replay()`` prove the live control plane and the device operands
  are reproducible from the log (crash recovery = restore + tail replay);
* **failure detection** — replica heartbeats feed a deadline
  ``FailureDetector``; ``tick()`` turns deadline expiries into coalesced
  fail/recover events before the next dispatch;
* **coalescing** — a storm of N events becomes ONE device-state upload
  (``BatchRouter.coalesced_events``), with the final routing bit-exact
  against per-event application (the device operands are a pure function of
  the final control-plane state);
* **degradation** — typed route-time answers: ``FleetUnavailableError`` at
  ``n_alive == 0`` always; below ``min_alive_floor`` either a
  ``FleetDegradedError`` (``strict_floor=True``) or a routed batch marked
  ``mode="degraded"``;
* **epochs** — every routed batch carries the routing epoch it was computed
  under, so callers can detect placements staled by later events.

Everything here is host-side control plane: the device hot path is the same
single fused launch ``BatchRouter`` always ran, on the router's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bulk import FleetState
from repro_torch.core.registry import make_bulk
from repro_torch.kernels import ops
from repro_torch.observability.trace import SPAN_LIFECYCLE_TICK
from repro_torch.placement.elastic import FailureDomain
from repro_torch.serving.lifecycle.detector import (
    FailureDetector,
    HeartbeatConfig,
    MonotonicClock,
)
from repro_torch.serving.lifecycle.errors import (
    MODE_DEGRADED,
    MODE_NORMAL,
    MODE_UNAVAILABLE,
    FleetDegradedError,
    FleetUnavailableError,
)
from repro_torch.serving.lifecycle.journal import (
    JournalSnapshot,
    MembershipJournal,
    replay,
    restore,
)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    #: below this many alive replicas the fleet counts as degraded
    min_alive_floor: int = 1
    #: True: routing below the floor raises FleetDegradedError; False (the
    #: default): routing proceeds, the result is marked mode="degraded"
    strict_floor: bool = False
    heartbeat: HeartbeatConfig = dataclasses.field(default_factory=HeartbeatConfig)

    def __post_init__(self):
        if self.min_alive_floor < 1:
            raise ValueError(
                f"min_alive_floor must be >= 1, got {self.min_alive_floor}"
            )


class RoutedBatch(NamedTuple):
    """A routed batch + the epoch/mode it was computed under."""

    replicas: object  # torch.Tensor / np.ndarray of int32 replica ids
    epoch: int
    mode: str


class LifecycleManager:
    def __init__(
        self,
        router,
        config: LifecycleConfig | None = None,
        clock=None,
        tracer=None,
    ):
        self.router = router
        self.config = config or LifecycleConfig()
        self.clock = clock or MonotonicClock()
        #: optional SpanTrace — each tick() records a ``lifecycle_tick``
        #: span (the streaming front end attaches its shared trace here)
        self.tracer = tracer
        #: attached PlacementRepairer (None = no placement tier); every
        #: journaled membership mutation re-syncs it
        self._placement: "PlacementRepairer | None" = None
        self.journal = MembershipJournal(router.domain.total_count)
        self.detector = FailureDetector(
            (s for s in range(router.domain.total_count)
             if s not in router.domain.removed),
            self.config.heartbeat,
            self.clock,
        )
        # journal epochs continue from the router's own event counter so the
        # per-batch epoch is consistent whether events arrive via the
        # manager or (pre-attach) via the router directly
        if router.routing_epoch != 0:
            raise ValueError(
                "attach the LifecycleManager before mutating the fleet: the "
                f"router has already seen {router.routing_epoch} event(s) "
                "the journal cannot replay"
            )

    # -- health --------------------------------------------------------------
    @property
    def n_alive(self) -> int:
        return self.router.domain.alive_count

    @property
    def mode(self) -> str:
        n = self.n_alive
        if n == 0:
            return MODE_UNAVAILABLE
        if n < self.config.min_alive_floor:
            return MODE_DEGRADED
        return MODE_NORMAL

    @property
    def epoch(self) -> int:
        return self.journal.epoch

    # -- heartbeat plane -----------------------------------------------------
    def heartbeat(self, slot: int) -> None:
        self.detector.heartbeat(slot)

    def tick(self) -> list:
        """Poll the detector; apply any expiries as ONE coalesced update.

        Call once per dispatch (the serving tier does) — a whole failure
        storm between two batches lands as a single device-state upload.
        With a placement tier attached, each tick also emits ONE bounded
        repair batch (the repairer's budget), so re-replication bandwidth
        is metered by the dispatch cadence.
        """
        events = self.apply(self.detector.poll())
        if self._placement is not None:
            self._placement.tick()
        if self.tracer is not None:
            now_us = int(self.clock.now() * 1_000_000)
            self.tracer.record(
                SPAN_LIFECYCLE_TICK, now_us, now_us,
                events=len(events), epoch=self.epoch,
            )
        return events

    # -- membership events (all journaled) -----------------------------------
    def apply(self, transitions) -> list:
        """Apply ``("fail"|"recover", slot)`` pairs under one coalesced
        device update; journal each.  Returns the recorded events."""
        recorded = []
        if not transitions:
            return recorded
        with self.router.coalesced_events():
            for kind, slot in transitions:
                if kind == "fail":
                    self.router.fail(slot)
                elif kind == "recover":
                    self.router.recover(slot)
                else:
                    raise ValueError(f"unknown transition kind {kind!r}")
                recorded.append(self.journal.record(kind, slot))
        self._forget_retired()
        self._sync_placement()
        return recorded

    def _sync_placement(self) -> None:
        """Membership changed: re-enumerate the placement repair backlog."""
        if self._placement is not None:
            self._placement.sync()

    def _forget_retired(self) -> None:
        """Drop detector tracks for slots the control plane retired (failing
        the top slot is a LIFO retirement that may GC tombstones too)."""
        total = self.router.domain.total_count
        for slot in self.detector.slots:
            if slot >= total:
                self.detector.forget(slot)

    def fail(self, slot: int) -> None:
        """Operator-initiated failure (journaled; detector aligned)."""
        self.router.fail(slot)
        self.journal.record("fail", slot)
        if slot in self.router.domain.removed:
            self.detector.mark_removed(slot)
        self._forget_retired()
        self._sync_placement()

    def recover(self, slot: int) -> None:
        """Operator-initiated recovery (journaled; detector re-admits)."""
        self.router.recover(slot)
        self.journal.record("recover", slot)
        self.detector.register(slot)
        self._sync_placement()

    def scale_up(self) -> int:
        new = self.router.scale_up()
        self.journal.record("scale_up", new)
        self.detector.register(new)
        self._sync_placement()
        return new

    def scale_down(self) -> int:
        gone = self.router.scale_down()
        self.journal.record("scale_down", gone)
        # the retirement may have garbage-collected tombstones off the end
        for slot in self.detector.slots:
            if slot >= self.router.domain.total_count:
                self.detector.forget(slot)
        self._sync_placement()
        return gone

    # -- routing (degradation-guarded, epoch-stamped) ------------------------
    def _guard(self) -> str:
        mode = self.mode
        if mode == MODE_UNAVAILABLE:
            raise FleetUnavailableError(epoch=self.epoch)
        if mode == MODE_DEGRADED and self.config.strict_floor:
            raise FleetDegradedError(
                self.n_alive, self.config.min_alive_floor, epoch=self.epoch
            )
        return mode

    def route_keys(self, keys) -> RoutedBatch:
        mode = self._guard()
        return RoutedBatch(self.router.route_keys(keys), self.epoch, mode)

    def route_keys_np(self, keys) -> RoutedBatch:
        mode = self._guard()
        return RoutedBatch(self.router.route_keys_np(keys), self.epoch, mode)

    def route_batch(self, session_ids) -> RoutedBatch:
        mode = self._guard()
        return RoutedBatch(self.router.route_batch(session_ids), self.epoch, mode)

    # -- crash recovery ------------------------------------------------------
    def _domain_factory(self, n: int):
        """Build a domain EXACTLY like the router's control plane builds
        its oracle — same engine flavour, omega and resolution."""
        return FailureDomain(
            n,
            engine=make_bulk(self.router.spec.engine).scalar_engine,
            chain_bits=32,
            omega=self.router.spec.omega,
            max_chain=self.router.max_chain,
            resolve="table",
            allow_empty=True,
        )

    def snapshot(self) -> JournalSnapshot:
        return JournalSnapshot.capture(self.epoch, self.router.domain)

    def rebuild_domain(self, snapshot: JournalSnapshot | None = None):
        """Rebuild the control plane from the log (and optional snapshot)."""
        if snapshot is None:
            return replay(self.journal, self._domain_factory)
        return restore(
            snapshot, self._domain_factory, self.journal.events(since=snapshot.epoch)
        )

    def verify_replay(self, snapshot: JournalSnapshot | None = None) -> None:
        """Assert replay(journal) == live state, bit-exactly — the scalar
        control plane AND the packed device operands (the leaves of the
        router's host ``FleetState`` and, outside a coalesced burst, of its
        device twin).  Raises on mismatch."""
        rebuilt = self.rebuild_domain(snapshot)
        live = self.router.domain
        if rebuilt.total_count != live.total_count:
            raise AssertionError(
                f"replay n_total {rebuilt.total_count} != live {live.total_count}"
            )
        if rebuilt.removed != live.removed:
            raise AssertionError(
                f"replay removed {sorted(rebuilt.removed)} != live "
                f"{sorted(live.removed)}"
            )
        rt_new, rt_live = rebuilt.replacement_table, live.replacement_table
        if (
            rt_new.slots != rt_live.slots
            or rt_new.pos != rt_live.pos
            or rt_new.n_alive != rt_live.n_alive
        ):
            raise AssertionError("replayed ReplacementTable differs from live")
        packed = FleetState.pack(rebuilt, self.router.spec.capacity)
        host = self.router._fleet_host
        for leaf in ("packed", "table", "state"):
            if not np.array_equal(getattr(packed, leaf), getattr(host, leaf)):
                raise AssertionError(
                    f"replayed device operand {leaf!r} differs from live"
                )
        if self.router._state_dirty and not self.router._coalescing:
            self.router._flush_events()
        if not self.router._state_dirty:
            twin, dev = packed.to(self.router.device), self.router._fleet_dev
            for leaf in ("packed", "table", "state"):
                if not torch.equal(getattr(twin, leaf), getattr(dev, leaf)):
                    raise AssertionError(
                        f"replayed device operand {leaf!r} differs from the "
                        "router's device twin"
                    )


# ---------------------------------------------------------------------------
# placement repair scheduling (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RepairTask:
    """One executed repair copy: ``key``'s replica column ``column`` was
    re-materialised on ``dst`` from the reachable copy on ``src``.
    ``epoch`` is the journal epoch the under-replication was first
    observed at (the oldest-first scheduling key)."""

    key_index: int
    key: int
    column: int
    dst: int
    src: int
    epoch: int


class PlacementRepairer:
    """Bounded-bandwidth repair scheduler: drives a ``StorePlacement``'s
    holders back to the target placement after membership events.

    Attaches to a ``LifecycleManager`` (same fleet as the store's router):
    every journaled membership mutation triggers ``sync()`` — one device
    pass re-enumerating the under-replicated ``(key, column)`` pairs, each
    stamped with the journal epoch it was FIRST observed at — and each
    ``tick()`` emits at most ``budget_per_tick`` repair copies, oldest
    epoch first.  Crash recovery needs no repair journal of its own: the
    target placement is a pure function of the membership journal's fleet
    state, so replaying the journal reproduces it bit-exactly
    (``verify_placement_replay``); the backlog is then re-enumerated from
    the surviving holders.
    """

    def __init__(self, store, manager: LifecycleManager,
                 budget_per_tick: int = 64):
        if store.router is not manager.router:
            raise ValueError(
                "store and manager must wrap the SAME router: the repairer "
                "schedules against the fleet the journal records"
            )
        if budget_per_tick < 1:
            raise ValueError(
                f"budget_per_tick must be >= 1, got {budget_per_tick}"
            )
        self.store = store
        self.manager = manager
        self.budget_per_tick = budget_per_tick
        # the backlog, oldest first-observed epoch first (then by key index
        # and column): the reference's (key_index, column) -> (dst, epoch)
        # dict, held as arrays in its execution order; entries before
        # _next are done
        empty = np.zeros(0, np.int64)
        self._code = empty  # key_index * r + column
        self._dst = empty
        self._epoch = empty
        self._next = 0
        #: repair copies executed / keys found with no reachable source
        self.completed = 0
        self.lost = 0
        #: per-tick emitted batch sizes — the bounded-bandwidth audit trail
        self.batches: list[int] = []
        manager._placement = self
        self.sync()

    @property
    def backlog(self) -> int:
        return self._code.size - self._next

    # -- enumeration ---------------------------------------------------------
    def sync(self) -> int:
        """Re-enumerate under-replication against the CURRENT fleet (one
        device pass via ``StorePlacement.sync_targets``).  Tasks still
        needed keep their first-observed epoch — oldest-first ordering
        survives re-syncs; tasks obsoleted by the new target are dropped.
        Returns the backlog size.  With ``n_alive == 0`` nothing is
        schedulable; the backlog is left as-is until capacity returns."""
        if self.manager.n_alive == 0:
            return self.backlog
        ki, col, dst = self.store.sync_target_arrays()
        code = ki * self.store.r + col
        # a task still pending for the same (key, column) and destination
        # keeps its epoch; every other one is first observed now
        epoch = np.full(code.shape, self.manager.epoch, np.int64)
        pending = slice(self._next, None)
        order = np.argsort(self._code[pending])
        prev_code = self._code[pending][order]
        if prev_code.size and code.size:
            at = np.minimum(np.searchsorted(prev_code, code), prev_code.size - 1)
            keep = (prev_code[at] == code) & (self._dst[pending][order][at] == dst)
            epoch[keep] = self._epoch[pending][order][at][keep]
        run = np.lexsort((code, epoch))
        self._code, self._dst, self._epoch, self._next = code[run], dst[run], epoch[run], 0
        return self.backlog

    # -- bounded execution ---------------------------------------------------
    def tick(self, budget: int | None = None) -> list[RepairTask]:
        """Emit ONE repair batch: at most ``budget`` copies (default the
        configured per-tick budget), oldest first-observed epoch first.
        Keys whose every copy is unreachable are counted in ``lost`` and
        re-enumerated at the next membership sync."""
        if not self.backlog:
            return []
        budget = self.budget_per_tick if budget is None else budget
        take = slice(self._next, self._next + max(budget, 0))
        self._next = min(self._next + max(budget, 0), self._code.size)
        r = self.store.r
        done: list[RepairTask] = []
        for code, dst, epoch in zip(self._code[take].tolist(), self._dst[take].tolist(),
                                    self._epoch[take].tolist()):
            ki, col = divmod(code, r)
            src = self.store.repair_source(ki)
            if src < 0:
                self.lost += 1
                continue
            self.store.complete_repair(ki, col, dst)
            done.append(RepairTask(
                key_index=ki, key=int(self.store.keys[ki]), column=col,
                dst=dst, src=src, epoch=epoch,
            ))
        self.completed += len(done)
        if done:
            self.batches.append(len(done))
        return done

    def quiesce(self, max_ticks: int = 100_000) -> int:
        """Drain the backlog in budgeted batches; returns copies executed."""
        total = 0
        for _ in range(max_ticks):
            if not self.backlog:
                break
            total += len(self.tick())
        return total

    # -- crash recovery ------------------------------------------------------
    def verify_placement_replay(self, snapshot=None) -> None:
        """Assert placement(replayed journal) == live placement bit-exactly:
        the manager's device-operand replay parity, then the full R-way
        placement of every registered key recomputed, on the router's
        device, from the rebuilt fleet state.  Raises ``AssertionError`` on
        mismatch."""
        self.manager.verify_replay(snapshot)
        if self.store.keys.size == 0 or self.manager.n_alive == 0:
            return
        router = self.manager.router
        rebuilt = self.manager.rebuild_domain(snapshot)
        fleet = FleetState.pack(rebuilt, router.spec.capacity).to(router.device)
        replayed, _ = ops.route_replicas_bulk(
            router._coerce_keys(self.store.keys), fleet, self.store.spec
        )
        live, _ = self.store.place_keys(self.store.keys)
        if not torch.equal(replayed, live):
            raise AssertionError(
                "replayed placement differs from live placement"
            )
