"""R-way replicated store placement on top of any ``BULK_ENGINES`` engine
(DESIGN.md §13) — the counterpart of ``repro.placement.store``.

The paper's actual use case is data placement: "distributed storage systems
rely on consistent hashing for scalable and fault-tolerant data
partitioning."  A router maps a key to exactly ONE shard, so a single
failure makes the key's data unreachable until the divert reroutes it —
and the rerouted shard does not *have* the data.  This module turns the
router into a placement system: every key lives on **R distinct alive
shards**, failures degrade reads to the surviving replica set, and
membership changes produce an explicit, bounded migration plan instead of
silent rerouting.

Three layers:

* ``route_replicas_impl`` / ``placement_diff_impl`` — the device passes,
  here as the plain torch versions of the placement kernels: R salted key
  families (``family_keys``) go through the engine's fused route, then the
  distinct-resolution pass (``repro_torch.core.placement_torch``) breaks
  collisions between columns.  The default bound of ``r`` probes makes
  distinctness DETERMINISTIC whenever ``n_alive > column``, so every key
  gets exactly ``min(r, n_alive)`` distinct alive shards.  On the card
  ``repro_torch.kernels.ops.route_replicas_bulk`` runs them as one kernel
  launch (``place``; past r = 8 the family route and ``resolve``, two).

* ``StorePlacement`` — the host control plane: guarded placement with typed
  degradation (``n_alive == 0`` stays ``FleetUnavailableError``;
  ``n_alive < r`` is mode ``"degraded"`` or a ``PlacementDegradedError``
  under ``strict=True``; a too-tight explicit ``max_resalt`` surfaces as
  ``PlacementExhaustedError``, never a silent duplicate), a registry of
  placed keys with their current *holders* (where the data physically is —
  which lags the target placement until repair completes), degraded reads
  from the surviving holder set, and ``plan_migration`` — the old-vs-new
  placement diff in one device pass.  The device is the router's; no work
  moves to the CPU.

* Over failure domains (``StorePlacement(..., domains=FailureDomains)``:
  racks of DataNodes) the ``r`` columns are ``r`` distinct alive racks, the
  placement above over the rack fleet, and each column's DataNode is the
  route of a node key of its own inside its rack (``ops.route_racks_bulk``:
  one launch more); the guard and the degraded mode count racks, so fewer
  than ``r`` alive racks is ``"degraded"`` (or ``PlacementDegradedError``
  under ``strict``), never a silent shared rack.

* ``PlacementRepairer`` (``repro_torch.serving.lifecycle.manager``) — the
  repair scheduler that drives holders back to the target placement in
  bounded-bandwidth batches after every journaled membership event.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bulk import FailureDomains, FleetState, PlacementSpec, RackFleet
from repro_torch.core.placement_torch import (  # noqa: F401  (re-exported)
    RESALT_SALT,
    family_keys,
    family_salts,
    resolve_columns,
)
from repro_torch.kernels import ops
from repro_torch.observability.trace import (
    SPAN_PLACE_COERCE,
    SPAN_PLACE_GUARD,
    SPAN_PLACE_KEYS,
    SPAN_PLACE_LAUNCH,
    SPAN_PLAN,
    SPAN_PLAN_COPY_BACK,
    SPAN_PLAN_DIFF,
    SPAN_PLAN_FLEET_UP,
    SPAN_PLAN_KEYS_UP,
)
from repro_torch.placement.assignment import MovementPlan
from repro_torch.serving.lifecycle.errors import (
    MODE_DEGRADED,
    MODE_NORMAL,
    FleetUnavailableError,
    PlacementDegradedError,
    PlacementExhaustedError,
)

#: sentinel holder id: "this replica column holds no copy anywhere"
NO_HOLDER = -1


# ---------------------------------------------------------------------------
# the device passes (plain versions)
# ---------------------------------------------------------------------------


def route_replicas_impl(
    keys: torch.Tensor, packed: torch.Tensor, table: torch.Tensor, state: torch.Tensor,
    *, r: int, omega: int, max_resalt: int, route,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Place every key on ``r`` distinct alive shards.

    keys         any int shape (u32 key space)
    packed / table / state — the ``FleetState`` leaves (``n_alive >= 1``
                 is the caller-guarded precondition, as for ``route_bulk``)
    max_resalt   probe bound per column (``PlacementSpec`` resolves
                 ``None`` to ``r``, the distinctness guarantee)
    route        the engine's plain fused route
                 ``(keys, packed, table, state, omega)``

    Returns ``(replicas, exhausted)``: ``replicas`` is ``(*keys.shape, r)``
    int32, every entry an ALIVE shard; column ``j`` is distinct from columns
    ``< j`` whenever ``n_alive > j`` and the probe bound sufficed, and a
    duplicate of an earlier column otherwise (degraded replication).
    ``exhausted`` (keys' shape, bool) is set where distinctness was
    achievable but ``max_resalt`` probes ran out — impossible at the
    default bound.
    """
    base = route(family_keys(keys, r), packed, table, state, omega)
    replicas, exhausted, _ = resolve_columns(keys, base, table, state, max_resalt)
    return replicas.reshape(*keys.shape, r), exhausted.reshape(keys.shape)


def placement_diff_impl(
    keys, old_packed, old_table, old_state, new_packed, new_table, new_state,
    *, r: int, omega: int, max_resalt: int, route,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Old-vs-new placement diff — the bulk migration plan.

    Routes the keys under BOTH fleet states and marks every (key, column)
    pair whose new shard holds no copy under the old placement:
    ``moved[i, j] = new[i, j] not in old[i, :]`` — membership, not
    positional inequality, because a replica that merely swapped columns
    needs no data transfer.  Returns ``(old, new, moved, exhausted_new)``.
    """
    old, _ = route_replicas_impl(
        keys, old_packed, old_table, old_state, r=r, omega=omega,
        max_resalt=max_resalt, route=route,
    )
    base = route(family_keys(keys, r), new_packed, new_table, new_state, omega)
    new, exhausted, moved = resolve_columns(
        keys, base, new_table, new_state, max_resalt, old.reshape(-1, r)
    )
    shape = (*keys.shape, r)
    return old, new.reshape(shape), moved.reshape(shape), exhausted.reshape(keys.shape)


# ---------------------------------------------------------------------------
# host plans
# ---------------------------------------------------------------------------


class PlacedBatch(NamedTuple):
    """A placed key batch + the epoch/mode it was computed under (the
    placement tier's mirror of the lifecycle ``RoutedBatch``)."""

    replicas: object  #: (N, r) int32 alive shard ids (numpy), distinct per
    #: row up to min(r, n_alive)
    epoch: int
    mode: str  #: MODE_NORMAL, or MODE_DEGRADED when n_alive < r
    n_distinct: int  #: min(r, n_alive) at placement time


@dataclasses.dataclass
class MigrationPlan:
    """The materialised old-vs-new placement diff of one membership change.

    keys   (M,) u32; old/new (M, r) int32 placements; moved (M, r) bool —
    True where ``new[i, j]`` holds no copy under ``old[i, :]`` (a genuine
    data transfer, computed on the device by ``placement_diff_bulk``).
    """

    keys: np.ndarray
    old: np.ndarray
    new: np.ndarray
    moved: np.ndarray
    epoch: int = 0

    @property
    def total_pairs(self) -> int:
        return int(self.moved.size)

    @property
    def moved_pairs(self) -> int:
        return int(self.moved.sum())

    @property
    def moved_fraction(self) -> float:
        return self.moved_pairs / max(self.total_pairs, 1)

    def per_shard_moves(self) -> dict[int, list[tuple[int, int]]]:
        """Destination shard -> [(key, source shard)] move lists — the
        worker-facing transfer schedule.  The source is the same-column old
        holder (a shard that had a copy under the old placement; the
        repairer re-picks a *reachable* source at execution time)."""
        out: dict[int, list[tuple[int, int]]] = {}
        for i, j in zip(*np.nonzero(self.moved)):
            out.setdefault(int(self.new[i, j]), []).append(
                (int(self.keys[i]), int(self.old[i, j]))
            )
        return out

    def as_movement_plan(self) -> MovementPlan:
        """The host ``MovementPlan`` view over the device diff (one source
        of truth for movement accounting — ``moved_fraction`` here counts
        transfer pairs, not positional changes)."""
        r = self.new.shape[1]
        return MovementPlan.from_diff(
            np.repeat(self.keys, r),
            self.old.reshape(-1),
            self.new.reshape(-1),
            moved=self.moved.reshape(-1),
        )


# ---------------------------------------------------------------------------
# the placement control plane
# ---------------------------------------------------------------------------


def _as_u32(keys) -> np.ndarray:
    """Keys as the registry holds them: (M,) uint32, truncated like the
    scalar oracle."""
    return np.ascontiguousarray(keys, dtype=np.uint64).astype(np.uint32).reshape(-1)


class StorePlacement:
    """R-way replicated placement over a ``BatchRouter``'s fleet.

    Wraps (composition, like ``LifecycleManager``) a router exposing the
    fleet surface — ``spec``, ``device``, ``domain``,
    ``_fleet_host``/``_fleet_dev``, ``routing_epoch`` — and adds the
    placement tier: guarded R-way ``place``, a registry of placed keys with
    their physical *holders* (which lag the target placement until repair
    completes), degraded reads, and the one-device-pass migration diff.
    Placement runs on the router's device, and records its stages into the
    router's ``tracer`` when it has one (``place_keys``: guard, coercion,
    launch; ``plan_migration``: the keys up, the fleets up, the diff, the
    copy back).
    """

    def __init__(self, router, r: int = 3, *, max_resalt: int | None = None,
                 strict: bool = False, domains: FailureDomains | None = None):
        """``domains``: place over these failure domains (the router's
        replicas are their DataNodes, and it tracks them from now on:
        ``BatchRouter.attach_domains``)."""
        self.router = router
        self.spec = PlacementSpec(router=router.spec, r=r, max_resalt=max_resalt,
                                  domains=domains)
        if domains is not None:
            router.attach_domains(domains)
        #: strict=True turns an n_alive < r placement into a typed
        #: PlacementDegradedError instead of a degraded-mode batch
        self.strict = strict
        self._keys = np.zeros((0,), np.uint32)
        self._holders = np.zeros((0, r), np.int64)
        #: fleet snapshot the registered holders were last synced against —
        #: the implicit "old" side of plan_migration()
        self._synced_fleet = self._fleet_snapshot()
        self._alive_at: tuple[int, np.ndarray, list] | None = None

    # -- fleet state access --------------------------------------------------
    @property
    def r(self) -> int:
        return self.spec.r

    @property
    def epoch(self) -> int:
        return self.router.routing_epoch

    @property
    def n_alive(self) -> int:
        return self.router.domain.alive_count

    @property
    def n_distinct(self) -> int:
        """Distinct alive places a key's columns can take: alive racks over
        failure domains, else alive shards."""
        if self.spec.domains is not None:
            return self.router.racks.alive_racks
        return self.n_alive

    def _fleet_snapshot(self) -> FleetState | RackFleet:
        if self.spec.domains is not None:
            return self.router.racks.host.copy()
        h = self.router._fleet_host
        return FleetState(h.packed.copy(), h.table.copy(), h.state.copy(), h.capacity)

    def _fleet_dev(self) -> FleetState:
        """The router's device twin (flushing coalesced events)."""
        self.router._check_routable()
        return self.router._fleet_dev

    def _alive(self) -> tuple[np.ndarray, list]:
        """(capacity,) bool — slot id alive right now — as an array and as a
        list, rebuilt once per routing epoch (every membership event moves
        the epoch)."""
        epoch = self.router.routing_epoch
        if self._alive_at is None or self._alive_at[0] != epoch:
            dom = self.router.domain
            alive = np.zeros(self.router.spec.capacity, bool)
            alive[: dom.total_count] = True
            alive[list(dom.removed)] = False
            self._alive_at = (epoch, alive, alive.tolist())
        return self._alive_at[1:]

    # -- guarded placement ---------------------------------------------------
    def _guard(self) -> str:
        if self.n_alive == 0:
            raise FleetUnavailableError(epoch=self.epoch)
        n = self.n_distinct
        if n < self.spec.r:
            if self.strict:
                raise PlacementDegradedError(n, self.spec.r, epoch=self.epoch)
            return MODE_DEGRADED
        return MODE_NORMAL

    def place_keys(self, keys) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw device placement: ``(replicas (N, r) int32, exhausted (N,)
        bool)`` on the router's device, no degradation typing (the expert
        path; ``place`` wraps it).  Routability (``n_alive >= 1``) is still
        enforced."""
        router = self.router
        tr = router.tracer
        if tr is None:
            return self._place_keys(keys, None)
        router.traced_calls += 1
        root = tr.open(SPAN_PLACE_KEYS, router.traced_calls)
        try:
            return self._place_keys(keys, tr)
        finally:
            tr.close(root)

    def _place_keys(self, keys, tr) -> tuple[torch.Tensor, torch.Tensor]:
        if tr is not None:
            tr.open(SPAN_PLACE_GUARD)
        if self.spec.domains is None:
            fleet, place = self._fleet_dev(), ops.route_replicas_bulk
        else:
            fleet, place = self.router.racks_dev, ops.route_racks_bulk
        if tr is not None:
            tr.next(SPAN_PLACE_COERCE)
        keys = self.router._coerce_keys(keys)
        if tr is not None:
            tr.next(SPAN_PLACE_LAUNCH)  # closed with its root, at one clock reading
        return place(keys, fleet, self.spec)

    def place(self, keys) -> PlacedBatch:
        """Place keys on ``r`` distinct alive shards (over failure domains,
        in ``r`` distinct alive racks), typed and epoch-stamped:
        ``FleetUnavailableError`` at ``n_alive == 0``; fewer alive shards
        (racks) than ``r`` degrades (every key on all ``n_distinct`` of
        them) or raises under ``strict=True``; an exhausted re-salt chain
        (explicit ``max_resalt`` below the default only) raises
        ``PlacementExhaustedError``."""
        mode = self._guard()
        replicas, exhausted = self.place_keys(keys)
        n_exhausted = int(exhausted.sum())
        if n_exhausted:
            raise PlacementExhaustedError(
                n_exhausted, self.spec.resolved_max_resalt, epoch=self.epoch,
            )
        return PlacedBatch(
            replicas.cpu().numpy(), self.epoch, mode, min(self.spec.r, self.n_distinct),
        )

    # -- the registered store ------------------------------------------------
    @property
    def keys(self) -> np.ndarray:
        """(M,) u32 registered keys."""
        return self._keys

    @property
    def holders(self) -> np.ndarray:
        """(M, r) int64 physical holders per registered key — where copies
        actually are, which lags the target placement until repair
        completes.  ``NO_HOLDER`` marks a column with no copy anywhere."""
        return self._holders

    def register(self, keys) -> PlacedBatch:
        """Place new keys and record them as stored: their holders start at
        the current target placement (writes go to the placement)."""
        keys_u32 = _as_u32(keys)
        batch = self.place(keys_u32)
        self._keys = np.concatenate([self._keys, keys_u32])
        self._holders = np.concatenate(
            [self._holders, np.asarray(batch.replicas, np.int64)], axis=0
        )
        self._synced_fleet = self._fleet_snapshot()
        return batch

    def reachable_mask(self) -> np.ndarray:
        """(M, r) bool — holder column is a DISTINCT, alive copy (duplicate
        holder entries count once; dead/retired/lost columns are False)."""
        return self._reachable(self._holders)

    def _reachable(self, h: np.ndarray) -> np.ndarray:
        alive = self._alive()[0]
        valid = (h >= 0) & (h < alive.size)
        live = np.zeros(h.shape, bool)
        live[valid] = alive[h[valid]]
        # first-occurrence filter: a duplicated shard id is one copy
        first = np.ones(h.shape, bool)
        for j in range(1, h.shape[1]):
            for k in range(j):
                first[:, j] &= h[:, j] != h[:, k]
        return live & first

    def reachable_counts(self) -> np.ndarray:
        """(M,) distinct alive copies per registered key — the durability
        metric (>= 1 while ``n_alive >= 1``; == min(r, n_alive) once repair
        quiesces)."""
        return self.reachable_mask().sum(axis=1).astype(np.int64)

    def _reachable_holders(self, key_index: int) -> list[int]:
        """One key's row of ``reachable_mask``, as the holders it keeps."""
        alive = self._alive()[1]
        found: list[int] = []
        for s in self._holders[key_index].tolist():
            if 0 <= s < len(alive) and alive[s] and s not in found:
                found.append(s)
        return found

    def read(self, key_index: int) -> tuple[np.ndarray, str]:
        """Degraded read: the distinct alive holders of one registered key,
        plus the mode they represent.  ``FleetUnavailableError`` when no
        copy is reachable (fleet empty, or — durability lost — every
        holder dead)."""
        if self.n_alive == 0:
            raise FleetUnavailableError(epoch=self.epoch)
        found = self._reachable_holders(key_index)
        if not found:
            raise FleetUnavailableError(
                f"key {int(self._keys[key_index])} has no reachable replica "
                f"(all holders failed)", epoch=self.epoch,
            )
        mode = MODE_NORMAL if len(found) >= min(self.spec.r, self.n_distinct) else MODE_DEGRADED
        return np.asarray(found, np.int64), mode

    # -- migration + repair enumeration --------------------------------------
    def plan_migration(self, old_fleet: FleetState | RackFleet | None = None) -> MigrationPlan:
        """Diff the registered keys' placement between ``old_fleet`` (a host
        ``FleetState``, over failure domains a host ``RackFleet``; default:
        the snapshot captured at the last register/sync) and the CURRENT
        fleet — one device pass over both placements (DESIGN.md §13)."""
        tr = self.router.tracer
        if tr is None:
            return self._plan_migration(old_fleet, None)
        root = tr.open(SPAN_PLAN, self.epoch)
        try:
            return self._plan_migration(old_fleet, tr)
        finally:
            tr.close(root)

    def _plan_migration(self, old_fleet, tr) -> MigrationPlan:
        old = old_fleet if old_fleet is not None else self._synced_fleet
        if tr is not None:
            tr.open(SPAN_PLAN_KEYS_UP)
        keys = self.router._coerce_keys(self._keys)
        if tr is not None:
            tr.next(SPAN_PLAN_FLEET_UP)
        old = old.to(self.router.device)
        if self.spec.domains is None:
            new, diff = self._fleet_dev(), ops.placement_diff_bulk
        else:
            new, diff = self.router.racks_dev, ops.racks_diff_bulk
        if tr is not None:
            tr.next(SPAN_PLAN_DIFF)
        o, n, moved, _ = diff(keys, old, new, self.spec)
        if tr is not None:
            tr.next(SPAN_PLAN_COPY_BACK)  # closed with its root, at one clock reading
        return MigrationPlan(
            keys=self._keys, old=o.cpu().numpy(), new=n.cpu().numpy(),
            moved=moved.cpu().numpy(), epoch=self.epoch,
        )

    def sync_target_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``sync_targets`` as three int64 arrays ``(key_index, column,
        dst)``, in the same order."""
        empty = np.zeros(0, np.int64)
        if self._keys.size == 0 or self.n_alive == 0:
            return empty, empty, empty
        replicas, _ = self.place_keys(self._keys)
        target = replicas.cpu().numpy().astype(np.int64)
        h = self._holders
        h[h >= self.router.domain.total_count] = NO_HOLDER
        m, r = h.shape
        rows = np.arange(m)
        # target column j takes the first holder column not yet taken that
        # holds its shard (the reference's list.remove of the first match)
        consumed = np.zeros((m, r), bool)
        matched = np.zeros((m, r), bool)
        for j in range(r):
            cand = (h == target[:, j, None]) & ~consumed
            hit = cand.any(axis=1)
            consumed[rows[hit], cand[hit].argmax(axis=1)] = True
            matched[:, j] = hit
        # the k-th unmatched column keeps the k-th unconsumed holder (the
        # stale copy that still serves degraded reads until repaired)
        stale = np.zeros((m, r), np.int64)
        left = ~consumed
        stale[np.nonzero(left)[0], (np.cumsum(left, axis=1) - 1)[left]] = h[left]
        missing = ~matched
        aligned = target.copy()
        mi, mj = np.nonzero(missing)
        aligned[mi, mj] = stale[mi, (np.cumsum(missing, axis=1) - 1)[missing]]
        h[:] = aligned
        self._synced_fleet = self._fleet_snapshot()
        return mi.astype(np.int64), mj.astype(np.int64), target[mi, mj]

    def sync_targets(self) -> list[tuple[int, int, int]]:
        """Recompute the target placement under the current fleet, realign
        the holder rows to it, and return the genuinely missing
        ``(key_index, column, dst_shard)`` repair triples, by key then by
        column.

        Realignment is pure bookkeeping: a holder whose shard appears in
        the target row moves to that column; surviving *stale* copies (old
        shards no longer in the target) keep occupying the to-be-repaired
        columns, in order, so degraded reads still reach them until the
        repair copy overwrites the slot.  Retired slot ids (``>= n_total``:
        LIFO scale-down wiped them) are invalidated to ``NO_HOLDER`` first.
        """
        ki, col, dst = self.sync_target_arrays()
        return list(zip(ki.tolist(), col.tolist(), dst.tolist()))

    def repair_source(self, key_index: int) -> int:
        """A reachable copy to repair from: the first distinct alive holder
        of the key, or ``NO_HOLDER`` if durability is already lost."""
        found = self._reachable_holders(key_index)
        return found[0] if found else NO_HOLDER

    def complete_repair(self, key_index: int, column: int, dst: int) -> None:
        """Record one finished repair copy: the column now holds ``dst``
        (any stale copy previously occupying it is garbage-collected)."""
        self._holders[key_index, column] = dst
