"""Typed lifecycle errors — the degradation layer's contract with callers.

``BatchRouter.route_*``, ``SessionRouter.route``, ``ServingTier.serve``,
``LifecycleManager`` and ``StorePlacement`` raise these instead of tripping
over an internal ``ValueError`` deep in the scalar oracle: an all-failed
fleet is a *defined* state with a *typed* answer, not undefined behavior
(DESIGN.md §12).
"""
from __future__ import annotations


#: fleet/placement health modes, ordered by health — shared by the lifecycle
#: manager's ``RoutedBatch`` and the placement tier's ``PlacedBatch``
MODE_NORMAL = "normal"
MODE_DEGRADED = "degraded"
MODE_UNAVAILABLE = "unavailable"


class LifecycleError(RuntimeError):
    """Base class for fleet-lifecycle errors."""


class FleetUnavailableError(LifecycleError):
    """Every replica is failed: there is no alive slot to route to.

    Raised by the route entry points *before* any device dispatch (the
    kernels never see ``n_alive == 0``).  Recover or scale up to clear it.
    """

    def __init__(self, message: str | None = None, *, epoch: int | None = None):
        if message is None:
            message = "fleet unavailable: no alive replicas to route to"
            if epoch is not None:
                message += f" (epoch {epoch})"
        super().__init__(message)
        #: routing epoch at which the fleet was observed unavailable (None
        #: when the raising layer does not track epochs)
        self.epoch = epoch


class FleetDegradedError(LifecycleError):
    """``n_alive`` fell below the configured floor and the lifecycle policy
    is strict: routing is refused until capacity recovers.

    Only raised when ``LifecycleConfig.strict_floor`` is set; the default
    policy keeps routing (mode ``"degraded"``) and lets the caller decide.
    """

    def __init__(self, n_alive: int, floor: int, *, epoch: int | None = None):
        super().__init__(
            f"fleet degraded: {n_alive} alive replica(s) below the "
            f"min_alive floor of {floor}"
        )
        self.n_alive = n_alive
        self.floor = floor
        self.epoch = epoch


class PlacementDegradedError(LifecycleError):
    """Fewer alive shards than the replication factor: full R-way
    replication is impossible and the placement policy is strict.

    Mirrors ``FleetDegradedError`` one tier up: the default placement
    policy keeps placing (mode ``"degraded"``, every key on all ``n_alive``
    distinct shards) and lets the caller decide; ``strict=True`` turns the
    shortfall into this typed refusal instead.
    """

    def __init__(self, n_alive: int, r: int, *, epoch: int | None = None):
        super().__init__(
            f"placement degraded: {n_alive} alive shard(s) cannot hold "
            f"{r} distinct replicas"
        )
        self.n_alive = n_alive
        self.r = r
        self.epoch = epoch


class ClockWentBackwardsError(LifecycleError):
    """The failure detector's clock returned a timestamp earlier than one it
    already handed out.

    Deadline detection is only sound over a monotone time source: a regressed
    ``now`` silently shrinks every silence window and can un-expire suspect
    timers.  Rather than corrupt the state machine, the detector refuses the
    reading — fix the clock (or the test's ``ManualClock`` choreography).
    """

    def __init__(self, now: float, last: float):
        super().__init__(
            f"clock went backwards: now={now} < last observed {last}; "
            "failure-detector deadlines require a monotone clock"
        )
        self.now = now
        self.last = last


#: admission-rejection reason codes (``AdmissionRejectedError.reason``)
SHED_PAST_DEADLINE = "past_deadline"
SHED_INFEASIBLE = "deadline_infeasible"
SHED_RATE_LIMITED = "rate_limited"
SHED_LATE = "late_at_batch_close"


class AdmissionRejectedError(LifecycleError):
    """A streaming request was shed at admission (or batch close) instead of
    being served past its deadline.

    Typed so callers can distinguish load shedding from infrastructure
    failure: a shed request is the *admission controller working*, carrying
    the machine-readable ``reason`` (one of the ``SHED_*`` codes) and the
    tenant it was charged to.
    """

    def __init__(
        self,
        reason: str,
        *,
        tenant: str | None = None,
        deadline_us: int | None = None,
        now_us: int | None = None,
    ):
        msg = f"request shed: {reason}"
        if tenant is not None:
            msg += f" (tenant {tenant!r})"
        if deadline_us is not None and now_us is not None:
            msg += f" [deadline_us={deadline_us}, now_us={now_us}]"
        super().__init__(msg)
        self.reason = reason
        self.tenant = tenant
        self.deadline_us = deadline_us
        self.now_us = now_us


class PlacementExhaustedError(LifecycleError):
    """The bounded re-salt chain ran out of probes before finding a distinct
    alive shard for some key, even though enough alive shards exist.

    Only reachable with an explicit ``PlacementSpec.max_resalt`` below the
    distinctness-guaranteeing default — the default bound of ``r`` probes
    per column makes exhaustion impossible whenever ``n_alive`` exceeds the
    column index.  Typed so a too-tight bound is a loud error, never a
    silent duplicate replica.
    """

    def __init__(
        self, n_keys: int, max_resalt: int, *, epoch: int | None = None
    ):
        super().__init__(
            f"placement exhausted: {n_keys} key(s) found no distinct alive "
            f"shard within {max_resalt} re-salt probe(s); raise max_resalt "
            "(None guarantees distinctness) or accept degraded placement"
        )
        self.n_keys = n_keys
        self.max_resalt = max_resalt
        self.epoch = epoch
