"""Fleet lifecycle hardening: journal, failure detection, degradation —
the counterpart of ``repro.serving.lifecycle``.

The robustness layer around the constant-time routing kernel (DESIGN.md
§12): epoch-journaled membership with bit-exact crash replay, heartbeat
failure detection with hysteresis/quarantine, event-storm coalescing and
typed degraded/unavailable routing modes.
"""
from repro_torch.serving.lifecycle.detector import (
    ALIVE,
    QUARANTINED,
    REMOVED,
    SUSPECT,
    FailureDetector,
    HeartbeatConfig,
    ManualClock,
    MonotonicClock,
)
from repro_torch.serving.lifecycle.errors import (
    SHED_INFEASIBLE,
    SHED_LATE,
    SHED_PAST_DEADLINE,
    SHED_RATE_LIMITED,
    AdmissionRejectedError,
    ClockWentBackwardsError,
    FleetDegradedError,
    FleetUnavailableError,
    LifecycleError,
    PlacementDegradedError,
    PlacementExhaustedError,
)
from repro_torch.serving.lifecycle.journal import (
    EVENT_KINDS,
    JournalSnapshot,
    MembershipEvent,
    MembershipJournal,
    apply_event,
    replay,
    restore,
)
from repro_torch.serving.lifecycle.manager import (
    MODE_DEGRADED,
    MODE_NORMAL,
    MODE_UNAVAILABLE,
    LifecycleConfig,
    LifecycleManager,
    PlacementRepairer,
    RepairTask,
    RoutedBatch,
)

__all__ = [
    "ALIVE",
    "SUSPECT",
    "REMOVED",
    "QUARANTINED",
    "FailureDetector",
    "HeartbeatConfig",
    "ManualClock",
    "MonotonicClock",
    "LifecycleError",
    "AdmissionRejectedError",
    "ClockWentBackwardsError",
    "SHED_PAST_DEADLINE",
    "SHED_INFEASIBLE",
    "SHED_RATE_LIMITED",
    "SHED_LATE",
    "FleetUnavailableError",
    "FleetDegradedError",
    "PlacementDegradedError",
    "PlacementExhaustedError",
    "EVENT_KINDS",
    "MembershipEvent",
    "MembershipJournal",
    "JournalSnapshot",
    "apply_event",
    "replay",
    "restore",
    "LifecycleConfig",
    "LifecycleManager",
    "PlacementRepairer",
    "RepairTask",
    "RoutedBatch",
    "MODE_NORMAL",
    "MODE_DEGRADED",
    "MODE_UNAVAILABLE",
]
