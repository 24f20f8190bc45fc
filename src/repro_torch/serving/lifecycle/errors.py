"""Typed lifecycle errors — the routing datapath's contract with callers.

``BatchRouter.route_*`` and ``SessionRouter.route`` raise these instead of
tripping over an internal ``ValueError`` deep in the scalar oracle: an
all-failed fleet is a *defined* state with a *typed* answer (DESIGN.md §12).
"""
from __future__ import annotations


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
