"""The assembled streaming front end: admission → micro-batch → fused
dispatch, plus hedged reads against the placement tier — the counterpart of
``repro.serving.streaming.frontend``.

``StreamingFrontEnd`` is the one object a gateway talks to (DESIGN.md
§14).  It owns a ``MicroBatcher`` whose default dispatch is the
lifecycle-wrapped router (every dispatch ticks the failure detector and
emits one bounded placement-repair batch — the serve path IS the repair
cadence), a ``BreakerBoard`` over the manager's detector, and — when a
``StorePlacement`` is attached — a ``HedgedReader`` for degraded reads.

Everything is deterministic under an injected ``VirtualClockUs``: the
chaos storylines and the serving bench drive the exact same code with a
scripted timeline, and production swaps in ``WallClockUs`` with no other
change.

Telemetry: the front end owns ONE ``MetricsRegistry`` (on its clock) and
one ``SpanTrace`` shared by every component it assembles — pass
``metrics=`` / ``tracer=`` to aggregate several front ends into a common
ledger.  ``stats()`` is an aggregate snapshot over the registry;
``repro_torch.observability.export`` renders the full thing.
"""
from __future__ import annotations

from .admission import AdmissionController
from .batcher import (
    LifecycleDispatch,
    MicroBatcher,
    StreamConfig,
    StreamRequest,
    StreamResult,
)
from .clock import WallClockUs
from .hedge import BreakerBoard, BreakerConfig, HedgedReader


class StreamingFrontEnd:
    """Compose admission control, micro-batching, breakers and hedging
    over a ``LifecycleManager`` (and optionally a ``StorePlacement``)."""

    def __init__(
        self,
        manager,
        store=None,
        config: StreamConfig | None = None,
        clock=None,
        breaker_config: BreakerConfig | None = None,
        dispatch_fn=None,
        service_model=None,
        probe=None,
        metrics=None,
        tracer=None,
    ):
        from repro_torch.observability.metrics import MetricsRegistry
        from repro_torch.observability.trace import SpanTrace

        self.manager = manager
        self.store = store
        self.config = config or StreamConfig()
        self.clock = clock or WallClockUs()
        self.metrics = (
            metrics if metrics is not None else MetricsRegistry(clock=self.clock)
        )
        self.tracer = tracer if tracer is not None else SpanTrace()
        if getattr(manager, "tracer", None) is None:
            manager.tracer = self.tracer
        self.admission = AdmissionController(
            self.config.admission(), metrics=self.metrics
        )
        self.batcher = MicroBatcher(
            dispatch_fn if dispatch_fn is not None else LifecycleDispatch(manager),
            config=self.config,
            clock=self.clock,
            admission=self.admission,
            service_model=service_model,
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self.breakers = BreakerBoard(
            manager.detector, self.clock, breaker_config, metrics=self.metrics
        )
        self.reader = (
            HedgedReader(
                store,
                manager.detector,
                self.breakers,
                self.config.hedge_after_us,
                probe=probe,
                metrics=self.metrics,
                tracer=self.tracer,
                clock=self.clock,
            )
            if store is not None
            else None
        )

    # -- write path (routing) -------------------------------------------------
    def submit(self, request: StreamRequest) -> None:
        """Admit + enqueue (raises ``AdmissionRejectedError`` on shed)."""
        self.batcher.submit(request)

    def pump(self) -> list[StreamResult]:
        """One event-loop turn: observe breakers, close/collect batches."""
        self.breakers.observe()
        return self.batcher.pump()

    def drain(self) -> list[StreamResult]:
        """Flush the pipeline (open batch + in-flight)."""
        self.breakers.observe()
        return self.batcher.drain()

    # -- read path (placement) ------------------------------------------------
    def read(self, key_index: int):
        """Hedged read of one registered key (requires a store)."""
        if self.reader is None:
            raise RuntimeError(
                "no StorePlacement attached: construct StreamingFrontEnd "
                "with store=... to read"
            )
        self.breakers.observe()
        return self.reader.read(key_index)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate snapshot over the shared registry (historical shape);
        ``repro_torch.observability.export.snapshot`` renders every series."""
        b, a = self.batcher, self.admission
        out = {
            "admitted": a.admitted,
            "served": b.served,
            "dispatches": b.dispatches,
            "shed_total": a.shed_total,
            "shed_by_reason": dict(a.shed_by_reason),
            "service_ewma_us": b.service_ewma_us,
            "breaker_trips": self.breakers.trips,
            "breaker_open": list(self.breakers.open_slots),
        }
        if self.reader is not None:
            out.update(
                reads=self.reader.reads,
                hedge_launched=self.reader.hedge_launched,
                hedge_won=self.reader.hedge_won,
            )
        return out
