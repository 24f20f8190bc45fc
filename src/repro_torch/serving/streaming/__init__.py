"""Streaming serving front end: micro-batching with latency SLOs — the
counterpart of ``repro.serving.streaming``.

The subsystem that turns the batch datapath into a *service* (DESIGN.md
§14): an ingest loop accumulating requests up to ``max_wait_us`` /
``max_batch`` and routing them in ONE fused dispatch (double-buffered
against the next batch's fill), deadline-aware admission control with
per-tenant token buckets and typed shedding, hedged degraded reads over
the placement tier, and per-shard circuit breakers driven by the failure
detector's hysteresis.
"""
from repro_torch.serving.streaming.admission import (
    AdmissionConfig,
    AdmissionController,
    TokenBucket,
)
from repro_torch.serving.streaming.batcher import (
    LifecycleDispatch,
    MicroBatcher,
    StreamConfig,
    StreamRequest,
    StreamResult,
)
from repro_torch.serving.streaming.clock import (
    US_PER_S,
    VirtualClockUs,
    WallClockUs,
)
from repro_torch.serving.streaming.frontend import StreamingFrontEnd
from repro_torch.serving.streaming.hedge import (
    BreakerBoard,
    BreakerConfig,
    HedgedRead,
    HedgedReader,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "TokenBucket",
    "LifecycleDispatch",
    "MicroBatcher",
    "StreamConfig",
    "StreamRequest",
    "StreamResult",
    "US_PER_S",
    "VirtualClockUs",
    "WallClockUs",
    "StreamingFrontEnd",
    "BreakerBoard",
    "BreakerConfig",
    "HedgedRead",
    "HedgedReader",
]
