"""Observability tier: device-rate load telemetry, latency histograms,
span tracing and live theory-bound alarms (DESIGN.md §15) — the counterpart
of ``repro.observability``.

A lock-free ``MetricsRegistry`` over the streaming µs clocks, a
``LoadMonitor`` whose per-shard count rides inside the router's own route
launch (``RoutingKernels.route_load`` on the card, with
``route_with_load_impl`` as its plain version), a ring-buffer
``SpanTrace`` over the request path, JSON/Prometheus exposition, and typed
``BalanceDriftAlarm`` / ``DisruptionBoundAlarm`` when observed behaviour
drifts from the proven bounds.
"""
from repro_torch.observability.alarms import (
    BalanceDriftAlarm,
    DisruptionBoundAlarm,
    ObservabilityAlarm,
    deliver,
)
from repro_torch.observability.export import snapshot, to_json, to_prometheus
from repro_torch.observability.load import (
    DisruptionTracker,
    LoadConfig,
    LoadMonitor,
    disruption_bound,
    expected_peak_over_mean,
    route_with_load_impl,
)
from repro_torch.observability.metrics import (
    DEFAULT_BUCKETS_US,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.observability.trace import (
    SPAN_ADMIT,
    SPAN_BATCH_CLOSE,
    SPAN_DISPATCH,
    SPAN_LIFECYCLE_TICK,
    SPAN_READ,
    SPAN_REQUEST,
    Span,
    SpanTrace,
)

__all__ = [
    "BalanceDriftAlarm",
    "DisruptionBoundAlarm",
    "ObservabilityAlarm",
    "deliver",
    "snapshot",
    "to_json",
    "to_prometheus",
    "DisruptionTracker",
    "LoadConfig",
    "LoadMonitor",
    "disruption_bound",
    "expected_peak_over_mean",
    "route_with_load_impl",
    "DEFAULT_BUCKETS_US",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SPAN_ADMIT",
    "SPAN_BATCH_CLOSE",
    "SPAN_DISPATCH",
    "SPAN_LIFECYCLE_TICK",
    "SPAN_READ",
    "SPAN_REQUEST",
    "Span",
    "SpanTrace",
]
