"""Micro-batching ingest loop: accumulate → one fused dispatch → overlap —
the counterpart of ``repro.serving.streaming.batcher``.

The streaming tier's core (DESIGN.md §14).  Requests accumulate in an open
batch until ``max_batch`` is reached or ``max_wait_us`` elapses, then the
whole batch routes in ONE fused device dispatch through the
lifecycle-wrapped router — the same single-dispatch datapath as the batch
tier, now fed by a continuous stream.  The pipeline is one deep
(double-buffered): while batch *k* computes on the card, batch *k+1* fills
(``LifecycleDispatch`` stages each batch's keys in one of two alternating
pinned host buffers and copies them with ``non_blocking=True`` on the
current stream, so the copy and the route run behind the host); the handle
is only materialised when the next batch closes.

**Deadline discipline.**  Admission (``AdmissionController``) sheds
requests that cannot possibly make their SLO; at batch close the second
gate runs: a request is served only if

    dispatch_start + service_bound_us <= deadline_us + max_wait_us

— i.e. its *predicted* overshoot is at most one batch window.  Everything
else is shed typed (``SHED_LATE``).  Under any service model that honours
the declared ``service_bound_us``, an admitted-and-served request
therefore misses its deadline by AT MOST one batch window — the invariant
the chaos ``overload``/``latency_spike`` storylines assert seed after
seed.  The bound is a *declaration* (an SLO capacity statement), not a
measurement: observed service time is EWMA-tracked into the registry's
``stream_service_ewma_us`` gauge for observability but never silently
substituted into the guarantee.

Telemetry (DESIGN.md §15): served/dispatch counters, batch-size and
per-tenant request-latency histograms all land in the shared
``MetricsRegistry``, and with a ``SpanTrace`` attached the batcher
records the request-path spans (``admit`` at submit, ``batch_close`` +
``dispatch`` at close, one ``request`` span per served request at
collect) on the same µs timeline the batcher itself runs on.

Time is pluggable (``clock.now_us()``): virtual for chaos/bench
determinism, wall for production.  In virtual mode the service model is
injected too; in wall mode the materialisation block is measured.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.serving.lifecycle.errors import SHED_LATE

from .admission import AdmissionConfig, AdmissionController
from .clock import WallClockUs


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs for the streaming front end (all times in µs)."""

    #: close the open batch at this many requests
    max_batch: int = 64
    #: ... or this long after its first request arrived
    max_wait_us: int = 1_000
    #: declared per-dispatch service bound (SLO capacity statement)
    service_bound_us: int = 2_000
    #: hedge a suspect-primary read after this long without a response
    hedge_after_us: int = 300
    #: per-tenant token-bucket rate (requests/s); None = unlimited
    tenant_rate_per_s: float | None = None
    #: per-tenant burst ceiling
    tenant_burst: float = 32.0

    def __post_init__(self):
        if self.max_batch < 1 or self.max_wait_us < 0:
            raise ValueError(
                f"need max_batch >= 1 and max_wait_us >= 0, got "
                f"{self.max_batch} / {self.max_wait_us}"
            )
        if self.service_bound_us <= 0 or self.hedge_after_us < 0:
            raise ValueError(
                f"need service_bound_us > 0 and hedge_after_us >= 0, got "
                f"{self.service_bound_us} / {self.hedge_after_us}"
            )

    def admission(self) -> AdmissionConfig:
        return AdmissionConfig(
            service_bound_us=self.service_bound_us,
            max_wait_us=self.max_wait_us,
            tenant_rate_per_s=self.tenant_rate_per_s,
            tenant_burst=self.tenant_burst,
        )


@dataclasses.dataclass
class StreamRequest:
    """One streamed routing request: a key, the tenant it bills to, and the
    absolute µs deadline its SLO allows."""

    key: int
    deadline_us: int
    tenant: str = "default"
    #: stamped by the batcher at submit
    arrival_us: int = -1


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """A served request: where it routed and when it completed."""

    request: StreamRequest
    replica: int
    t_dispatch_us: int
    t_complete_us: int
    epoch: int
    mode: str

    @property
    def latency_us(self) -> int:
        return self.t_complete_us - self.request.arrival_us

    @property
    def deadline_miss_us(self) -> int:
        """How far past its deadline this request completed (0 = in SLO)."""
        return max(0, self.t_complete_us - self.request.deadline_us)


class LifecycleDispatch:
    """Default dispatch: tick the lifecycle (detector poll + one bounded
    repair batch), copy the key batch to the router's device, ONE fused
    route.  The returned handle is lazy: on a CUDA router the keys go
    through one of two alternating pinned host buffers and an asynchronous
    copy on the current stream, and the route is enqueued behind it, so the
    card works while the next batch fills; ``result()`` is the one
    synchronising copy back.  A buffer is refilled only once the CUDA event
    recorded after its last copy has completed.  On the CPU the keys go to
    the plain path as they are."""

    def __init__(self, mgr, on_events=None):
        self.mgr = mgr
        #: optional callback handed the detector events each tick surfaces
        #: (chaos/observability hooks)
        self.on_events = on_events
        #: the two staging buffers (pinned int32) and each one's copy event
        self._staging: list = [None, None]
        self._copied: list = [None, None]
        self._turn = 0

    def _buffer(self, n: int) -> torch.Tensor:
        """This turn's pinned buffer, at least ``n`` keys long, once its
        previous copy has completed."""
        i = self._turn
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        buf = self._staging[i]
        if buf is None or buf.numel() < n:
            size = 1 << max(6, (n - 1).bit_length())
            buf = self._staging[i] = torch.empty(size, dtype=torch.int32).pin_memory()
        return buf[:n]

    def __call__(self, keys_u32: np.ndarray) -> "_RouteHandle":
        events = self.mgr.tick()
        if events and self.on_events is not None:
            self.on_events(events)
        keys = np.ascontiguousarray(keys_u32, dtype=np.uint32)
        device = self.mgr.router.device
        if device.type != "cuda":
            return _RouteHandle(self.mgr.route_keys(keys))
        host = self._buffer(keys.size)
        host.numpy()[:] = keys.view(np.int32)
        dev = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._copied[self._turn] = event
        self._turn ^= 1
        return _RouteHandle(self.mgr.route_keys(dev))


class _RouteHandle:
    def __init__(self, batch):
        self._batch = batch

    def result(self) -> tuple[np.ndarray, int, str]:
        reps = self._batch.replicas.cpu().numpy().astype(np.int64)
        return reps, self._batch.epoch, self._batch.mode


@dataclasses.dataclass
class _Inflight:
    requests: list
    handle: object
    t_dispatch_us: int
    #: predicted completion (drives pipeline back-pressure + admission ETA)
    eta_us: int


class MicroBatcher:
    """Accumulate → close → dispatch → overlap, with two-stage shedding.

    ``dispatch_fn(keys_u32) -> handle`` routes one closed batch (handle
    materialises to ``(replicas, epoch, mode)``); ``service_model(n)``
    returns simulated per-dispatch service µs (None = measure the
    materialisation block in wall time).
    """

    def __init__(
        self,
        dispatch_fn: Callable[[np.ndarray], object],
        config: StreamConfig | None = None,
        clock=None,
        admission: AdmissionController | None = None,
        service_model: Callable[[int], int] | None = None,
        metrics=None,
        tracer=None,
    ):
        self.config = config or StreamConfig()
        self.clock = clock or WallClockUs()
        self.dispatch_fn = dispatch_fn
        if metrics is None:
            if admission is not None:
                metrics = admission.metrics  # share the controller's ledger
            else:
                from repro_torch.observability.metrics import MetricsRegistry

                metrics = MetricsRegistry(clock=self.clock)
        self.metrics = metrics
        self.tracer = tracer
        self.admission = admission or AdmissionController(
            self.config.admission(), metrics=metrics
        )
        self.service_model = service_model
        self._open: list[StreamRequest] = []
        self._open_since_us: int | None = None
        self._inflight: _Inflight | None = None
        self._last_done_us = 0
        self._completed: list[StreamResult] = []
        #: EWMA of observed service µs (observability only — the guarantee
        #: reasons against the declared bound, never this); mirrored to the
        #: ``stream_service_ewma_us`` gauge on every collect
        self.service_ewma_us: float = float(self.config.service_bound_us)
        self._served = metrics.counter("stream_served_total")
        self._dispatched = metrics.counter("stream_dispatches_total")
        self._batch_sizes = metrics.histogram(
            "stream_batch_size",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )

    #: registry-backed counters, exposed under the historical names
    @property
    def served(self) -> int:
        return self._served.value

    @property
    def dispatches(self) -> int:
        return self._dispatched.value

    # -- pipeline state -------------------------------------------------------
    @property
    def open_depth(self) -> int:
        return len(self._open)

    @property
    def inflight_depth(self) -> int:
        return len(self._inflight.requests) if self._inflight else 0

    def dispatch_eta_us(self, now_us: int) -> int:
        """Earliest possible dispatch start for a request arriving now —
        the one-deep pipeline is busy until the in-flight batch's ETA."""
        eta = self._inflight.eta_us if self._inflight else now_us
        return max(now_us, eta)

    # -- ingest ---------------------------------------------------------------
    def submit(self, request: StreamRequest) -> None:
        """Admit (or raise ``AdmissionRejectedError``) and enqueue."""
        now = self.clock.now_us()
        request.arrival_us = now
        self.admission.admit(
            request.tenant, request.deadline_us, now, self.dispatch_eta_us(now)
        )
        if self.tracer is not None:
            self.tracer.record(
                "admit", now, now, tenant=request.tenant,
                deadline_us=request.deadline_us,
            )
        if not self._open:
            self._open_since_us = now
        self._open.append(request)
        if len(self._open) >= self.config.max_batch:
            self._close(now)

    def pump(self) -> list[StreamResult]:
        """Advance time-driven transitions: close the open batch if its
        window expired, materialise a due in-flight batch, and hand back
        everything completed since the last call."""
        now = self.clock.now_us()
        if self._inflight is not None and now >= self._inflight.eta_us:
            self._collect()
        # close on window expiry only when the pipeline slot is free: while
        # the device is busy the open batch keeps filling (adaptive sizing —
        # dispatching a sliver mid-backlog would waste the dispatch slot and
        # collapse throughput below capacity)
        if (
            self._open
            and self._inflight is None
            and self._open_since_us is not None
            and now - self._open_since_us >= self.config.max_wait_us
        ):
            self._close(now)
        out = self._completed
        self._completed = []
        return out

    def drain(self) -> list[StreamResult]:
        """Flush everything: close any open batch, materialise in-flight."""
        now = self.clock.now_us()
        if self._open:
            self._close(now)
        if self._inflight is not None:
            self._collect()
        out = self._completed
        self._completed = []
        return out

    # -- close + dispatch -----------------------------------------------------
    def _close(self, now_us: int) -> None:
        if self._inflight is not None:
            self._collect()  # one-deep pipeline: the slot must free first
        batch, self._open, self._open_since_us = self._open, [], None
        start = max(now_us, self._last_done_us)
        cfg = self.config
        keep: list[StreamRequest] = []
        for req in batch:
            # second gate: serve only if the PREDICTED overshoot is within
            # one batch window — everything else is shed typed, not served
            # late (this is what bounds the deadline-miss invariant)
            if start + cfg.service_bound_us <= req.deadline_us + cfg.max_wait_us:
                keep.append(req)
            else:
                self.admission.record_late_shed(req.tenant, SHED_LATE)
        if not keep:
            return
        keys = np.asarray([r.key for r in keep], dtype=np.uint32)
        handle = self.dispatch_fn(keys)
        self._dispatched.inc()
        self._batch_sizes.observe(len(keep))
        bound = (
            self.service_model(len(keep))
            if self.service_model is not None
            else cfg.service_bound_us
        )
        if self.tracer is not None:
            self.tracer.record(
                "batch_close", start, start, size=len(keep),
                shed=len(batch) - len(keep),
            )
            self.tracer.record(
                "dispatch", start, start + int(bound), size=len(keep)
            )
        self._inflight = _Inflight(keep, handle, start, start + int(bound))

    def _collect(self) -> None:
        inf, self._inflight = self._inflight, None
        t0 = time.perf_counter_ns()
        replicas, epoch, mode = inf.handle.result()
        measured_us = max(1, (time.perf_counter_ns() - t0) // 1_000)
        if self.service_model is not None:
            # the model was sampled ONCE at dispatch (stateful models — e.g.
            # spike windows — must see exactly one draw per dispatch)
            service_us = inf.eta_us - inf.t_dispatch_us
            done = inf.t_dispatch_us + int(service_us)
        else:
            # wall mode: completion is simply "now, after the block"
            service_us = int(measured_us)
            done = max(self.clock.now_us(), inf.t_dispatch_us + 1)
        self._last_done_us = done
        self.service_ewma_us += 0.1 * (float(service_us) - self.service_ewma_us)
        self.metrics.gauge("stream_service_ewma_us").set(self.service_ewma_us)
        for req, rep in zip(inf.requests, replicas):
            self._completed.append(
                StreamResult(
                    request=req,
                    replica=int(rep),
                    t_dispatch_us=inf.t_dispatch_us,
                    t_complete_us=done,
                    epoch=epoch,
                    mode=mode,
                )
            )
            self.metrics.histogram(
                "stream_request_latency_us", tenant=req.tenant
            ).observe(max(0, done - req.arrival_us))
            if self.tracer is not None:
                self.tracer.record(
                    "request", req.arrival_us, done, tenant=req.tenant,
                    replica=int(rep), epoch=epoch,
                )
        self._served.inc(len(inf.requests))
