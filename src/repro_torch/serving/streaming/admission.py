"""Deadline-aware admission control with per-tenant token buckets — the
counterpart of ``repro.serving.streaming.admission`` (pure Python).

The streaming tier's first line of defense (DESIGN.md §14): a request that
cannot make its SLO given the current pipeline state is shed AT THE DOOR
with a typed ``AdmissionRejectedError`` — it never occupies a batch slot,
never poisons tail latency, and the caller gets a machine-readable reason
(``SHED_*``) instead of a timeout.  Shedding is the controller *working*,
so every rejection lands in the observability registry as a
``stream_shed_total{tenant, reason}`` counter series (admits as
``stream_admitted_total{tenant}``); the ``admitted`` / ``shed_by_reason``
/ ``shed_by_tenant`` properties are aggregate views over those series,
kept for callers that predate the registry.

Admission checks, in order:

1. **past deadline** — ``deadline_us <= now``: dead on arrival;
2. **rate limit** — the tenant's token bucket is empty (zipf-skewed
   multi-tenant load means one hot tenant must not starve the rest);
3. **feasibility** — even if the open batch closed *right now* behind the
   in-flight batch, ``dispatch_eta + service_bound_us`` already overshoots
   ``deadline + max_wait_us`` (the one-batch-window grace the close-time
   check enforces): the request cannot be served in time, shed it early.

The controller never serves anything itself — the batch-close late check
in ``MicroBatcher`` is the second (and final) gate.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.lifecycle.errors import (
    SHED_INFEASIBLE,
    SHED_PAST_DEADLINE,
    SHED_RATE_LIMITED,
    AdmissionRejectedError,
)

from .clock import US_PER_S


class TokenBucket:
    """Classic token bucket in µs time: ``rate_per_s`` sustained,
    ``burst`` ceiling, lazily refilled on each ``try_take``."""

    def __init__(self, rate_per_s: float, burst: float, now_us: int = 0):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError(
                f"need rate_per_s > 0 and burst > 0, got "
                f"{rate_per_s} / {burst}"
            )
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last_us = int(now_us)

    def _refill(self, now_us: int) -> None:
        dt = max(0, now_us - self._last_us)
        self._tokens = min(
            self.burst, self._tokens + dt * self.rate_per_s / US_PER_S
        )
        self._last_us = now_us

    def try_take(self, now_us: int, n: float = 1.0) -> bool:
        self._refill(now_us)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    #: declared service bound per dispatch, µs — the SLO capacity statement
    #: admission feasibility and the close-time check both reason against
    service_bound_us: int = 2_000
    #: batch-window grace (mirrors ``StreamConfig.max_wait_us``): an admitted
    #: request may complete at most this far past its deadline
    max_wait_us: int = 1_000
    #: per-tenant sustained admission rate (requests/s); None disables
    #: rate limiting entirely
    tenant_rate_per_s: float | None = None
    #: per-tenant burst ceiling (defaults to one batch worth at rate)
    tenant_burst: float = 32.0

    def __post_init__(self):
        if self.service_bound_us <= 0 or self.max_wait_us < 0:
            raise ValueError(
                f"need service_bound_us > 0 and max_wait_us >= 0, got "
                f"{self.service_bound_us} / {self.max_wait_us}"
            )


class AdmissionController:
    """Stateful admission gate: per-tenant buckets + registry-backed shed
    accounting (``metrics=None`` builds a private ``MetricsRegistry``; the
    front end passes its shared one)."""

    def __init__(
        self, config: AdmissionConfig | None = None, metrics=None
    ):
        self.config = config or AdmissionConfig()
        self._buckets: dict[str, TokenBucket] = {}
        if metrics is None:
            from repro_torch.observability.metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics

    # -- aggregate views over the registry series ----------------------------
    @property
    def admitted(self) -> int:
        return self.metrics.total("stream_admitted_total")

    @property
    def shed_by_reason(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for m in self.metrics.family("stream_shed_total").values():
            reason = m.labels["reason"]
            out[reason] = out.get(reason, 0) + m.value
        return out

    @property
    def shed_by_tenant(self) -> dict[tuple[str, str], int]:
        return {
            (m.labels["tenant"], m.labels["reason"]): m.value
            for m in self.metrics.family("stream_shed_total").values()
        }

    def _bucket(self, tenant: str, now_us: int) -> TokenBucket | None:
        if self.config.tenant_rate_per_s is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = TokenBucket(
                self.config.tenant_rate_per_s, self.config.tenant_burst, now_us
            )
            self._buckets[tenant] = b
        return b

    def _shed(
        self, reason: str, tenant: str, deadline_us: int, now_us: int
    ) -> AdmissionRejectedError:
        self.metrics.counter(
            "stream_shed_total", tenant=tenant, reason=reason
        ).inc()
        return AdmissionRejectedError(
            reason, tenant=tenant, deadline_us=deadline_us, now_us=now_us
        )

    def admit(
        self, tenant: str, deadline_us: int, now_us: int, dispatch_eta_us: int
    ) -> None:
        """Admit or raise.  ``dispatch_eta_us`` is the batcher's earliest
        possible dispatch start for a request arriving now (accounts for the
        in-flight batch occupying the one-deep pipeline)."""
        cfg = self.config
        if deadline_us <= now_us:
            raise self._shed(SHED_PAST_DEADLINE, tenant, deadline_us, now_us)
        bucket = self._bucket(tenant, now_us)
        if bucket is not None and not bucket.try_take(now_us):
            raise self._shed(SHED_RATE_LIMITED, tenant, deadline_us, now_us)
        best_done = max(dispatch_eta_us, now_us) + cfg.service_bound_us
        if best_done > deadline_us + cfg.max_wait_us:
            raise self._shed(SHED_INFEASIBLE, tenant, deadline_us, now_us)
        self.metrics.counter("stream_admitted_total", tenant=tenant).inc()

    def record_late_shed(self, tenant: str, reason: str) -> None:
        """Account a batch-close shed (the second gate lives in the
        batcher, the ledger lives here)."""
        self.metrics.counter(
            "stream_shed_total", tenant=tenant, reason=reason
        ).inc()

    @property
    def shed_total(self) -> int:
        return self.metrics.total("stream_shed_total")
