"""Ring-buffer span tracing for the streaming request path — the
counterpart of ``repro.observability.trace`` (pure Python).

The request path is admit → batch close → dispatch → hedge/read →
complete; every stage records a ``Span`` into one shared ``SpanTrace``
(DESIGN.md §15).  Spans carry the tenant they bill to plus small
stage-specific tags (batch size, replica, epoch, hedged), with all
timestamps in integer µs from whatever clock the stack runs on — virtual
spans are deterministic, wall spans are production traces, same pipeline.

The buffer is a fixed-capacity ring: recording is O(1) and allocation-
bounded forever (old spans are overwritten, never accumulated), which is
what lets the tracer stay on in production.  Per-name record totals are
kept monotonically alongside, so invariants like "one ``request`` span
per served request" hold regardless of how many spans the ring has since
recycled (``count`` reads the totals; ``spans`` reads what is retained).
"""
from __future__ import annotations

import dataclasses

#: canonical stage names, in request-path order
SPAN_ADMIT = "admit"
SPAN_BATCH_CLOSE = "batch_close"
SPAN_DISPATCH = "dispatch"
SPAN_READ = "read"
SPAN_REQUEST = "request"
SPAN_LIFECYCLE_TICK = "lifecycle_tick"


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed stage: a named µs interval with tenant + tags."""

    name: str
    t_start_us: int
    t_end_us: int
    tenant: str | None = None
    tags: tuple = ()

    @property
    def duration_us(self) -> int:
        return self.t_end_us - self.t_start_us

    def tag(self, key: str, default=None):
        for k, v in self.tags:
            if k == key:
                return v
        return default


class SpanTrace:
    """Fixed-capacity span ring + monotone per-name record totals."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: list[Span | None] = [None] * self.capacity
        self._next = 0
        self._recorded: dict[str, int] = {}
        self.total = 0

    def record(
        self,
        name: str,
        t_start_us: int,
        t_end_us: int,
        *,
        tenant: str | None = None,
        **tags,
    ) -> Span:
        span = Span(
            name=name,
            t_start_us=int(t_start_us),
            t_end_us=int(t_end_us),
            tenant=tenant,
            tags=tuple(sorted(tags.items())),
        )
        self._ring[self._next % self.capacity] = span
        self._next += 1
        self.total += 1
        self._recorded[name] = self._recorded.get(name, 0) + 1
        return span

    # -- read side -----------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Spans recycled out of the ring (recorded minus retained)."""
        return max(0, self.total - self.capacity)

    def count(self, name: str | None = None) -> int:
        """Monotone record total — survives ring recycling."""
        if name is None:
            return self.total
        return self._recorded.get(name, 0)

    def spans(
        self, name: str | None = None, tenant: str | None = None
    ) -> list[Span]:
        """Retained spans, oldest first, optionally filtered."""
        start = max(0, self._next - self.capacity)
        out = []
        for i in range(start, self._next):
            span = self._ring[i % self.capacity]
            if span is None:
                continue
            if name is not None and span.name != name:
                continue
            if tenant is not None and span.tenant != tenant:
                continue
            out.append(span)
        return out
