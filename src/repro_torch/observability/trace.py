"""Ring-buffer span tracing for the streaming request path and the bulk
datapath — the counterpart of ``repro.observability.trace`` (pure Python).

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

The bulk datapath (``BatchRouter``, ``StorePlacement``) records nested
stages on ``time.perf_counter_ns`` through ``open``/``next``/``close``: each
such span is a ``NestedSpan`` with its own id, its parent's id and the trace
id its root was given, in ns as well as µs.  A stage of a 45 µs call is far
shorter than a µs count resolves, so the per-name totals (``count``,
``total_ns``) are kept in ns; the streaming path's µs spans add theirs at
1,000 ns a µs.  Recording a nested span costs a clock reading at each end
and a tuple: the totals are folded in as the ring recycles spans, and the
``Span`` a stage becomes is built only when read.
"""
from __future__ import annotations

import dataclasses
import time

#: canonical stage names, in request-path order
SPAN_ADMIT = "admit"
SPAN_BATCH_CLOSE = "batch_close"
SPAN_DISPATCH = "dispatch"
SPAN_READ = "read"
SPAN_REQUEST = "request"
SPAN_LIFECYCLE_TICK = "lifecycle_tick"

#: the bulk datapath's nested stages: a root, then its children
SPAN_ROUTE_KEYS = "route_keys"
SPAN_ROUTE_GUARD = "route_keys.guard"
SPAN_ROUTE_COERCE = "route_keys.coerce"
SPAN_ROUTE_LAUNCH = "route_keys.launch"
SPAN_PLACE_KEYS = "place_keys"
SPAN_PLACE_GUARD = "place_keys.guard"
SPAN_PLACE_COERCE = "place_keys.coerce"
SPAN_PLACE_LAUNCH = "place_keys.launch"
SPAN_BURST = "coalesced_events"
SPAN_BURST_EVENT = "coalesced_events.event"
SPAN_BURST_FLUSH = "coalesced_events.flush"
SPAN_FLEET_UPLOAD = "fleet.upload"
SPAN_PLAN = "plan_migration"
SPAN_PLAN_KEYS_UP = "plan_migration.keys_up"
SPAN_PLAN_FLEET_UP = "plan_migration.fleet_up"
SPAN_PLAN_DIFF = "plan_migration.diff"
SPAN_PLAN_COPY_BACK = "plan_migration.copy_back"

#: the clock of nested spans (a module name, so that a test can count reads)
_now = time.perf_counter_ns


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


@dataclasses.dataclass(frozen=True)
class NestedSpan(Span):
    """A datapath stage: a ``Span`` (µs) that also carries its exact ns
    interval on ``time.perf_counter_ns``, its id, its parent's id (0 for a
    root) and its trace id (the root's, shared by the whole tree)."""

    t_start_ns: int = 0
    t_end_ns: int = 0
    span_id: int = 0
    parent_id: int = 0
    trace_id: int = 0

    @property
    def duration_ns(self) -> int:
        return self.t_end_ns - self.t_start_ns


class SpanTrace:
    """Fixed-capacity span ring + monotone per-name record totals."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        #: ``Span``s (``record``) and ``(name, t0 ns, t1 ns, span id,
        #: parent id, trace id)`` tuples (nested stages), oldest overwritten
        self._ring: list = [None] * self.capacity
        self._next = 0
        #: name -> [count, total ns] of the spans the ring has recycled
        self._recycled: dict[str, list] = {}
        #: open nested spans, innermost last: (span id, name, trace id, t0 ns)
        self._stack: list[tuple] = []
        self._ids = 0

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
        self._keep(span)
        return span

    def _keep(self, entry) -> None:
        i = self._next
        j = i % self.capacity
        old = self._ring[j]
        if old is not None:
            _add(self._recycled, old)
        self._ring[j] = entry
        self._next = i + 1

    @property
    def total(self) -> int:
        """Spans recorded, retained or not."""
        return self._next

    # -- nested spans on the ns clock (the bulk datapath) --------------------
    def open(self, name: str, trace_id: int = 0) -> int:
        """Open a stage inside the innermost open one -> its span id.  A
        child takes its root's trace id; ``trace_id`` names a root's."""
        stack = self._stack
        sid = self._ids = self._ids + 1
        stack.append((sid, name, stack[-1][2] if stack else trace_id, _now()))
        return sid

    def next(self, name: str) -> int:
        """Close the innermost stage and open its sibling ``name`` at the
        same clock reading -> the sibling's span id."""
        t = _now()
        stack = self._stack
        sid, prev, trace_id, t0 = stack.pop()
        self._keep((prev, t0, t, sid, stack[-1][0] if stack else 0, trace_id))
        sid = self._ids = self._ids + 1
        stack.append((sid, name, trace_id, t))
        return sid

    def close(self, span_id: int | None = None) -> None:
        """Close the innermost stage, or ``span_id`` and every stage still
        open inside it (one an exception left open), at one clock reading."""
        t = _now()
        stack = self._stack
        while stack:
            sid, name, trace_id, t0 = stack.pop()
            self._keep((name, t0, t, sid, stack[-1][0] if stack else 0, trace_id))
            if span_id is None or sid == span_id:
                return

    # -- read side -----------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Spans recycled out of the ring (recorded minus retained)."""
        return max(0, self.total - self.capacity)

    def count(self, name: str | None = None) -> int:
        """Monotone record total — survives ring recycling."""
        if name is None:
            return self.total
        return self.totals().get(name, (0, 0))[0]

    def total_ns(self, name: str) -> int:
        """Monotone total of ``name``'s durations in ns — survives ring
        recycling, like ``count``."""
        return self.totals().get(name, (0, 0))[1]

    def totals(self) -> dict[str, tuple[int, int]]:
        """``{name: (count, total ns)}`` of every name recorded: what the
        ring recycled, plus what it retains (a stage span in ns, a stage
        recorded whole at 1,000 ns a µs)."""
        out = {n: list(t) for n, t in self._recycled.items()}
        for entry in self._ring:
            if entry is not None:
                _add(out, entry)
        return {n: (c, ns) for n, (c, ns) in out.items()}

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
            if isinstance(span, tuple):
                span = _nested(*span)
            if name is not None and span.name != name:
                continue
            if tenant is not None and span.tenant != tenant:
                continue
            out.append(span)
        return out


def _add(totals: dict, entry) -> None:
    """Count a ring entry into ``{name: [count, total ns]}``."""
    if isinstance(entry, tuple):
        name, ns = entry[0], entry[2] - entry[1]
    else:
        name, ns = entry.name, (entry.t_end_us - entry.t_start_us) * 1_000
    tot = totals.get(name)
    if tot is None:
        totals[name] = [1, ns]
    else:
        tot[0] += 1
        tot[1] += ns


def _nested(name: str, t0: int, t1: int, sid: int, parent: int, trace_id: int) -> NestedSpan:
    return NestedSpan(name, t0 // 1_000, t1 // 1_000, None, (), t0, t1, sid, parent, trace_id)
