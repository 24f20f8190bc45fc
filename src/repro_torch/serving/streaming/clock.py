"""Microsecond time sources for the streaming tier — the counterpart of
``repro.serving.streaming.clock`` (pure Python).

The batcher, admission controller, hedger and breakers all reason in
integer microseconds (SLO deadlines are µs-scale; float seconds lose
precision exactly where tail latency lives).  The clock is pluggable:
``WallClockUs`` for production, ``VirtualClockUs`` for tests/chaos/bench —
fully deterministic, advanced explicitly by the harness.

``VirtualClockUs.seconds_view()`` adapts the same time source to the
``FailureDetector``'s float-seconds ``now()`` protocol, so one virtual
timeline drives the whole stack (batcher deadlines AND detector
suspect/fail windows) with no drift between layers.
"""
from __future__ import annotations

import time

US_PER_S = 1_000_000


class WallClockUs:
    """Production clock: ``time.monotonic_ns`` truncated to µs."""

    def now_us(self) -> int:
        return time.monotonic_ns() // 1_000


class VirtualClockUs:
    """Deterministic µs clock — advances only when told to."""

    def __init__(self, start_us: int = 0):
        self._t = int(start_us)

    def now_us(self) -> int:
        return self._t

    def advance_us(self, dt_us: int) -> int:
        if dt_us < 0:
            raise ValueError(f"cannot advance time backwards (dt_us={dt_us})")
        self._t += int(dt_us)
        return self._t

    def seconds_view(self) -> "_SecondsView":
        """A float-seconds ``now()`` facade over this clock, for components
        speaking the ``FailureDetector`` clock protocol."""
        return _SecondsView(self)


class _SecondsView:
    def __init__(self, base: VirtualClockUs):
        self._base = base

    def now(self) -> float:
        return self._base.now_us() / US_PER_S
