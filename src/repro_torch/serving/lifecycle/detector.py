"""Heartbeat-driven failure detection with hysteresis + quarantine — the
counterpart of ``repro.serving.lifecycle.detector`` (pure Python; the same
transitions at the same clock times).

Deadline-based (not phi-accrual: the thresholds are explicit, the state
machine is exactly testable with a manual clock, and the serving tier's
heartbeats arrive on a fixed cadence anyway).  Per replica (DESIGN.md §12):

    alive --silence > suspect_after--> suspect
    suspect --beat--> alive                      (no event: hysteresis)
    suspect --silence > fail_after--> removed    (emits ONE "fail")
    removed --beat--> quarantined                (no event yet)
    quarantined --gap > suspect_after--> removed (flap: window resets)
    quarantined --stable readmit window--> alive (emits ONE "recover")

A flapping replica therefore costs the replacement table ONE fail swap and
ONE recover swap per genuine outage, however many times it blips during
quarantine — the table and the device fleet-state upload are never thrashed
per flap.  Each re-entry into ``removed`` within ``flap_window`` of the
last readmission doubles the required stable window (capped), so habitual
flappers wait longer each round.

The clock is pluggable: ``ManualClock`` for tests/chaos (deterministic
replays), ``MonotonicClock`` for production.  All transitions that *emit
events* happen in ``poll()`` — ``heartbeat()`` only updates per-replica
bookkeeping — so the caller controls exactly when membership changes are
observed (the lifecycle manager polls once per dispatch, coalescing a whole
storm into one device update).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

from repro_torch.serving.lifecycle.errors import ClockWentBackwardsError

# -- replica lifecycle states (DESIGN.md §12 state machine) -----------------
ALIVE = "alive"
SUSPECT = "suspect"
REMOVED = "removed"
QUARANTINED = "quarantined"


class MonotonicClock:
    """Production clock: ``time.monotonic``."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock:
    """Deterministic test/chaos clock — advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += dt
        return self._t


@dataclasses.dataclass(frozen=True)
class HeartbeatConfig:
    """Deadline thresholds, all in clock seconds."""

    #: expected beat cadence (documentation + quarantine-gap tolerance)
    heartbeat_interval: float = 1.0
    #: silence before an alive replica turns suspect (no event emitted)
    suspect_after: float = 3.0
    #: silence before a suspect replica is declared failed (emits "fail")
    fail_after: float = 6.0
    #: continuous-beat window a quarantined replica must survive before
    #: re-admission (emits "recover")
    readmit_after: float = 5.0
    #: re-failure within this of the last readmission counts as a flap
    flap_window: float = 60.0
    #: per-flap multiplier on the required readmit window
    flap_backoff: float = 2.0
    #: hard cap on the (backed-off) readmit window
    max_readmit_after: float = 120.0

    def __post_init__(self):
        if not (0 < self.heartbeat_interval <= self.suspect_after):
            raise ValueError(
                f"need 0 < heartbeat_interval <= suspect_after, got "
                f"{self.heartbeat_interval} / {self.suspect_after}"
            )
        if self.fail_after < self.suspect_after:
            raise ValueError(
                f"fail_after ({self.fail_after}) must be >= suspect_after "
                f"({self.suspect_after})"
            )
        if self.readmit_after <= 0 or self.flap_backoff < 1:
            raise ValueError("readmit_after must be > 0 and flap_backoff >= 1")


@dataclasses.dataclass
class _Track:
    state: str = ALIVE
    last_beat: float = 0.0
    quarantine_start: float = 0.0
    last_readmitted: float = -float("inf")
    flaps: int = 0


class FailureDetector:
    """Deadline failure detector over a set of replica slots."""

    def __init__(
        self,
        slots: Iterable[int],
        config: HeartbeatConfig | None = None,
        clock=None,
    ):
        self.config = config or HeartbeatConfig()
        self.clock = clock or MonotonicClock()
        self._last_now = self.clock.now()
        self._tracks: dict[int, _Track] = {
            int(s): _Track(last_beat=self._last_now) for s in slots
        }

    def _now(self) -> float:
        """Read the clock, refusing any regression (deadline math is only
        sound over monotone time — a backwards step would silently shrink
        every silence window)."""
        now = self.clock.now()
        if now < self._last_now:
            raise ClockWentBackwardsError(now=now, last=self._last_now)
        self._last_now = now
        return now

    # -- membership of the *detector* (scale events) ------------------------
    def register(self, slot: int) -> None:
        """A new replica joined (scale-up): tracked alive from now."""
        self._tracks[int(slot)] = _Track(last_beat=self._now())

    def forget(self, slot: int) -> None:
        """A replica left the slot space (scale-down)."""
        self._tracks.pop(int(slot), None)

    def state_of(self, slot: int) -> str:
        return self._tracks[int(slot)].state

    @property
    def slots(self) -> tuple[int, ...]:
        return tuple(sorted(self._tracks))

    def mark_removed(self, slot: int) -> None:
        """Operator-initiated failure: align the detector with a manual
        ``fail`` event so heartbeats must re-earn admission."""
        tr = self._tracks[int(slot)]
        tr.state = REMOVED

    def _required_readmit(self, tr: _Track) -> float:
        window = self.config.readmit_after * (self.config.flap_backoff ** tr.flaps)
        return min(window, self.config.max_readmit_after)

    # -- inputs --------------------------------------------------------------
    def heartbeat(self, slot: int) -> None:
        """One beat from ``slot``.  Never emits events (see ``poll``)."""
        tr = self._tracks[int(slot)]
        now = self._now()
        if tr.state == SUSPECT:
            # hysteresis: a suspect that beats again was never declared
            # failed, so nothing downstream ever heard about it
            tr.state = ALIVE
        elif tr.state == REMOVED:
            tr.state = QUARANTINED
            tr.quarantine_start = now
        elif tr.state == QUARANTINED and (
            now - tr.last_beat > self.config.suspect_after
        ):
            # beats resumed after a gap: the stability window restarts
            tr.quarantine_start = now
        tr.last_beat = now

    # -- transitions ---------------------------------------------------------
    def poll(self) -> list[tuple[str, int]]:
        """Advance deadline-driven transitions; return emitted events.

        Returns ``("fail", slot)`` / ``("recover", slot)`` pairs in slot
        order — the lifecycle manager applies them to the router under one
        coalesced device update.
        """
        now = self._now()
        out: list[tuple[str, int]] = []
        for slot in sorted(self._tracks):
            tr = self._tracks[slot]
            silence = now - tr.last_beat
            if tr.state == ALIVE and silence > self.config.suspect_after:
                tr.state = SUSPECT
            if tr.state == SUSPECT and silence > self.config.fail_after:
                tr.state = REMOVED
                if now - tr.last_readmitted <= self.config.flap_window:
                    tr.flaps += 1  # re-failed soon after readmission
                else:
                    tr.flaps = 0
                out.append(("fail", slot))
            elif tr.state == QUARANTINED:
                if silence > self.config.suspect_after:
                    # went quiet again during quarantine: back to removed,
                    # NO event (downstream still considers it failed)
                    tr.state = REMOVED
                elif now - tr.quarantine_start >= self._required_readmit(tr):
                    tr.state = ALIVE
                    tr.last_readmitted = now
                    out.append(("recover", slot))
        return out
