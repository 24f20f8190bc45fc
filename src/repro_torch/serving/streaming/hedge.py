"""Hedged degraded reads + per-shard circuit breakers (DESIGN.md §14) — the
counterpart of ``repro.serving.streaming.hedge`` (pure Python).

**Hedging.**  A read goes to the key's primary holder (first distinct
alive holder from ``StorePlacement.read``).  If that primary is *suspect*
in the ``FailureDetector`` — silent past ``suspect_after`` but not yet
formally failed — or its breaker is open, a hedge fires at
``hedge_after_us``: the SAME read against the next distinct alive holder,
first response wins.  The candidate set is ALWAYS drawn from the key's
reachable holders, so a hedged read can never return a shard that does not
actually hold the key (the chaos harness asserts exactly this).

**Circuit breakers.**  The detector's hysteresis means a flapping shard
oscillates alive↔suspect without ever emitting a formal ``fail`` — correct
for membership (the replacement table is not thrashed) but miserable for
tail latency if reads keep electing it primary.  The ``BreakerBoard``
watches detector state transitions: ``trip_after`` alive→suspect flips
within ``window_us`` opens the shard's breaker for ``cooldown_us``,
removing it from primary/hedge candidacy *before* the detector declares
anything.  After cooldown the breaker half-opens (candidate again); a
clean interval closes it fully.  A shard the detector formally removes
drops out of the holder sets anyway — the breaker's job is the gray zone
the detector deliberately rides out.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.observability.trace import SPAN_READ
from repro_torch.serving.lifecycle.detector import REMOVED, SUSPECT


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    #: alive→suspect transitions within ``window_us`` that trip the breaker
    trip_after: int = 3
    #: sliding window the transitions are counted over
    window_us: int = 30_000_000
    #: how long a tripped breaker stays open (then half-opens)
    cooldown_us: int = 10_000_000

    def __post_init__(self):
        if self.trip_after < 1 or self.window_us <= 0 or self.cooldown_us <= 0:
            raise ValueError(
                f"need trip_after >= 1 and positive windows, got "
                f"{self.trip_after} / {self.window_us} / {self.cooldown_us}"
            )


class BreakerBoard:
    """Per-shard circuit breakers fed by detector state transitions.

    Trips land in the registry as ``stream_breaker_trips_total{shard}``;
    ``trips`` is the aggregate view over that series."""

    def __init__(
        self,
        detector,
        clock,
        config: BreakerConfig | None = None,
        metrics=None,
    ):
        self.detector = detector
        self.clock = clock
        self.config = config or BreakerConfig()
        self._last_state: dict[int, str] = {}
        self._suspect_at: dict[int, deque] = {}
        self._open_until: dict[int, int] = {}
        if metrics is None:
            from repro_torch.observability.metrics import MetricsRegistry

            metrics = MetricsRegistry(clock=clock)
        self.metrics = metrics

    @property
    def trips(self) -> int:
        return self.metrics.total("stream_breaker_trips_total")

    def observe(self) -> None:
        """Snapshot detector states; record alive→suspect flips and trip
        breakers that crossed the threshold.  Call once per pump/dispatch —
        the same cadence the detector itself is polled on."""
        now = self.clock.now_us()
        cfg = self.config
        for slot in self.detector.slots:
            state = self.detector.state_of(slot)
            prev = self._last_state.get(slot)
            if state == SUSPECT and prev != SUSPECT:
                dq = self._suspect_at.setdefault(slot, deque())
                dq.append(now)
                while dq and now - dq[0] > cfg.window_us:
                    dq.popleft()
                if len(dq) >= cfg.trip_after and not self.is_open(slot):
                    self._open_until[slot] = now + cfg.cooldown_us
                    self.metrics.counter(
                        "stream_breaker_trips_total", shard=str(slot)
                    ).inc()
            elif state == REMOVED:
                # the detector formally failed it: membership takes over,
                # the breaker's flap history is moot
                self._suspect_at.pop(slot, None)
                self._open_until.pop(slot, None)
            self._last_state[slot] = state

    def is_open(self, slot: int) -> bool:
        until = self._open_until.get(int(slot))
        if until is None:
            return False
        if self.clock.now_us() >= until:
            # cooldown over: half-open — candidate again; a clean window
            # (no further trips) leaves it closed
            del self._open_until[int(slot)]
            return False
        return True

    @property
    def open_slots(self) -> tuple[int, ...]:
        return tuple(sorted(s for s in self._open_until if self.is_open(s)))


@dataclasses.dataclass(frozen=True)
class HedgedRead:
    """Outcome of one (possibly hedged) read."""

    key_index: int
    shard: int
    mode: str
    hedged: bool
    latency_us: int
    #: the distinct alive holders the read chose among
    holders: tuple


class HedgedReader:
    """First-response-wins reads over a key's holder set.

    ``probe(shard) -> latency_us`` is the pluggable transport (simulated in
    chaos/bench; a real RPC in production).  With a suspect-or-broken
    primary the hedge fires at ``hedge_after_us`` against the next distinct
    alive holder; the winner is whichever response lands first.
    """

    def __init__(
        self,
        store,
        detector,
        breakers: BreakerBoard,
        hedge_after_us: int,
        probe=None,
        metrics=None,
        tracer=None,
        clock=None,
    ):
        self.store = store
        self.detector = detector
        self.breakers = breakers
        self.hedge_after_us = int(hedge_after_us)
        self.probe = probe if probe is not None else (lambda shard: 100)
        self.metrics = metrics if metrics is not None else breakers.metrics
        self.tracer = tracer
        self.clock = clock if clock is not None else breakers.clock
        self._reads = self.metrics.counter("stream_reads_total")
        self._hedge_launched = self.metrics.counter(
            "stream_hedge_launched_total"
        )
        self._hedge_won = self.metrics.counter("stream_hedge_won_total")

    #: registry-backed counters, exposed under the historical names
    @property
    def reads(self) -> int:
        return self._reads.value

    @property
    def hedge_launched(self) -> int:
        return self._hedge_launched.value

    @property
    def hedge_won(self) -> int:
        return self._hedge_won.value

    def _is_suspect(self, shard: int) -> bool:
        try:
            return self.detector.state_of(shard) == SUSPECT
        except KeyError:
            return False  # retired slot: not tracked, membership handles it

    def read(self, key_index: int) -> HedgedRead:
        """One read: primary (breaker-closed holders first), hedged to the
        next distinct alive holder when the primary looks unhealthy."""
        holders, mode = self.store.read(key_index)
        holders = [int(h) for h in np.asarray(holders).tolist()]
        closed = [h for h in holders if not self.breakers.is_open(h)]
        candidates = closed if closed else holders  # never an empty ballot
        primary = candidates[0]
        p_lat = int(self.probe(primary))
        winner, latency, hedged = primary, p_lat, False
        unhealthy = self._is_suspect(primary) or self.breakers.is_open(primary)
        if unhealthy and len(candidates) > 1 and p_lat > self.hedge_after_us:
            # the primary is slow AND unhealthy: fire the hedge
            alt = candidates[1]
            a_lat = self.hedge_after_us + int(self.probe(alt))
            hedged = True
            self._hedge_launched.inc()
            if a_lat < p_lat:
                winner, latency = alt, a_lat
                self._hedge_won.inc()
        self._reads.inc()
        self.metrics.histogram("stream_read_latency_us").observe(latency)
        if self.tracer is not None:
            now = self.clock.now_us()
            self.tracer.record(
                SPAN_READ, now, now + latency, shard=winner, hedged=hedged
            )
        return HedgedRead(
            key_index=key_index,
            shard=winner,
            mode=mode,
            hedged=hedged,
            latency_us=latency,
            holders=tuple(holders),
        )
