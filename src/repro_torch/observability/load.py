"""Per-shard load accumulation on the device + theory-bound drift tracking —
the counterpart of ``repro.observability.load``.

The paper's balance and minimal-disruption claims, measured on LIVE
traffic (DESIGN.md §15).  Three pieces:

* ``route_with_load_impl`` — the instrumented route's plain version: the
  engine's fused route PLUS a per-shard bincount of the replica vector into
  a capacity-length u32 accumulator.  On the card the two are one launch
  (``RoutingKernels.route_load``: the route kernel's chunk loop, each
  routed chunk's sampled replicas then counted into a block histogram in
  shared memory, or with global atomics above 4,096 bins), as the
  reference folds them into one jitted dispatch.  At serving batch sizes every key is
  counted; at bulk sizes the pass counts a deterministic 1/2^``sample_shift``
  stride sample at weight ``2^sample_shift``, so exact and sampled batches
  mix coherently in one accumulator (``LoadConfig.exact_cutoff``).

* ``LoadMonitor`` — the host control plane: attaches to a ``BatchRouter``
  (``router.attach_load_monitor``), holds one ``(capacity,)`` int32 device
  accumulator of u32 bit patterns that every instrumented launch advances
  in place, and drains it on a configurable batch cadence — ONE
  device-to-host copy per window, then ``zero_()`` (a memset on the
  device), so no host-to-device upload happens after construction.  The
  reference instead re-points its functional accumulator at a zeros array
  pinned once (load.py:390-404); the observable protocol is the same.  Each
  drain updates registry gauges (per-shard counts, peak/mean) and evaluates
  the balance envelope: for m keys over n alive shards the expected
  peak/mean is ≈ 1 + sqrt(2·n·ln n / m), and observed ratios past a
  configurable multiple of that raise (or emit) a ``BalanceDriftAlarm``.

* ``DisruptionTracker`` — moved-fraction telemetry keyed to
  ``routing_epoch``: a fixed probe key set is re-routed whenever a drain
  observes the epoch advanced, and the fraction of probes whose shard
  changed is compared against the minimal-disruption bound
  ``slack · delta / max(n_before, n_after)`` (the paper's ``delta/n``
  per-event guarantee).  A breach raises (or emits) a
  ``DisruptionBoundAlarm``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.binomial_torch import MASK32, u32
from repro_torch.observability.alarms import (
    BalanceDriftAlarm,
    DisruptionBoundAlarm,
    deliver,
)
from repro_torch.observability.metrics import MetricsRegistry


# ---------------------------------------------------------------------------
# the instrumented pass (plain version)
# ---------------------------------------------------------------------------


def route_with_load_impl(
    keys: torch.Tensor,
    packed: torch.Tensor,
    table: torch.Tensor,
    state: torch.Tensor,
    counts: torch.Tensor,
    *,
    omega: int,
    route,
    sample_shift: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route one batch AND count its per-shard load.

    keys          (N,) u32 keys (any int dtype)
    counts        (capacity,) running per-shard counts as int32 u32 bit
                  patterns (not modified); replica ids lie in [0, capacity)
    route         the engine's plain fused route
                  ``(keys, packed, table, state, omega)``
    sample_shift  log2 of the count-sampling stride: 0 counts every key;
                  s > 0 counts replicas ``[::2**s]`` with weight ``2**s``

    Returns ``(replicas, new_counts)``: the route's int32 replica ids
    (instrumentation never changes routing) and a new accumulator, this
    batch's (possibly sampled) bincount added with u32 wrap — the integers
    of the reference's one-hot sum and of its scatter alike.
    """
    replicas = route(keys.reshape(-1), packed, table, state, omega)
    stride = 1 << sample_shift
    hist = torch.bincount(replicas[::stride].to(torch.int64), minlength=counts.numel())
    new = (u32(counts) + hist * stride) & MASK32
    return replicas.reshape(keys.shape), new.to(torch.int32)


# ---------------------------------------------------------------------------
# theory envelopes
# ---------------------------------------------------------------------------


def expected_peak_over_mean(total_keys: int, n_alive: int) -> float:
    """Expected max/mean shard load for ``total_keys`` uniform keys over
    ``n_alive`` shards: ≈ 1 + sqrt(2·n·ln n / m) (balls-into-bins maximum
    in the m >> n regime)."""
    if n_alive <= 1 or total_keys <= 0:
        return 1.0
    return 1.0 + math.sqrt(
        2.0 * n_alive * math.log(n_alive) / float(total_keys)
    )


def disruption_bound(
    delta_events: int, n_before: int, n_after: int, slack: float
) -> float:
    """Allowed moved fraction for ``delta_events`` membership events: each
    event relocates one shard's share ≈ 1/n of the keys, so the window
    bound is ``slack · delta / max(n_before, n_after)`` capped at 1."""
    n = max(1, n_before, n_after)
    return min(1.0, slack * delta_events / n)


# ---------------------------------------------------------------------------
# host control plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Knobs for the load monitor (the reference's defaults)."""

    #: drain the device accumulator to host every this many batches
    drain_every: int = 64
    #: batches of at most this many keys are counted exactly; bigger
    #: batches are stride-sampled (see ``sample_shift``)
    exact_cutoff: int = 1 << 15
    #: log2 stride for sampled batches: count replicas ``[::2**shift]``
    #: with weight ``2**shift``
    sample_shift: int = 6
    #: alarm when observed peak/mean exceeds this multiple of the expected
    #: peak/mean envelope
    balance_mult: float = 2.0
    #: skip the balance alarm below this many drained keys
    min_alarm_keys: int = 1_024
    #: slack on the delta/n disruption bound (see ``disruption_bound``)
    disruption_slack: float = 2.0
    #: probe keys the disruption tracker re-routes on epoch advance
    n_probe: int = 512
    probe_seed: int = 0x0B5E11

    def __post_init__(self):
        if self.drain_every < 1:
            raise ValueError(f"drain_every must be >= 1, got {self.drain_every}")
        if self.balance_mult <= 0 or self.disruption_slack <= 0:
            raise ValueError(
                f"need positive balance_mult / disruption_slack, got "
                f"{self.balance_mult} / {self.disruption_slack}"
            )
        if self.n_probe < 1:
            raise ValueError(f"n_probe must be >= 1, got {self.n_probe}")
        if self.sample_shift < 0:
            raise ValueError(
                f"sample_shift must be >= 0, got {self.sample_shift}"
            )
        if self.exact_cutoff < 0:
            raise ValueError(
                f"exact_cutoff must be >= 0, got {self.exact_cutoff}"
            )


class DisruptionTracker:
    """Moved-fraction-vs-bound telemetry, keyed to ``routing_epoch``."""

    def __init__(
        self,
        router,
        config: LoadConfig,
        metrics: MetricsRegistry,
        on_alarm=None,
    ):
        self.router = router
        self.config = config
        self.metrics = metrics
        self.on_alarm = on_alarm
        rng = np.random.default_rng(config.probe_seed)
        self._probe_host = rng.integers(
            0, 1 << 32, size=config.n_probe, dtype=np.uint32
        )
        self._probe_dev = torch.from_numpy(self._probe_host.view(np.int32)).to(router.device)
        self._epoch: int | None = None
        self._alive = 0
        self._routes: np.ndarray | None = None

    def _route_probes(self) -> np.ndarray:
        # straight through the dispatcher — bypasses the router's monitored
        # path so probe traffic never pollutes the load accumulator
        from repro_torch.kernels import ops

        return ops.route_bulk(
            self._probe_dev, self.router._fleet_dev, self.router.spec
        ).cpu().numpy()

    def observe(
        self,
        prev: np.ndarray,
        now: np.ndarray,
        delta_events: int,
        n_before: int,
        n_after: int,
        *,
        epoch: int | None = None,
    ) -> float:
        """Score one membership window: moved fraction vs the bound."""
        moved = float(np.mean(prev != now)) if len(prev) else 0.0
        bound = disruption_bound(
            delta_events, n_before, n_after, self.config.disruption_slack
        )
        self.metrics.gauge("load_moved_fraction").set(moved)
        self.metrics.gauge("load_moved_bound").set(bound)
        if moved > bound:
            self.metrics.counter("disruption_alarms_total").inc()
            deliver(
                DisruptionBoundAlarm(
                    moved,
                    bound,
                    delta_events=delta_events,
                    n_before=n_before,
                    n_after=n_after,
                    epoch=epoch,
                ),
                self.on_alarm,
            )
        return moved

    def check(self) -> float | None:
        """Re-route the probes if ``routing_epoch`` advanced since the last
        look; returns the moved fraction (None = no epoch advance)."""
        epoch = self.router.routing_epoch
        alive = self.router.alive
        if self._epoch is None:
            if alive == 0:
                return None  # nothing routable yet; baseline on next check
            self._epoch, self._alive = epoch, alive
            self._routes = self._route_probes()
            return None
        if epoch == self._epoch or alive == 0:
            return None
        now = self._route_probes()
        moved = self.observe(
            self._routes,
            now,
            epoch - self._epoch,
            self._alive,
            alive,
            epoch=epoch,
        )
        self._epoch, self._alive, self._routes = epoch, alive, now
        return moved


class LoadMonitor:
    """Per-shard load telemetry over a ``BatchRouter``'s routed batches.

    Attaching flips the router's fused launch to the instrumented one
    (``ops.route_load_bulk``): every batch advances the device accumulator
    in the launch that routes it — exactly for batches up to
    ``config.exact_cutoff`` keys, by stride sample above it — so ``totals``
    (a host ``np.uint64`` array) reads as per-shard key counts either way.
    ``drain()`` runs on the configured batch cadence (or on demand).
    """

    def __init__(
        self,
        router,
        metrics: MetricsRegistry | None = None,
        config: LoadConfig | None = None,
        on_alarm=None,
    ):
        self.router = router
        self.config = config or LoadConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.on_alarm = on_alarm
        self.tracker = DisruptionTracker(
            router, self.config, self.metrics, on_alarm=on_alarm
        )
        #: made once, on the router's device; launches advance it in place
        #: and drains zero it there
        self._counts_dev = torch.zeros(router.capacity, dtype=torch.int32, device=router.device)
        self._window_batches = 0
        self._window_keys = 0
        #: host-side cumulative per-shard totals across drains
        self.totals = np.zeros((router.capacity,), np.uint64)
        self.total_keys = 0
        self.drains = 0
        router.attach_load_monitor(self)

    # -- router-facing surface ----------------------------------------------
    @property
    def counts_dev(self) -> torch.Tensor:
        """The live device accumulator (the instrumented launch's operand)."""
        return self._counts_dev

    def effective_shift(self, n_keys: int) -> int:
        """Count-sampling shift for a batch of ``n_keys``: 0 (exact) at or
        below ``config.exact_cutoff``, ``config.sample_shift`` above it."""
        return 0 if n_keys <= self.config.exact_cutoff else \
            self.config.sample_shift

    def note_dispatch(self, new_counts: torch.Tensor, n_keys: int) -> None:
        """Called by the router after each instrumented launch with the
        advanced accumulator; drains when the window cadence is reached."""
        self._counts_dev = new_counts
        self._window_batches += 1
        self._window_keys += int(n_keys)
        if self._window_batches >= self.config.drain_every:
            self.drain()

    def detach(self) -> None:
        self.router.detach_load_monitor()

    # -- drain protocol ------------------------------------------------------
    def _alive_slots(self) -> list[int]:
        removed = self.router.domain.removed
        return [
            s for s in range(self.router.domain.total_count)
            if s not in removed
        ]

    def drain(self) -> np.ndarray:
        """Copy the window's per-shard counts to the host (``np.uint32``);
        evaluate the envelopes.  The device accumulator is zeroed in place
        — a memset, no upload."""
        window = self._counts_dev.cpu().numpy().view(np.uint32).copy()
        self._counts_dev.zero_()
        self._window_batches = 0
        self._window_keys = 0
        self.totals += window.astype(np.uint64)
        self.total_keys = int(self.totals.sum())
        self.drains += 1

        m = self.metrics
        m.counter("load_drains_total").inc()
        m.counter("load_keys_total").inc(int(window.sum()))
        alive = self._alive_slots()
        for s in alive:
            m.gauge("load_shard_keys", shard=str(s)).set(int(self.totals[s]))
        ratio = self.peak_over_mean(alive)
        if ratio is not None:
            m.gauge("load_peak_over_mean").set(ratio)
            self._check_balance(ratio, alive)
        self.tracker.check()
        return window

    def peak_over_mean(self, alive: list[int] | None = None) -> float | None:
        """Peak/mean cumulative load over the currently-alive shards
        (None when nothing routed yet or fewer than two shards live)."""
        if alive is None:
            alive = self._alive_slots()
        if len(alive) < 2:
            return None
        loads = self.totals[alive].astype(np.float64)
        total = loads.sum()
        if total == 0:
            return None
        return float(loads.max() / (total / len(alive)))

    def _check_balance(self, ratio: float, alive: list[int]) -> None:
        alive_keys = int(self.totals[alive].sum())
        if alive_keys < self.config.min_alarm_keys:
            return
        expected = expected_peak_over_mean(alive_keys, len(alive))
        threshold = self.config.balance_mult * expected
        if ratio > threshold:
            self.metrics.counter("balance_alarms_total").inc()
            deliver(
                BalanceDriftAlarm(
                    ratio,
                    expected,
                    threshold,
                    n_alive=len(alive),
                    total_keys=alive_keys,
                    epoch=self.router.routing_epoch,
                ),
                self.on_alarm,
            )

    def reset(self) -> None:
        """Zero every accumulator (device window + host totals)."""
        self._counts_dev.zero_()
        self._window_batches = self._window_keys = 0
        self.totals = np.zeros_like(self.totals)
        self.total_keys = 0
