"""Typed theory-bound alarms — telemetry's contract with operators; the
counterpart of ``repro.observability.alarms`` (pure Python).

The same idiom as the lifecycle tier's typed errors
(``repro_torch.serving.lifecycle.errors``): each alarm composes a human message
from structured attributes it also carries, so an operator (or a chaos
invariant) can branch on machine-readable fields instead of parsing
strings.  Alarms fire when LIVE telemetry drifts from the paper's PROVEN
bounds — balance peaking past the expected-max-load envelope, or a
membership event moving more keys than the ``delta/n`` disruption bound
allows (DESIGN.md §15).

Delivery is pluggable: components take an ``on_alarm`` callback and
*emit* when one is set (production: page, log, count), or *raise* when
none is (tests, strict deployments).
"""
from __future__ import annotations


class ObservabilityAlarm(RuntimeError):
    """Base class for telemetry drift alarms."""


class BalanceDriftAlarm(ObservabilityAlarm):
    """Observed peak/mean shard load exceeded the configured multiple of the
    expected maximum — the live fleet is more skewed than the balance
    theory (peak/mean ≈ 1 + sqrt(2·n·ln n / m) for m keys over n shards)
    says random keys should ever make it.
    """

    def __init__(
        self,
        peak_over_mean: float,
        expected: float,
        threshold: float,
        *,
        n_alive: int,
        total_keys: int,
        epoch: int | None = None,
    ):
        super().__init__(
            f"balance drift: peak/mean load {peak_over_mean:.3f} exceeds "
            f"threshold {threshold:.3f} (expected {expected:.3f} for "
            f"{total_keys} keys over {n_alive} shards)"
        )
        self.peak_over_mean = peak_over_mean
        self.expected = expected
        self.threshold = threshold
        self.n_alive = n_alive
        self.total_keys = total_keys
        self.epoch = epoch


class DisruptionBoundAlarm(ObservabilityAlarm):
    """Observed moved-key fraction across a membership window exceeded the
    minimal-disruption bound — more keys remapped than ``delta`` events
    over an ``n``-shard fleet can justify (the paper's ``delta/n``
    guarantee, slack-scaled for hash-balance deviation).
    """

    def __init__(
        self,
        moved_fraction: float,
        bound: float,
        *,
        delta_events: int,
        n_before: int,
        n_after: int,
        epoch: int | None = None,
    ):
        super().__init__(
            f"disruption bound breach: moved fraction {moved_fraction:.3f} "
            f"exceeds {bound:.3f} for {delta_events} membership event(s) "
            f"over {n_before}->{n_after} alive shards"
        )
        self.moved_fraction = moved_fraction
        self.bound = bound
        self.delta_events = delta_events
        self.n_before = n_before
        self.n_after = n_after
        self.epoch = epoch


def deliver(alarm: ObservabilityAlarm, on_alarm) -> None:
    """Emit through the callback when one is set, raise otherwise."""
    if on_alarm is not None:
        on_alarm(alarm)
    else:
        raise alarm
