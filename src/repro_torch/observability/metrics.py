"""Lock-free counter/gauge/histogram registry with integer-µs timestamps —
the counterpart of ``repro.observability.metrics`` (pure Python).

The telemetry substrate of the serving stack (DESIGN.md §15).  Every metric
update is a single-writer CPython int/float mutation — no locks anywhere,
so the hot path (admission verdicts, batch closes, hedge outcomes) pays a
dict lookup it can cache away plus one add.  Timestamps come from the
streaming tier's µs clocks (``serving/streaming/clock.py``): a registry
built over a ``VirtualClockUs`` is bit-deterministic run to run (the chaos
suite asserts two identical virtual runs produce identical histogram
contents), and production swaps in ``WallClockUs`` with no other change —
one pipeline for both.

Metrics are identified by ``(name, labels)``: ``registry.counter("x",
tenant="a")`` and ``tenant="b"`` are two series of one *family*.  The
first creation pins a name's kind (and a histogram's bucket bounds);
mismatching re-use is a loud ``ValueError``, never a silent second family.
"""
from __future__ import annotations

import bisect

#: default histogram bounds, µs — geometric from sub-batch-window to
#: seconds-scale, matching where streaming latency actually lands
DEFAULT_BUCKETS_US = (
    50, 100, 200, 400, 800, 1_600, 3_200, 6_400, 12_800,
    25_600, 51_200, 102_400, 409_600, 1_638_400,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotone integer counter."""

    kind = "counter"
    __slots__ = ("name", "labels", "value", "last_update_us", "_clock")

    def __init__(self, name: str, labels: dict, clock):
        self.name = name
        self.labels = dict(labels)
        self.value = 0
        self.last_update_us = clock.now_us()
        self._clock = clock

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone; inc({n}) would regress")
        self.value += n
        self.last_update_us = self._clock.now_us()


class Gauge:
    """Last-write-wins float gauge."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value", "last_update_us", "_clock")

    def __init__(self, name: str, labels: dict, clock):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0
        self.last_update_us = clock.now_us()
        self._clock = clock

    def set(self, value: float) -> None:
        self.value = float(value)
        self.last_update_us = self._clock.now_us()


class Histogram:
    """Fixed-bound histogram: cumulative-style buckets plus count/sum.

    ``bounds`` are inclusive upper edges (Prometheus ``le`` semantics);
    one implicit +inf bucket catches the tail.  Contents are a pure
    function of the observation sequence — no sampling, no decay — which
    is what makes virtual-clock runs reproducible.
    """

    kind = "histogram"
    __slots__ = (
        "name", "labels", "bounds", "bucket_counts", "count", "sum",
        "last_update_us", "_clock",
    )

    def __init__(self, name: str, labels: dict, clock, bounds=None):
        bounds = tuple(bounds) if bounds is not None else DEFAULT_BUCKETS_US
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must strictly increase: {bounds}")
        self.name = name
        self.labels = dict(labels)
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # +1: the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.last_update_us = clock.now_us()
        self._clock = clock

    def observe(self, value: float) -> None:
        self.bucket_counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        self.last_update_us = self._clock.now_us()

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create home for every metric series, keyed by (name, labels).

    One registry per serving stack: the front end builds one over its own
    clock and threads it through admission, batching, hedging, breakers
    and the load monitor, so ``export.to_prometheus(registry)`` /
    ``export.snapshot(...)`` see the whole stack in one place.
    """

    def __init__(self, clock=None):
        if clock is None:
            from repro_torch.serving.streaming.clock import WallClockUs

            clock = WallClockUs()
        self.clock = clock
        self._metrics: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}

    def _get_or_make(self, cls, name: str, labels: dict, **kwargs):
        key = (name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is not None:
            if metric.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} is a {metric.kind}, requested {cls.kind}"
                )
            return metric
        pinned = self._kinds.setdefault(name, cls.kind)
        if pinned != cls.kind:
            raise ValueError(
                f"metric family {name!r} is pinned to kind {pinned!r}, "
                f"requested {cls.kind!r}"
            )
        metric = cls(name, labels, self.clock, **kwargs)
        self._metrics[key] = metric
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_make(Gauge, name, labels)

    def histogram(self, name: str, bounds=None, **labels) -> Histogram:
        h = self._get_or_make(Histogram, name, labels, bounds=bounds)
        if bounds is not None and tuple(bounds) != h.bounds:
            raise ValueError(
                f"histogram {name!r} already exists with bounds {h.bounds}, "
                f"requested {tuple(bounds)}"
            )
        return h

    # -- read side -----------------------------------------------------------
    def family(self, name: str) -> dict[tuple, object]:
        """Every series of one family: ``{sorted-label-items: metric}``."""
        return {
            key[1]: m for key, m in self._metrics.items() if key[0] == name
        }

    def total(self, name: str, **match) -> int:
        """Sum a counter family, optionally restricted to matching labels."""
        out = 0
        for m in self.family(name).values():
            if all(m.labels.get(k) == v for k, v in match.items()):
                out += m.value
        return out

    def collect(self):
        """Every series, sorted by (name, labels) for stable exposition."""
        return [self._metrics[k] for k in sorted(self._metrics)]
