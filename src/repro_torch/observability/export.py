"""Exposition: JSON snapshots + Prometheus-style text (DESIGN.md §15) —
the counterpart of ``repro.observability.export``; the same bytes.

Two read-side renderings of one registry:

* ``snapshot(registry, trace=, monitor=)`` — a plain-dict snapshot (and
  ``to_json`` for the serialized form): every metric series with labels,
  values and µs timestamps, optionally the span ring's retained spans and
  the load monitor's per-shard totals.  Deterministic under a virtual
  clock — two identical runs serialize identically, which is itself a
  chaos-suite invariant.

* ``to_prometheus(registry)`` — the text exposition format scrapers
  expect: ``# TYPE`` headers, ``name{label="v"} value`` samples,
  histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count``.
"""
from __future__ import annotations

import json

from repro_torch.observability.metrics import Histogram, MetricsRegistry


def snapshot(registry: MetricsRegistry, trace=None, monitor=None) -> dict:
    """Plain-dict snapshot of the whole telemetry plane."""
    series = []
    for m in registry.collect():
        rec = {
            "name": m.name,
            "kind": m.kind,
            "labels": dict(m.labels),
            "last_update_us": m.last_update_us,
        }
        if isinstance(m, Histogram):
            rec.update(
                count=m.count,
                sum=m.sum,
                bounds=list(m.bounds),
                bucket_counts=list(m.bucket_counts),
            )
        else:
            rec["value"] = m.value
        series.append(rec)
    out: dict = {"metrics": series}
    if trace is not None:
        out["trace"] = {
            "capacity": trace.capacity,
            "recorded": trace.total,
            "dropped": trace.dropped,
            "spans": [
                {
                    "name": s.name,
                    "t_start_us": s.t_start_us,
                    "t_end_us": s.t_end_us,
                    "tenant": s.tenant,
                    "tags": dict(s.tags),
                }
                for s in trace.spans()
            ],
        }
    if monitor is not None:
        out["load"] = {
            "total_keys": monitor.total_keys,
            "drains": monitor.drains,
            "peak_over_mean": monitor.peak_over_mean(),
            "shard_totals": {
                str(s): int(monitor.totals[s])
                for s in range(len(monitor.totals))
                if monitor.totals[s]
            },
        }
    return out


def to_json(registry: MetricsRegistry, trace=None, monitor=None, **dumps_kw) -> str:
    dumps_kw.setdefault("sort_keys", True)
    return json.dumps(
        snapshot(registry, trace=trace, monitor=monitor), **dumps_kw
    )


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{v}"' for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition of every registered series."""
    lines: list[str] = []
    typed: set[str] = set()
    for m in registry.collect():
        if m.name not in typed:
            typed.add(m.name)
            lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            running = 0
            for bound, c in zip(m.bounds, m.bucket_counts):
                running += c
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(m.labels, {'le': bound})} {running}"
                )
            running += m.bucket_counts[-1]
            lines.append(
                f"{m.name}_bucket{_fmt_labels(m.labels, {'le': '+Inf'})} "
                f"{running}"
            )
            lines.append(
                f"{m.name}_sum{_fmt_labels(m.labels)} {_fmt_value(m.sum)}"
            )
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
        else:
            lines.append(
                f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
