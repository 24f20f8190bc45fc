"""Host milliseconds a replan spends uploading (``plan_migration.keys_up``,
the registered keys, plus ``plan_migration.fleet_up``, the fleets), the
mean a replan over the traced run's program-span stretch
(``portbench/harness/spans.py``), which holds as many replans as the
window."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    from repro_torch.observability.trace import SPAN_PLAN, SPAN_PLAN_FLEET_UP, SPAN_PLAN_KEYS_UP

    count, _ = found.totals.get(SPAN_PLAN, (0, 0))
    if not count:
        return None
    ns = sum(found.totals.get(s, (0, 0))[1] for s in (SPAN_PLAN_KEYS_UP, SPAN_PLAN_FLEET_UP))
    return ns / count * 1e-6
