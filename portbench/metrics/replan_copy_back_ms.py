"""Host milliseconds of a replan's copy back (``plan_migration.copy_back``:
the three ``.cpu()`` copies of the plan and the waits they take), the mean
over the traced run's program-span stretch (``portbench/harness/spans.py``),
which holds as many replans as the window."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    from repro_torch.observability.trace import SPAN_PLAN_COPY_BACK

    return found.mean(SPAN_PLAN_COPY_BACK, 1e-6)
