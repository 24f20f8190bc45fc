"""Host microseconds of a batch call's launch stage, as the port records it
(``route_keys.launch``: the output's allocation, the arguments and the one
launch; ``place_keys.launch``: both launches), the mean over the traced
run's program-span stretch (``portbench/harness/spans.py``)."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    from repro_torch.observability.trace import SPAN_PLACE_LAUNCH, SPAN_ROUTE_LAUNCH

    stage = {"route": SPAN_ROUTE_LAUNCH, "place": SPAN_PLACE_LAUNCH}[run.call]
    return found.mean(stage, 1e-3)
