"""Host microseconds of one fleet event inside a burst
(``coalesced_events.event``: the control plane and the host mirror, the
device upload deferred to the flush), the mean over the traced run's
program-span stretch (``portbench/harness/spans.py``), which holds as many
bursts as the window.  It also reads ``burst_event_us.replan``, the same in
a cell that replans."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    from repro_torch.observability.trace import SPAN_BURST_EVENT

    return found.mean(SPAN_BURST_EVENT, 1e-3)
