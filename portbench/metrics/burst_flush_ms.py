"""Host milliseconds of a burst's flush (``coalesced_events.flush``: the
mirror resynced, then one ``fleet.upload``, with any wait the copy takes),
the mean over the traced run's program-span stretch
(``portbench/harness/spans.py``), which holds as many bursts as the window.
It also reads ``burst_flush_ms.replan``, the same in a cell that replans."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    from repro_torch.observability.trace import SPAN_BURST_FLUSH

    return found.mean(SPAN_BURST_FLUSH, 1e-6)
