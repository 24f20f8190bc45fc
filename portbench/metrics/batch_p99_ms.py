"""The 99th percentile of every batch's latency in the window, on the
card's clock: from the mark recorded on an idle stream when the host issued
the batch to the event recorded behind it on the work stream."""
import statistics


def read(run):
    lat = run.window.latencies_ms
    if len(lat) < 1000:  # fewer than ten batches beyond the percentile
        return None
    return statistics.quantiles(lat, n=100)[98]
