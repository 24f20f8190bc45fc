"""Host microseconds a batch call takes from entry to return (the request
routing layer: coercion, dispatch, the launches), the mean over the traced
run's measured window.  Each call is far shorter than the host clock's
error, so the mean over all of them is read, not a percentile."""


def read(run):
    return run.mean(run.window.call_s, 1e6)
