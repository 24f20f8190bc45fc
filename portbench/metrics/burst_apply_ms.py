"""Host milliseconds a burst of fleet events takes through the lifecycle
(``coalesced_events``: each event on the host, then one upload of the fleet
state), the mean over the traced run's measured window."""


def read(run):
    return run.mean(run.window.burst_s, 1e3)
