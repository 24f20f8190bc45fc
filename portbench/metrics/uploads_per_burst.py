"""Host-to-device fleet uploads a burst of fleet events: the port's count
of fleet copies (``BatchRouter.uploads``), which the loop keeps with the
fleet state it records after each burst, over the run's bursts after the
start (the window's and the traced stretch's).  None where the program
keeps no such count."""


def read(run):
    states = run.history.states
    first, last = (getattr(s, "uploads", None) for s in (states[0], states[-1]))
    if first is None or last is None or len(states) < 2:
        return None
    return (last - first) / (len(states) - 1)
