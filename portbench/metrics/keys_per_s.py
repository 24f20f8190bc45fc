"""Keys routed, or objects placed, a second: every key of every batch the
window issued, over the window's host-clock length (first issue to last
completion).

It also reads ``keys_per_s.replan``, the same rate in a cell that replans
after every burst, the replans' time included.  That rate takes a bound of
its own: each plan is copied back into fresh pageable host memory, whose
pace swings from process to process, so it spreads wider than the others.
"""


def read(run):
    w = run.window
    return w.items / w.seconds if w.seconds > 0 else None
