"""The route call's share of its bytes bound: 8 B a key
(``portbench/roofline/route.py``) at the HBM peak, over the device time of
the call's kernels in the traced stretch."""


def read(run):
    return run.roofline_share("route")
