"""The place call's share of its bytes bound: 4 + 4 r + 1 B an object
(``portbench/roofline/place.py``) at the HBM peak, over the device time of
the call's two kernels (the family route and ``resolve``) in the traced
stretch; the replans' kernels are left out."""


def read(run):
    return run.roofline_share("place")
