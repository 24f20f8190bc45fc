"""The node route's share of its bytes bound: 4 + 8 r B a group
(``portbench/roofline/node_route.py``) at the HBM peak, over the device time
of that one kernel a batch: its time by name in the traced stretch's
device operations, over the count of calls.  ``Run.roofline_share`` takes
every kernel of the call, so it cannot give one kernel's share.  None
where the port has no such kernel."""
from portbench.harness import trace

KERNEL = "node_route_kernel"


def read(run):
    p = run.profile
    if p is None or not p.counts.get("call"):
        return None
    seconds = sum(s for name, s in p.device_ops if trace.kernel_name(name) == KERNEL)
    if seconds <= 0:
        return None
    nbytes = run.bench.roofline("node_route").bytes_per_item(run.config) * run.workload["batch_keys"]
    return 100.0 * nbytes / run.bench.peaks()["hbm_bytes_per_s"] / (seconds / p.counts["call"])
