"""Roofline terms for one eager call on one device.

compute term    = FLOPs / peak FLOP/s (bf16 tensor cores)
memory term     = bytes / HBM bandwidth
collective term = collective bytes / NVLink per-link bandwidth

The FLOPs and bytes are ``op_cost``'s, counted over the aten ops the call
dispatched (this run's shapes).  The collective term is 0 on one device
until the multi-device path is ported.  ``raw_flops`` is torch's own
count (``torch.utils.flop_counter``, which also prices fused attention and
convolutions), kept beside it as the JAX package keeps XLA's
``cost_analysis()``; eager torch has no counterpart of its byte count, so
``raw_bytes`` is 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline import hw
from repro_torch.roofline.op_cost import CostMode


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    dcn_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: dict
    raw_flops: float
    raw_bytes: float

    def row(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def analyze(fn, *args, n_chips: int = 1, model_flops_total: float = 0.0, **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and return its roofline terms.
    ``model_flops_total``: 6·N·D (train) or 2·N·D (forward only), the WHOLE
    program's; ``useful_ratio`` is it over the counted FLOPs of all chips."""
    with FlopCounterMode(display=False) as torch_count, CostMode() as mode:
        fn(*args, **kwargs)
    cost = mode.cost
    compute_s = cost.flops / hw.PEAK_FLOPS_BF16
    memory_s = cost.bytes / hw.HBM_BW
    collective_s = cost.coll_bytes / hw.NVLINK_LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes,
        dcn_bytes=cost.dcn_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=max(terms, key=terms.get),
        model_flops=model_flops_total,
        useful_ratio=model_flops_total / max(cost.flops * n_chips, 1.0),
        collectives={k: tuple(v) for k, v in cost.coll_by_kind.items()},
        raw_flops=float(torch_count.get_total_flops()),
        raw_bytes=0.0,
    )


def memory_summary(device="cuda") -> dict:
    """The CUDA caching allocator's byte counts on ``device``: what is
    allocated and reserved now and at the peak since the last
    ``torch.cuda.reset_peak_memory_stats``."""
    stats = torch.cuda.memory_stats(device)
    return {
        "allocated_bytes": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_allocated_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        "peak_reserved_bytes": int(stats.get("reserved_bytes.all.peak", 0)),
    }
