"""Roofline terms for one eager call on one device.

compute term    = FLOPs / peak FLOP/s (bf16 tensor cores)
memory term     = bytes / HBM bandwidth
collective term = collective bytes / NVLink per-link bandwidth

The FLOPs and bytes are ``op_cost``'s, counted over the aten ops the call
dispatched (this run's shapes); the collective bytes are the c10d ops'
that the call issued on this rank (``op_cost``), 0 on one device.
``raw_flops`` is torch's own
count (``torch.utils.flop_counter``, which also prices fused attention and
convolutions), kept beside it as the JAX package keeps XLA's
``cost_analysis()``; eager torch has no counterpart of its byte count, so
``raw_bytes`` is 0.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
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


class LiveBytes(TorchDispatchMode):
    """A meta-aware tracker of live bytes: the peak, over a call run under
    it, of the bytes of the storages its ops created, plus ``base``, the
    bytes of the tensors of ``args`` (made before it, and alive
    throughout; an op's view of one of their storages adds nothing).  A
    storage counts from the op that makes it until its last tensor is
    gone: the last Python tensor on it, or autograd's saved copy (held
    through ``saved_tensors_hooks``).  It does not count the allocator's
    rounding and caching, library workspaces, or buffers only C++ holds (a
    collective's staging)."""

    def __init__(self, args=()):
        super().__init__()
        held = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        self.base = sum(t.numel() * t.element_size() for t in held)
        self._pinned = {t.untyped_storage()._cdata for t in held}
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._pinned:
            return
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1

    def _drop(self, key) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def _track(self, owner, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        if key not in self._pinned:
            self._hold(t)
            weakref.finalize(owner, self._drop, key)

    def _pack(self, t):
        holder = _Saved(t)
        if t.untyped_storage()._cdata in self._refs:
            self._track(holder, t)
        return holder

    @staticmethod
    def _unpack(holder):
        return holder.t

    def __enter__(self):
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not any(t is a for a in tree_leaves(args)):
                self._track(t, t)
        return out

    @property
    def peak_bytes(self) -> int:
        return self.base + self.peak


class _Saved:
    """What autograd keeps of a saved tensor while ``LiveBytes`` runs."""

    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t
