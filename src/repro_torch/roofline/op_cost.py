"""Cost of one eager call, counted over the aten ops it dispatches — the
counterpart of the JAX package's ``repro.roofline.hlo_parse`` cost model.

A ``TorchDispatchMode`` sees every aten op a call runs, with its operands
and results, so the counts come from this run's shapes (and, where a shape
follows the data, from this run's data).  There is no trip-count walk:
eager torch runs its loops in Python, and each trip's ops are seen as they
run.

Cost model per op (``hlo_parse``'s, as far as eager ops map onto HLO):

* flops — products only: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
  ``_scaled_mm``, each 2 · prod(result dims) · contracted size (HLO's
  ``dot``; ``matmul``, ``linear`` and ``einsum`` reach torch's dispatcher
  as these).  Elementwise flops are negligible for these models;
* bytes — tensor-granularity approximation of the traffic:
  - products: 2 x result bytes + the operands' bytes;
  - ops that materialise a tensor (reductions, sort/topk, gather/index,
    scatter, cat/stack, copies and casts, padding, embedding lookups):
    2 x result bytes (one write, one read downstream);
  - in-place updates of a part of a tensor (``copy_``, ``index_put_``,
    ``slice_scatter``, ...): 2 x the update's bytes;
  - views, factories and allocation (``view``, ``expand``, ``permute``,
    ``empty``, ``zeros``, ``arange``, ...): nothing, as HLO's shape-only
    ops;
  - every other op is elementwise and counted 2 x result bytes: eager torch
    fuses nothing, so each runs at tensor granularity, as the reference
    counts elementwise ops in its entry computation;
* collective bytes — the c10d ops the call issues (``c10d.allreduce_``,
  ``allgather_``/``_allgather_base_``, ``reduce_scatter_``/
  ``_reduce_scatter_base_``, ``alltoall_``/``alltoall_base_``), each its
  operand plus its result bytes, by the reference's kind names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``;
  ``coll_by_kind``: kind -> [calls, bytes]); the same bytes are added to
  the memory traffic.  On a multi-pod mesh the bytes of a group of the
  ``pod`` axis also go to ``dcn_bytes``.  A collective over an axis of one
  rank is never issued (``repro_torch.sharding.rules``), so it costs
  nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import hw
from repro_torch.sharding import rules

#: products: op name -> index of the operand whose last dim is contracted
PRODUCTS = {
    "aten.mm.default": 0,
    "aten.bmm.default": 0,
    "aten.addmm.default": 1,
    "aten.baddbmm.default": 1,
    "aten._scaled_mm.default": 0,
}

#: in-place updates of part of a tensor (counted 2 x the update's bytes):
#: op name stem -> index of the update operand
UPDATES = {"copy_": 1, "index_put_": 2, "index_put": 2, "slice_scatter": 1,
           "select_scatter": 1, "index_add_": 3, "scatter_": 3, "scatter_add_": 3,
           "masked_scatter_": 2}

#: views, factories and allocation: no traffic
SHAPE_ONLY = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose",
    "select", "slice", "unsqueeze", "squeeze", "as_strided", "alias", "detach",
    "lift_fresh", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "view_as_real", "view_as_complex", "diagonal", "unfold", "_reshape_alias",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "arange", "scalar_tensor", "new_empty",
    "new_zeros", "new_ones", "new_full", "_local_scalar_dense", "resize_",
    "set_", "sym_size", "sym_stride", "sym_numel", "is_same_size", "rand",
    "randn", "randint", "lift",
}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * hw.BYTES_PER_DTYPE.get(t.dtype, t.element_size())


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def stem(name: str) -> str:
    """``aten.add_.Tensor`` -> ``add_``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    dcn_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    #: op name -> [calls, flops, bytes], to explain a total op by op
    by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes_: float) -> None:
        self.flops += flops
        self.bytes += nbytes_
        e = self.by_op.setdefault(name, [0, 0.0, 0.0])
        e[0] += 1
        e[1] += flops
        e[2] += nbytes_


#: c10d ops: name -> (kind, index of the operand argument, index of the
#: result argument)
COLLECTIVES = {
    "c10d.allreduce_.default": ("all-reduce", 0, 0),
    "c10d.allgather_.default": ("all-gather", 1, 0),
    "c10d._allgather_base_.default": ("all-gather", 1, 0),
    "c10d.reduce_scatter_.default": ("reduce-scatter", 1, 0),
    "c10d._reduce_scatter_base_.default": ("reduce-scatter", 1, 0),
    "c10d.alltoall_.default": ("all-to-all", 1, 0),
    "c10d.alltoall_base_.default": ("all-to-all", 1, 0),
}


def _group_name(args) -> str | None:
    """The name of the process group among a c10d op's arguments."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).group_name
    return None


def op_cost(name: str, args, kwargs, out) -> tuple:
    """``(flops, bytes)`` of one dispatched op."""
    outs = _tensors(out)
    result = sum(nbytes(t) for t in outs)
    if name in PRODUCTS:
        lhs = args[PRODUCTS[name]]
        flops = 2.0 * math.prod(outs[0].shape) * lhs.shape[-1]
        return flops, 2 * result + sum(nbytes(t) for t in _tensors(args))
    s = stem(name)
    if s in SHAPE_ONLY:
        return 0.0, 0
    if s in UPDATES:
        operands = list(args) + list(kwargs.values())
        k = UPDATES[s]
        upd = _tensors(operands[k]) if k < len(operands) else outs
        return 0.0, 2 * sum(nbytes(t) for t in upd)
    return 0.0, 2 * result  # materialising and elementwise ops alike


class CostMode(TorchDispatchMode):
    """Counts the ``Cost`` of every op run under it (the pod axis of the
    mesh active when it is made decides what counts as DCN)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        mesh = rules.current_mesh()
        names = rules.layout(mesh).axis_names if mesh is not None else ()
        self.pod_groups = ({mesh.get_group("pod").group_name}
                           if "pod" in names and hasattr(mesh, "get_group") else set())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        if name in COLLECTIVES:
            kind, i_op, i_res = COLLECTIVES[name]
            nb = (sum(nbytes(t) for t in _tensors(args[i_op]))
                  + sum(nbytes(t) for t in _tensors(args[i_res])))
            c = self.cost
            c.coll_bytes += nb
            if _group_name(args) in self.pod_groups:
                c.dcn_bytes += nb
            e = c.coll_by_kind.setdefault(kind, [0, 0])
            e[0] += 1
            e[1] += nb
            c.add(name, 0.0, nb)
        else:
            self.cost.add(name, *op_cost(name, args, kwargs, out))
        return out


def count(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once; returns ``(its result, Cost)``."""
    with CostMode() as mode:
        result = fn(*args, **kwargs)
    return result, mode.cost
