"""Carry fleet state and model parameters across from the JAX package's
host arrays.

``fleet_from_numpy``
turns the numpy leaves of the reference's host ``FleetState`` (as
``repro.core.bulk.FleetState.pack`` builds them: a ``(1, W')`` uint32 mask
and a ``(1, C')`` int32 table, both padded to 128 lanes, and a ``(2,)``
uint32 state) into this package's host ``FleetState``.
``params_from_numpy`` turns the reference's ``init_params`` tree, as numpy
arrays, into this package's model parameters.  Only numpy crosses over;
nothing of the JAX package is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bulk import FleetState
from repro_torch.core.memento_torch import mask_words, table_width
from repro_torch.models.blocks import build_segments


def fleet_from_numpy(packed, table, state, capacity: int) -> FleetState:
    """Reference host fleet leaves -> host ``FleetState`` for ``capacity``
    (lane padding dropped; ``.to(device)`` makes the device twin)."""
    packed = np.asarray(packed, dtype=np.uint32).reshape(-1)
    table = np.asarray(table, dtype=np.int32).reshape(-1)
    state = np.asarray(state, dtype=np.uint32).reshape(-1)
    words, slots = mask_words(capacity), table_width(capacity)
    if packed.size < words or table.size < slots or state.size != 2:
        raise ValueError(
            f"fleet arrays too small for capacity {capacity}: mask "
            f"{packed.size} words (< {words}?), table {table.size} slots "
            f"(< {slots}?), state {state.size} (!= 2?)"
        )
    if packed[words:].any():
        raise ValueError(f"removed bits set past capacity {capacity}")
    return FleetState(
        packed=packed[:words].copy(), table=table[:slots].copy(),
        state=state.copy(), capacity=capacity,
    )


def _tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included, as JAX hands it over) -> tensor."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def params_from_numpy(tree, cfg: ArchConfig, device) -> dict:
    """The reference's parameters (``params["embed"]``,
    ``params["final_norm"]``, ``params["seg{i}"]["sub{j}"]`` with every
    leaf stacked along its segment's scan axis) as numpy arrays -> this
    package's ``{"embed", "final_norm", "layers"}`` on ``device``.  Step
    ``s`` of sub-block ``j`` of segment ``i`` is layer
    ``seg.base + s * len(seg.unit) + j``."""
    layers: list = [None] * cfg.num_layers
    for i, seg in enumerate(build_segments(cfg)):
        for j in range(len(seg.unit)):
            sub = tree[f"seg{i}"][f"sub{j}"]
            for s in range(seg.count):
                layers[seg.base + s * len(seg.unit) + j] = _tree(sub, lambda a, s=s: _tensor(a[s], device))
    return {
        "embed": _tree(tree["embed"], lambda a: _tensor(a, device)),
        "final_norm": _tree(tree["final_norm"], lambda a: _tensor(a, device)),
        "layers": layers,
    }
