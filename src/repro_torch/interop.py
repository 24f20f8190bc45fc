"""Carry fleet state, lifecycle journals, placement registries and model
parameters across from the JAX package's host arrays and JSON text.

``fleet_from_numpy``
turns the numpy leaves of the reference's host ``FleetState`` (as
``repro.core.bulk.FleetState.pack`` builds them: a ``(1, W')`` uint32 mask
and a ``(1, C')`` int32 table, both padded to 128 lanes, and a ``(2,)``
uint32 state) into this package's host ``FleetState``.
``lifecycle_from_json`` turns a reference ``MembershipJournal`` (its
``to_jsonl`` text) or ``JournalSnapshot`` (its ``to_json`` text) into this
package's.  ``store_from_numpy`` turns a reference ``StorePlacement``'s
registered ``keys`` and ``holders`` into this package's ``StorePlacement``
over a router.  ``params_from_numpy`` turns the reference's ``init_params``
tree, as numpy arrays, into this package's per-layer serving parameters;
``train_state_from_numpy`` turns a reference train state (or its stacked
parameters) into this package's, which keeps the reference's layout.  Only numpy
and text cross over; nothing of the JAX package is imported.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bulk import FleetState
from repro_torch.core.memento_torch import mask_words, table_width
from repro_torch.models.blocks import build_segments, layer_index
from repro_torch.placement.store import StorePlacement
from repro_torch.serving.lifecycle.journal import JournalSnapshot, MembershipJournal
from repro_torch.sharding.rules import params_local
from repro_torch.tree import tree_map


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


def lifecycle_from_json(text: str) -> MembershipJournal | JournalSnapshot:
    """A reference journal's JSONL text (a ``{"n_initial"}`` header line,
    then one event per line) -> ``MembershipJournal``; a reference
    snapshot's JSON text -> ``JournalSnapshot``.  Both serialise back to the
    same bytes."""
    first = next((ln for ln in text.splitlines() if ln.strip()), None)
    if first is None or "n_initial" in json.loads(first):
        return MembershipJournal.from_jsonl(text)
    return JournalSnapshot.from_json(first)


def store_from_numpy(router, keys, holders, *, max_resalt: int | None = None,
                     strict: bool = False) -> StorePlacement:
    """A reference ``StorePlacement``'s registered ``keys`` (M,) and
    ``holders`` (M, r) -> this package's ``StorePlacement`` over ``router``
    (the port's router, built from the same fleet events), with ``r`` taken
    from the holders.  The holders are copied as they stand, mid-repair
    too; the migration baseline is the router's current fleet."""
    holders = np.array(holders, dtype=np.int64)
    keys = np.array(keys, dtype=np.uint32).reshape(-1)
    if holders.ndim != 2 or holders.shape[0] != keys.size:
        raise ValueError(f"holders {holders.shape} do not give one row per key ({keys.size})")
    store = StorePlacement(router, r=holders.shape[1], max_resalt=max_resalt, strict=strict)
    store._keys, store._holders = keys, holders
    return store


def _tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included, as JAX hands it over) -> tensor."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _cut(tree, specs):
    """Each leaf of ``tree`` cut to this rank's block of the matching spec
    of ``specs`` (a tree of the same shape with ``P`` leaves)."""
    from repro_torch.sharding.rules import P, current_mesh, local_slice

    if isinstance(specs, P):
        return local_slice(tree, specs, current_mesh())
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k]) for k, v in tree.items()}
    return [_cut(v, s) for v, s in zip(tree, specs)]


def train_state_from_numpy(tree, device, *, local: bool = False) -> dict:
    """A reference train state as numpy arrays (``params`` in its stacked
    layout, ``opt`` with AdamW's ``m``/``v``/``master`` trees or
    Adafactor's ``f`` list, ``step``, ``comp_err``), or any part of one such
    as its ``params`` -> the same tree of tensors on ``device``, which is
    the port's train state: training holds the reference's layout, so every
    leaf keeps its path and shape.

    ``local=True`` (under an active ``DeviceMesh``; a whole state) gives
    this rank only its blocks: ``params`` cut by ``params_pspecs``, ``opt``
    and ``comp_err`` by ``zero1_pspecs`` (ZeRO-1: the residual of gradient
    compression in the blocks of ``m``), the rest whole, as the reference's
    jitted step's in-shardings hand each device its blocks."""
    if local:
        from repro_torch.sharding.rules import params_pspecs
        from repro_torch.training.optimizer import zero1_pspecs

        pspecs = params_pspecs(tree["params"])
        cut = dict(params=_cut(tree["params"], pspecs),
                   opt=_cut(tree["opt"], zero1_pspecs(tree["params"], pspecs, tree["opt"])))
        if "comp_err" in tree:
            wide = zero1_pspecs(tree["params"], pspecs, {"m": tree["comp_err"]})["m"]
            cut["comp_err"] = _cut(tree["comp_err"], wide)
        tree = dict(tree, **cut)
    return tree_map(lambda a: _tensor(a, device), tree)


def params_from_numpy(tree, cfg: ArchConfig, device, *, local: bool = False) -> dict:
    """The reference's parameters (``params["embed"]``,
    ``params["final_norm"]``, ``params["seg{i}"]["sub{j}"]`` with every
    leaf stacked along its segment's scan axis, and ``params["mtp"]`` where
    the config has one) as numpy arrays -> this package's ``{"embed",
    "final_norm", "layers"}`` (and ``"mtp"``) on ``device``.  Step ``s`` of
    sub-block ``j`` of segment ``i`` is layer ``seg.base + s *
    len(seg.unit) + j``.  Every leaf keeps its name and layout (MLA's
    per-head projections, ``router_bias``, ``shared`` included).

    ``local=True`` gives this rank only its block of every leaf, by the
    leaf's spec under the active mesh (``repro_torch.sharding.rules
    .params_local``), as the reference's ``shard_map`` in-specs hand each
    device its block."""
    if local:
        tree = params_local(tree)
    layers: list = [None] * cfg.num_layers
    for i, seg in enumerate(build_segments(cfg)):
        for j in range(len(seg.unit)):
            sub = tree[f"seg{i}"][f"sub{j}"]
            for s in range(seg.count):
                layers[layer_index(seg, s, j)] = tree_map(lambda a, s=s: _tensor(a[s], device), sub)
    params = {
        "embed": tree_map(lambda a: _tensor(a, device), tree["embed"]),
        "final_norm": tree_map(lambda a: _tensor(a, device), tree["final_norm"]),
        "layers": layers,
    }
    if "mtp" in tree:  # not stacked: one module
        params["mtp"] = tree_map(lambda a: _tensor(a, device), tree["mtp"])
    return params
