"""R-way placement over failure domains: the store's placement with rack
fault tolerance, as HDFS's rack-fault-tolerant placement of an
erasure-coded block group asks for it.  This docstring is where its
semantics are written down; the port is held to them exactly.

The layout: ``racks`` racks of ``nodes_per_rack`` DataNodes, DataNode ``d``
in rack ``d // nodes_per_rack``; a global DataNode id is ``rack x
nodes_per_rack + local``.  Two levels of fleet, each a slot space of fixed
size with a removed set and a replacement table (``Level``):

* the node level of rack ``g``: its ``nodes_per_rack`` DataNodes.  A
  DataNode event (a failure or a recovery, the rack's last slot included)
  updates it;
* the rack level: ``racks`` slots, rack ``g`` alive while at least one of
  its DataNodes is.  The event that fails a rack's last alive DataNode
  fails the rack there; the one that recovers a DataNode of a dead rack
  recovers the rack.

For a group key ``k`` and column ``j`` (``0 .. r - 1``):

* **rack level**: the store's R-way placement (``placement.place``: the
  family keys, the family route with the divert, and the
  distinct-resolution pass with its default ``max_resalt = r``) over the
  rack fleet gives column ``j`` its rack ``g_j``: ``r`` distinct alive
  racks while at least ``r`` racks are alive;
* **node level**: column ``j``'s DataNode is the route, lookup and divert
  (``hashing.lookup`` over the rack's slot space, then ``hashing.divert``
  under the rack's fleet), of the node key ``mix32(k ^ (family_salt(j) ^
  NODE_SALT))`` over the fleet of rack ``g_j``, as the global id ``g_j x
  nodes_per_rack + local``.  The node salts differ from every family salt
  (the rack level's) and from the re-salt.

What that guarantees:

* every group on ``r`` distinct alive DataNodes in ``r`` distinct racks
  while at least ``r`` racks have an alive DataNode, and no group
  exhausted;
* a DataNode event that leaves the rack level as it was (no rack loses
  its last alive DataNode or gets one back) changes no rack column;
* a column sits on its base DataNode (its node key's lookup over the
  rack's slot space, which ``nodes`` also returns) while that DataNode is
  alive.  So between two
  epochs with the same rack column, a block moves only where its base
  failed or recovered (the failed DataNode's blocks, and those coming
  back), or where its base was down at both: a block diverted before,
  which the table divert may re-aim inside the rack, because its redirect
  is seeded by the rack's alive count.  A rack with no failure before
  moves exactly the failed DataNode's blocks; each moved block stays in
  its rack;
* fewer than ``r`` alive racks is the store's degraded mode (the
  placement's defined duplicates of earlier racks), never a silent
  shared rack: the program names the mode.

Nothing here imports the port, JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.fleet import FAIL, RECOVER, Tensors
from portbench.reference.hashing import GOLDEN32, MASK32, divert, lookup, mix32
from portbench.reference.placement import moved, place as place_columns

__all__ = ["NODE_SALT", "Layout", "Level", "Racks", "moved", "node_keys", "nodes", "place",
           "replay"]

NODE_SALT = 0x2545F491


@dataclasses.dataclass(frozen=True)
class Layout:
    """``racks`` racks of ``nodes_per_rack`` DataNodes; each level's packed
    table is the next power of two of its slots."""

    racks: int
    nodes_per_rack: int

    @classmethod
    def of(cls, config: dict) -> "Layout":
        return cls(config["racks"], config["nodes_per_rack"])

    @property
    def n_nodes(self) -> int:
        return self.racks * self.nodes_per_rack

    @property
    def rack_capacity(self) -> int:
        return 1 << (self.racks - 1).bit_length()

    @property
    def node_capacity(self) -> int:
        return 1 << (self.nodes_per_rack - 1).bit_length()


class Level:
    """Slots ``0 .. n - 1``, none ever added or taken away: a failure swaps
    its slot to the end of the table's alive prefix and shrinks it, a
    recovery swaps it to the first position past the prefix and grows it."""

    def __init__(self, n: int):
        self.slots = list(range(n))
        self.pos = list(range(n))
        self.n_alive = n
        self.removed: set[int] = set()

    @property
    def n_total(self) -> int:
        return len(self.slots)

    def _swap(self, i: int, j: int) -> None:
        si, sj = self.slots[i], self.slots[j]
        self.slots[i], self.slots[j] = sj, si
        self.pos[si], self.pos[sj] = j, i

    def fail(self, slot: int) -> None:
        if slot in self.removed:
            raise ValueError(f"slot {slot} is already failed")
        self._swap(self.pos[slot], self.n_alive - 1)
        self.n_alive -= 1
        self.removed.add(slot)

    def recover(self, slot: int) -> None:
        if slot not in self.removed:
            raise ValueError(f"slot {slot} is not failed")
        self._swap(self.pos[slot], self.n_alive)
        self.n_alive += 1
        self.removed.discard(slot)

    def copy(self) -> "Level":
        out = Level.__new__(Level)
        out.slots, out.pos = list(self.slots), list(self.pos)
        out.n_alive, out.removed = self.n_alive, set(self.removed)
        return out

    def tensors(self, device) -> Tensors:
        removed = torch.zeros(self.n_total, dtype=torch.bool)
        removed[sorted(self.removed)] = True
        return Tensors(removed.to(device), torch.tensor(self.slots, dtype=torch.int64, device=device),
                       self.n_total, self.n_alive)

    def packed(self, capacity: int) -> tuple:
        """Removed-slot bit words ``(ceil(capacity / 32),)``, the table
        ``(capacity,)`` (zeros past the slot space) and ``[n_total,
        n_alive]``, each as int32."""
        words = np.zeros(max(1, -(-capacity // 32)), dtype=np.uint32)
        for b in self.removed:
            words[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        table = np.zeros(capacity, dtype=np.int32)
        table[: self.n_total] = self.slots
        return words.view(np.int32), table, np.array([self.n_total, self.n_alive], np.int32)


@dataclasses.dataclass
class RackTensors:
    racks: Tensors  #: the rack level
    nodes: list  #: the node level of each rack (``Tensors``)
    nodes_per_rack: int


class Racks:
    """Both levels of a layout; ``apply`` takes ``(kind, DataNode)``
    events."""

    def __init__(self, layout: Layout):
        self.layout = layout
        self.rack_level = Level(layout.racks)
        self.node_levels = [Level(layout.nodes_per_rack) for _ in range(layout.racks)]

    def apply(self, kind: str, node: int) -> None:
        if not 0 <= node < self.layout.n_nodes:
            raise ValueError(f"DataNode {node} is outside the layout")
        rack, local = divmod(node, self.layout.nodes_per_rack)
        level = self.node_levels[rack]
        if kind == FAIL:
            level.fail(local)
            if level.n_alive == 0:
                self.rack_level.fail(rack)
        elif kind == RECOVER:
            level.recover(local)
            if level.n_alive == 1:
                self.rack_level.recover(rack)
        else:
            raise ValueError(f"unknown event {kind!r}")

    def copy(self) -> "Racks":
        out = Racks.__new__(Racks)
        out.layout, out.rack_level = self.layout, self.rack_level.copy()
        out.node_levels = [lv.copy() for lv in self.node_levels]
        return out

    def tensors(self, device) -> RackTensors:
        return RackTensors(self.rack_level.tensors(device),
                           [lv.tensors(device) for lv in self.node_levels],
                           self.layout.nodes_per_rack)

    def packed(self) -> tuple:
        """The rack level's three arrays, then the node levels' stacked a
        row a rack: ``(R, W)`` words, ``(R, C)`` tables, ``(R, 2)`` states."""
        rack = self.rack_level.packed(self.layout.rack_capacity)
        nodes = [lv.packed(self.layout.node_capacity) for lv in self.node_levels]
        return (*rack, *(np.stack([p[i] for p in nodes]) for i in range(3)))


def replay(layout: Layout, bursts) -> list:
    """Both levels after each burst of ``bursts`` (lists of events), in
    order: element ``e`` is the state epoch ``e`` places under."""
    racks, states = Racks(layout), []
    for burst in bursts:
        for kind, node in burst:
            racks.apply(kind, node)
        states.append(racks.copy())
    return states


def node_keys(keys: torch.Tensor, r: int) -> torch.Tensor:
    """(N,) u32 keys -> (N, r) u32 node keys (int64)."""
    j = torch.arange(r, dtype=torch.int64, device=keys.device)
    salts = (((j * 7919 + 1) * GOLDEN32) & MASK32) ^ NODE_SALT
    return mix32(keys[:, None] ^ salts)


def nodes(keys: torch.Tensor, racks: torch.Tensor, fleet: RackTensors,
          omega: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The node level: (N,) u32 keys and their rack columns (N, r) ->
    ``(DataNodes, bases)``, both (N, r) int64 global ids under ``fleet``'s
    node levels.  A column's base is the lookup of its node key over its
    rack's slot space (the same for every rack); a base its rack has
    removed is diverted through that rack's table."""
    keys2 = node_keys(keys, racks.shape[1])
    npr = fleet.nodes_per_rack
    local = lookup(keys2, npr, omega)
    base = racks * npr + local
    hit = torch.cat([level.removed for level in fleet.nodes])[base]
    out = base.clone()
    rows, cols = hit.nonzero(as_tuple=True)
    rack_of = racks[rows, cols]
    for g in torch.unique(rack_of).tolist():
        sel = rack_of == g
        i, j = rows[sel], cols[sel]
        level = fleet.nodes[g]
        out[i, j] = g * npr + divert(keys2[i, j], local[i, j], level.removed, level.slots,
                                     level.n_total, level.n_alive)
    return out, base


def place(keys: torch.Tensor, fleet: RackTensors, omega: int, r: int,
          max_resalt: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) u32 keys (int64) -> ``(DataNodes (N, r) int64, exhausted (N,)
    bool)``."""
    racks, exhausted = place_columns(keys, fleet.racks, omega, r, max_resalt)
    return nodes(keys, racks, fleet, omega)[0], exhausted
