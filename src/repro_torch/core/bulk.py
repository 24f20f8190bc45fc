"""Engine-agnostic bulk-routing API: ``RouterSpec``, ``FleetState``,
``PlacementSpec``, ``BulkEngine`` (DESIGN.md §10).

* ``RouterSpec`` — the frozen configuration of one routing datapath
  (engine, capacity, ω, and the mesh-sharded datapath's shard axis and key
  donation), validated at construction.
* ``FleetState`` — the fleet's device operands (packed removed-slot
  bit-words, replacement-table ``slots`` permutation, ``[n_total,
  n_alive]``) with the pack / incremental-update hooks the serving tier
  drives at fleet-event time.  The host instance holds numpy arrays;
  ``to(device)`` makes the device twin in one copy.
* ``ChainFleet`` — the operands of the chain-mode two-pass path (packed
  removed-slot bit-words and ``[n_total, first_alive]``), packed from a
  ``resolve="chain"`` domain.
* ``PlacementSpec`` — the frozen configuration of one R-way replicated
  placement tier over a ``RouterSpec`` (DESIGN.md §13), with or without
  ``FailureDomains``.
* ``FailureDomains`` — the map from DataNode to rack of a placement over
  failure domains; ``RackDomains`` its two-level control plane (a rack
  fleet, and a node fleet a rack) and ``RackFleet`` their device operands,
  which ``to_device`` uploads in one copy.
* ``BulkEngine`` — one engine's bundle: the name of its scalar oracle and
  its routing kernels (``repro_torch.kernels.fused.RoutingKernels``).

Whether a kernel or its plain version runs is decided by the tensors'
device alone: CUDA tensors launch the kernels, CPU tensors take the plain
torch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.bits import next_pow2
from repro_torch.core.memento import ReplacementTable
from repro_torch.core.memento_torch import chain_state, mask_words, pack_removed_mask, pack_table

#: engines that step through f32 arithmetic (jump) need b+1 exact in a
#: float32 mantissa, so the slot space is bounded well below u32
MAX_CAPACITY = 1 << 24


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Frozen configuration of one bulk-routing datapath.

    engine    BULK_ENGINES name selecting the device datapath (and its
              scalar control-plane oracle)
    capacity  power-of-two bound on the fleet slot space — sizes the packed
              mask words and the replacement table, fixed across arbitrary
              event streams
    omega     lookup iteration bound (binomial's ω; jump's step bound) —
              shared by oracle and kernel so scalar == batch holds at
              non-default values too
    shard_axis  mesh axis the sharded datapath splits key batches over
              (``repro_torch.kernels.ops.make_sharded_route``)
    donate_keys the sharded route writes its replica ids into the key
              buffer it is given (the caller must not reuse it); the
              serving tier sets it for key batches it uploads itself
    """

    engine: str = "binomial"
    capacity: int = 64
    omega: int = 16
    shard_axis: str = "data"
    donate_keys: bool = False

    def __post_init__(self):
        if self.capacity < 1 or self.capacity & (self.capacity - 1):
            raise ValueError(
                f"capacity must be a power of two (got {self.capacity}); the "
                "packed mask words tile evenly only at pow2 capacities"
            )
        if self.capacity > MAX_CAPACITY:
            raise ValueError(
                f"capacity {self.capacity} exceeds {MAX_CAPACITY}; f32-stepping "
                "engines (jump) need slot ids exact in a float32 mantissa"
            )
        if self.omega < 1:
            raise ValueError(f"omega must be >= 1, got {self.omega}")

    @property
    def n_words(self) -> int:
        """Packed-mask word count: ceil(capacity / 32)."""
        return mask_words(self.capacity)

    @property
    def n_slots(self) -> int:
        """Replacement-table slot count (= capacity)."""
        return self.capacity


@dataclasses.dataclass
class FleetState:
    """The device operands of one fleet.

    packed    (W,) removed-slot bit-words (bit b = slot b removed): uint32
              on the host, int32 holding the same bits on a device
    table     (C,) int32 replacement-table ``slots`` permutation
    state     (2,) ``[n_total, n_alive]``: uint32 on the host, int32 on a
              device
    capacity  the slot-space bound the arrays were packed for
    """

    packed: Any
    table: Any
    state: Any
    capacity: int

    @classmethod
    def pack(cls, domain, capacity: int) -> "FleetState":
        """Host-side pack of a ``FailureDomain`` (table resolution) truth."""
        return cls(
            packed=pack_removed_mask(domain.removed, capacity),
            table=pack_table(domain.replacement_table, capacity),
            state=np.array([domain.total_count, domain.alive_count], dtype=np.uint32),
            capacity=capacity,
        )

    # -- incremental event-time hooks (host mirror only) --------------------
    def set_removed(self, replica: int, removed: bool) -> None:
        """Flip one mask bit — the fail/recover incremental update."""
        word, bit = replica >> 5, np.uint32(1) << np.uint32(replica & 31)
        if removed:
            self.packed[word] |= bit
        else:
            self.packed[word] &= ~bit

    def update(self, domain) -> None:
        """Re-pack table + state from the domain (the permutation swapped
        O(1) entries; the counters may have moved).  Mask bits are flipped
        by ``set_removed``; scale-down GC goes through ``resync``."""
        self.table = pack_table(domain.replacement_table, self.capacity)
        self.state = np.array([domain.total_count, domain.alive_count], dtype=np.uint32)

    def resync(self, domain) -> None:
        """Wholesale rebuild (scale-down may garbage-collect tombstones off
        the end of the slot space, clearing mask bits non-incrementally)."""
        self.packed = pack_removed_mask(domain.removed, self.capacity)
        self.update(domain)

    def to(self, device) -> "FleetState":
        """The device twin, in ONE host-to-device copy (``to_device``): the
        three host arrays are laid end to end in one int32 buffer and the
        twin's leaves are views of its copy.  Done at fleet-event time,
        never per batch."""
        return to_device(device, self)

    def leaves(self) -> tuple:
        return self.packed, self.table, self.state

    def with_leaves(self, leaves) -> "FleetState":
        return FleetState(*leaves, self.capacity)


@dataclasses.dataclass
class ChainFleet:
    """The device operands of the chain-mode path (``resolve="chain"``).

    packed    (W,) removed-slot bit-words, as ``FleetState.packed``
    state     (2,) ``[n_total, first_alive]``: uint32 on the host, int32 on
              a device; the lookup reads ``state[:1]`` as its n and the
              chain remap both, so a fleet event is one upload and a batch
              needs no host copy of either
    capacity  the slot-space bound the mask was packed for
    max_chain the domain's rejection bound, so the remap walks no further
              and no less than ``FailureDomain.locate`` does
    """

    packed: Any
    state: Any
    capacity: int
    max_chain: int

    @classmethod
    def pack(cls, domain, capacity: int) -> "ChainFleet":
        """Host-side pack of a ``FailureDomain``'s removed set and scalars.
        Only a ``resolve="chain", chain_bits=32`` domain walks the chain the
        kernel walks; any other is refused."""
        if domain.resolve != "chain" or domain.chain_bits != 32:
            raise ValueError("ChainFleet packs a resolve='chain', chain_bits=32 domain, got "
                             f"resolve={domain.resolve!r}, chain_bits={domain.chain_bits}")
        return cls(pack_removed_mask(domain.removed, capacity), chain_state(domain), capacity,
                   domain.max_chain)

    def to(self, device) -> "ChainFleet":
        """The device twin, in one host-to-device copy."""
        parts = [np.asarray(a).reshape(-1).view(np.int32) for a in (self.packed, self.state)]
        flat = torch.from_numpy(np.concatenate(parts)).to(device)
        packed, state = torch.split(flat, [p.size for p in parts])
        return ChainFleet(packed, state, self.capacity, self.max_chain)


def to_device(device, fleet):
    """The device twin of a fleet (with ``leaves()`` and ``with_leaves``),
    in ONE host-to-device copy: its host arrays laid end to end in one
    int32 buffer, the twin's leaves views of its copy, in their host
    shapes."""
    arrays = [np.asarray(a) for a in fleet.leaves()]
    parts = [a.reshape(-1).view(np.int32) for a in arrays]
    flat = torch.from_numpy(np.concatenate(parts)).to(device)
    return fleet.with_leaves(
        [v.view(a.shape) for v, a in zip(torch.split(flat, [p.size for p in parts]), arrays)])


@dataclasses.dataclass(frozen=True)
class FailureDomains:
    """The map from DataNode to rack of a placement over failure domains.

    racks           racks in the cluster
    nodes_per_rack  DataNodes a rack: DataNode ``d`` lies in rack ``d //
                    nodes_per_rack``, so a global id is ``rack x
                    nodes_per_rack + local``

    A rack is alive while at least one of its DataNodes is.  The layout is
    fixed: DataNodes fail and recover, racks are never added or removed, so
    every rack's slot space stays ``nodes_per_rack``, and each level's
    device table is the next power of two of its slots (``rack_capacity``,
    ``node_capacity``).  Hashable; validated at construction.
    """

    racks: int
    nodes_per_rack: int

    def __post_init__(self):
        for name, count in (("racks", self.racks), ("nodes_per_rack", self.nodes_per_rack)):
            if count < 1:
                raise ValueError(f"{name} must be >= 1, got {count}")

    @property
    def rack_capacity(self) -> int:
        return next_pow2(self.racks)

    @property
    def node_capacity(self) -> int:
        return next_pow2(self.nodes_per_rack)

    @property
    def n_nodes(self) -> int:
        return self.racks * self.nodes_per_rack

    def split(self, node: int) -> tuple[int, int]:
        """DataNode id -> ``(rack, local id in the rack)``."""
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"DataNode {node} is outside the layout's {self.n_nodes}")
        return divmod(node, self.nodes_per_rack)


class TableLevel:
    """One level's fleet under the table divert: a slot space of fixed size,
    its removed slots and its ``ReplacementTable`` (what ``FleetState.pack``
    reads).  Every slot fails and recovers as a failure, the last one
    included: nothing here shrinks the slot space."""

    def __init__(self, n: int):
        self.replacement_table = ReplacementTable(n)
        self.removed: set[int] = set()

    @property
    def total_count(self) -> int:
        return self.replacement_table.n_total

    @property
    def alive_count(self) -> int:
        return self.replacement_table.n_alive

    def fail(self, b: int) -> None:
        self.replacement_table.fail(b)
        self.removed.add(b)

    def recover(self, b: int) -> None:
        self.replacement_table.recover(b)
        self.removed.discard(b)


@dataclasses.dataclass
class RackFleet:
    """The device operands of a fleet over failure domains.

    racks   the rack level's ``FleetState``
    packed  (R, W) the racks' node fleets: removed-slot words, a row a rack
    table   (R, C) their replacement-table ``slots`` permutations
    state   (R, 2) their ``[n_total, n_alive]``
    nodes   every rack's slot space (the layout's ``nodes_per_rack``)

    Host arrays as ``FleetState``'s (uint32 words and states, int32 tables);
    ``to`` (or ``to_device``) makes the device twin in one copy.
    """

    racks: FleetState
    packed: Any
    table: Any
    state: Any
    nodes: int

    def leaves(self) -> tuple:
        return (*self.racks.leaves(), self.packed, self.table, self.state)

    def with_leaves(self, leaves) -> "RackFleet":
        return RackFleet(self.racks.with_leaves(leaves[:3]), *leaves[3:], self.nodes)

    def to(self, device) -> "RackFleet":
        return to_device(device, self)

    def copy(self) -> "RackFleet":
        """A host snapshot (the arrays copied)."""
        return self.with_leaves([np.array(a) for a in self.leaves()])


class RackDomains:
    """The control plane of a fleet over ``FailureDomains``: the rack level
    (a rack alive while one of its DataNodes is) and one node level a rack,
    each a ``TableLevel``, and their packed host mirror ``host``.

    A DataNode event updates its rack's node level; a rack that loses its
    last alive DataNode fails at the rack level, and one that gets one back
    recovers there, in the order the events come.  ``removed``,
    ``total_count`` and ``alive_count`` are the DataNodes', by global id,
    as a flat fleet's domain gives them."""

    def __init__(self, domains: FailureDomains):
        self.domains = domains
        self.rack_level = TableLevel(domains.racks)
        self.node_levels = [TableLevel(domains.nodes_per_rack) for _ in range(domains.racks)]
        self.removed: set[int] = set()
        cap = domains.node_capacity
        self.host = RackFleet(
            FleetState.pack(self.rack_level, domains.rack_capacity),
            np.zeros((domains.racks, mask_words(cap)), np.uint32),
            np.zeros((domains.racks, cap), np.int32),
            np.zeros((domains.racks, 2), np.uint32), domains.nodes_per_rack)
        for rack in range(domains.racks):
            self._pack_rack(rack)

    @property
    def alive_racks(self) -> int:
        return self.rack_level.alive_count

    @property
    def total_count(self) -> int:
        return self.domains.n_nodes

    @property
    def alive_count(self) -> int:
        return self.domains.n_nodes - len(self.removed)

    def _pack_rack(self, rack: int) -> None:
        level, cap = self.node_levels[rack], self.domains.node_capacity
        self.host.packed[rack] = pack_removed_mask(level.removed, cap)
        self.host.table[rack] = pack_table(level.replacement_table, cap)
        self.host.state[rack] = (level.total_count, level.alive_count)

    def fail(self, node: int) -> None:
        rack, local = self.domains.split(node)
        level = self.node_levels[rack]
        level.fail(local)
        self.removed.add(node)
        self._pack_rack(rack)
        if level.alive_count == 0:
            self.rack_level.fail(rack)
            self.host.racks = FleetState.pack(self.rack_level, self.domains.rack_capacity)

    def recover(self, node: int) -> None:
        rack, local = self.domains.split(node)
        level = self.node_levels[rack]
        level.recover(local)
        self.removed.discard(node)
        self._pack_rack(rack)
        if level.alive_count == 1:
            self.rack_level.recover(rack)
            self.host.racks = FleetState.pack(self.rack_level, self.domains.rack_capacity)


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Frozen configuration of one R-way replicated placement tier.

    router      the ``RouterSpec`` of the underlying bulk engine — every
                replica column routes through the same fused datapath
    r           replication factor: each key is placed on ``r`` distinct
                alive shards (degrading to ``n_alive`` distinct copies when
                the fleet is smaller than ``r``)
    max_resalt  bound on the deterministic collision-resolution probes per
                replica column; ``None`` (the default) resolves to ``r``,
                which guarantees distinctness whenever ``n_alive > column``
                (column ``j`` probes ``j+1 <= r`` alive-prefix positions, at
                most ``j`` of which are taken).  Smaller explicit bounds are
                allowed for experiments — exhaustion then surfaces as a
                typed ``PlacementExhaustedError``, never a silent duplicate.
    domains     ``FailureDomains``, or None: with them the ``r`` columns are
                distinct racks, placed over the rack fleet as above, and
                each column's DataNode is routed inside its rack
                (``repro_torch.core.placement_torch.route_nodes_impl``)

    Hashable; validated at construction.
    """

    router: RouterSpec = dataclasses.field(default_factory=RouterSpec)
    r: int = 3
    max_resalt: int | None = None
    domains: FailureDomains | None = None

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"replication factor r must be >= 1, got {self.r}")
        if self.r > self.router.capacity:
            raise ValueError(
                f"replication factor r ({self.r}) exceeds the fleet capacity "
                f"({self.router.capacity}); r distinct shards cannot exist"
            )
        if self.domains is not None and self.r > self.domains.rack_capacity:
            raise ValueError(
                f"replication factor r ({self.r}) exceeds the rack capacity "
                f"({self.domains.rack_capacity}); r distinct racks cannot exist"
            )
        if self.max_resalt is not None and self.max_resalt < 0:
            raise ValueError(
                f"max_resalt must be >= 0, got {self.max_resalt}; pass None "
                "for the distinctness-guaranteeing default"
            )

    @property
    def resolved_max_resalt(self) -> int:
        """Concrete probe bound: column ``j`` needs ``j+1`` probes in the
        worst case (``j`` earlier replicas occupy ``j`` alive-prefix
        positions), so ``r`` probes make distinctness deterministic for
        every column whenever ``n_alive > j``."""
        return self.r if self.max_resalt is None else self.max_resalt


@dataclasses.dataclass(frozen=True)
class BulkEngine:
    """One device routing engine (DESIGN.md §10).

    scalar_engine  ``ENGINES`` name of the bit-exact scalar oracle (a u32
                   flavour) the serving control plane embeds
    kernels        the engine's ``RoutingKernels``: route, ingest and
                   lookup_dyn wrappers with their plain versions
    """

    name: str
    scalar_engine: str
    kernels: Any
