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
  placement tier over a ``RouterSpec`` (DESIGN.md §13).
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
        """The device twin, in ONE host-to-device copy: the three host arrays
        are laid end to end in one int32 buffer and the twin's leaves are
        views of its copy.  Done at fleet-event time, never per batch."""
        parts = [np.asarray(a).reshape(-1).view(np.int32) for a in (self.packed, self.table, self.state)]
        flat = torch.from_numpy(np.concatenate(parts)).to(device)
        packed, table, state = torch.split(flat, [p.size for p in parts])
        return FleetState(packed, table, state, self.capacity)


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

    Hashable; validated at construction.
    """

    router: RouterSpec = dataclasses.field(default_factory=RouterSpec)
    r: int = 3
    max_resalt: int | None = None

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"replication factor r must be >= 1, got {self.r}")
        if self.r > self.router.capacity:
            raise ValueError(
                f"replication factor r ({self.r}) exceeds the fleet capacity "
                f"({self.router.capacity}); r distinct shards cannot exist"
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
