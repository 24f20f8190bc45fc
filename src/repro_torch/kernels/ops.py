"""Entry points for bulk consistent-hash routing over a ``RouterSpec``.

Each function resolves the spec's engine from
``repro_torch.core.registry.BULK_ENGINES`` per call and hands the operands
to that engine's kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs the plain torch version for CPU tensors:

* ``route_bulk(keys, fleet, spec)``          — fused lookup + divert;
* ``route_load_bulk(keys, fleet, counts, spec)`` — the same route plus the
  load monitor's per-shard count, in one launch;
* ``route_ingest_bulk(lo, hi, fleet, spec)`` — fused u64-id ingest;
* ``lookup_bulk_dyn(keys, n, spec)``         — bare lookup, n on the device;
* ``route_chain_bulk(keys, chain, spec)``    — the chain-mode two-pass path:
  the dynamic-n lookup, then the rejection-chain remap (two launches);
* ``route_replicas_bulk(keys, fleet, pspec)`` — R-way placement: the family
  route and the distinct-resolution pass (one launch up to r = 8, two
  past it);
* ``placement_diff_bulk(keys, old, new, pspec)`` — both placements and the
  moved mask (two launches up to r = 8, four past it);
* ``route_racks_bulk(keys, racks, pspec)`` — R-way placement over failure
  domains: r distinct racks over the rack fleet, then each column's
  DataNode inside its rack (the node level, one launch more);
* ``racks_diff_bulk(keys, old, new, pspec)`` — both such placements and the
  moved mask;
* ``make_sharded_route(mesh, spec)`` — the mesh-sharded route: each rank
  routes its shard of the batch in one launch.

And the binomial static-n helpers, kernel on CUDA tensors and plain version
on CPU tensors:

* ``binomial_bulk_lookup(keys, n)``     — n a Python int (the static-n kernel);
* ``binomial_bulk_lookup_dyn(keys, n)`` — n an int or tensor (the dynamic-n
  kernel).

Keys given as a tensor stay on its device; array-likes go to ``device``,
CUDA unless the caller names another.
"""
from __future__ import annotations

import torch

from repro_torch.core.binomial_torch import u32
from repro_torch.core.bulk import ChainFleet, FleetState, PlacementSpec, RackFleet, RouterSpec
from repro_torch.device import resolve_device


def _kernels(spec: RouterSpec):
    from repro_torch.core.registry import make_bulk  # late: registry imports kernels

    return make_bulk(spec.engine).kernels


def route_bulk(keys: torch.Tensor, fleet: FleetState, spec: RouterSpec, out=None) -> torch.Tensor:
    """Fused routing: keys + device fleet state -> int32 replica ids, one
    kernel launch (DESIGN.md §7, §10); written into ``out`` when given
    (``out`` may be ``keys``)."""
    return _kernels(spec).route(keys, fleet.packed, fleet.table, fleet.state, spec.omega, out)


def route_load_bulk(
    keys: torch.Tensor, fleet: FleetState, counts: torch.Tensor, spec: RouterSpec,
    *, sample_shift: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Instrumented routing: route + per-shard load count in ONE launch —
    ``(replicas (N,) int32, counts)``, ``counts`` (``(capacity,)`` int32 of
    u32 bit patterns) advanced in place by the ``[::2**sample_shift]``
    stride sample of the replicas at weight ``2**sample_shift``.  Replica
    ids are bit-exact with ``route_bulk`` at every shift (DESIGN.md §15)."""
    return _kernels(spec).route_load(
        keys, fleet.packed, fleet.table, fleet.state, counts, spec.omega, sample_shift
    )


def route_ingest_bulk(
    ids_lo: torch.Tensor, ids_hi: torch.Tensor, fleet: FleetState, spec: RouterSpec
) -> torch.Tensor:
    """Fused ingest routing: raw u64 session ids (as u32 halves) + fleet
    state -> int32 replica ids, one kernel launch (DESIGN.md §9)."""
    return _kernels(spec).ingest(
        ids_lo, ids_hi, fleet.packed, fleet.table, fleet.state, spec.omega
    )


def lookup_bulk_dyn(keys: torch.Tensor, n: torch.Tensor, spec: RouterSpec) -> torch.Tensor:
    """Bare lookup with ``n`` a 1-element device tensor — the two-pass
    baseline's first dispatch."""
    return _kernels(spec).lookup_dyn(keys, n, spec.omega)


def route_chain_bulk(keys: torch.Tensor, chain: ChainFleet, spec: RouterSpec) -> torch.Tensor:
    """Chain-mode routing (``resolve="chain"``, ``chain_bits=32``): keys +
    the chain operands -> int32 replica ids, bit-exact with the scalar
    ``FailureDomain.locate`` of the domain ``chain`` was packed from (its
    ``max_chain`` travels in ``chain``).  Two launches: ``lookup_dyn`` over
    ``n_total = chain.state[0]`` writes the base buckets, then
    ``chain_remap`` walks the removed ones (the JAX package's two-pass
    chain baseline).  Each warp of the remap queues its removed keys and
    walks them with lane refill, so its cost follows the total of the
    walks, not the longest walk of each 32 keys.  ``n_alive >= 1`` is the
    caller's precondition."""
    k = _kernels(spec)
    buckets = k.lookup_dyn(keys, chain.state[:1], spec.omega)
    return k.chain_remap(keys, buckets, chain.packed, chain.state, chain.max_chain)


def route_replicas_bulk(keys: torch.Tensor, fleet: FleetState, pspec: PlacementSpec) -> tuple:
    """R-way replicated placement: keys (N,) + fleet state -> ``(replicas
    (N, r) int32 distinct alive shards, exhausted (N,) bool)``
    (``repro_torch.placement.store.route_replicas_impl`` says what they
    hold).  On CUDA tensors one ``place`` launch, the family route and the
    resolution with the columns on chip (r > 8: a family-route launch and a
    resolve launch); on CPU tensors their plain versions.  ``n_alive >= 1``
    is the caller's precondition, as for ``route_bulk``."""
    spec = pspec.router
    replicas, exhausted, _ = _kernels(spec).place(
        keys.reshape(-1), pspec.r, fleet.packed, fleet.table, fleet.state, spec.omega,
        pspec.resolved_max_resalt)
    return replicas, exhausted


def placement_diff_bulk(
    keys: torch.Tensor, fleet_old: FleetState, fleet_new: FleetState, pspec: PlacementSpec
) -> tuple:
    """Bulk migration diff: ``(old (N, r), new (N, r), moved (N, r) bool,
    exhausted_new (N,))`` with ``moved[i, j] = new[i, j] not in old[i, :]``
    (membership, not positional inequality: a column swap is free, only a
    shard with no prior copy needs bytes).  On CUDA: two ``place`` launches,
    the second computing ``moved`` (r > 8: two family-route launches and two
    resolve launches)."""
    old, _ = route_replicas_bulk(keys, fleet_old, pspec)
    f = fleet_new
    new, exhausted, moved = _kernels(pspec.router).place(
        keys.reshape(-1), pspec.r, f.packed, f.table, f.state, pspec.router.omega,
        pspec.resolved_max_resalt, old)
    return old, new, moved, exhausted


def route_racks_bulk(keys: torch.Tensor, racks: RackFleet, pspec: PlacementSpec) -> tuple:
    """R-way placement over failure domains (``pspec.domains``): keys (N,) +
    the device ``RackFleet`` -> ``(DataNodes (N, r) int32, exhausted (N,)
    bool)``.  The racks are the store's R-way placement over the rack fleet
    (``route_replicas_bulk``'s: one launch up to r = 8, the family route and
    ``resolve``'s row path past it); then ``node_route`` routes each
    column's node key inside its rack, one launch.  At least one alive rack
    is the caller's precondition."""
    nodes, exhausted, _ = _route_racks(keys, racks, pspec)
    return nodes, exhausted


def racks_diff_bulk(keys: torch.Tensor, racks_old: RackFleet, racks_new: RackFleet,
                    pspec: PlacementSpec) -> tuple:
    """The migration diff over failure domains: ``(old (N, r), new (N, r),
    moved (N, r) bool, exhausted_new (N,))``, ``moved[i, j] = new[i, j] not
    in old[i, :]``: ``route_racks_bulk`` under both fleets, the second node
    route computing ``moved`` in its launch."""
    old, _ = route_racks_bulk(keys, racks_old, pspec)
    new, exhausted, moved = _route_racks(keys, racks_new, pspec, old)
    return old, new, moved, exhausted


def _route_racks(keys, racks: RackFleet, pspec: PlacementSpec, old=None) -> tuple:
    spec = pspec.router
    k = _kernels(spec)
    f = racks.racks
    cols, exhausted, _ = k.place(keys.reshape(-1), pspec.r, f.packed, f.table, f.state, spec.omega,
                                 pspec.resolved_max_resalt)
    nodes, moved = k.node_route(keys.reshape(-1), cols, racks.packed, racks.table, racks.state,
                                racks.nodes, spec.omega, old)
    return nodes, exhausted, moved


# ---------------------------------------------------------------------------
# static-n helpers (binomial)
# ---------------------------------------------------------------------------


def _key_bits(keys, device) -> torch.Tensor:
    """Any int keys -> contiguous int32 tensor of their low 32 bits."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.as_tensor(keys).to(resolve_device(device))
    if keys.dtype != torch.int32:
        keys = u32(keys).to(torch.int32)  # low 32 bits, then their int32 pattern
    return keys.contiguous()


_BINOMIAL = RouterSpec(engine="binomial")


def binomial_bulk_lookup(keys, n: int, omega: int = 16, *, device=None) -> torch.Tensor:
    """keys (any int shape) -> int32 buckets in [0, n), n a Python int: the
    static-n kernel."""
    return _kernels(_BINOMIAL).lookup_vec(_key_bits(keys, device), n, omega)


def binomial_bulk_lookup_dyn(keys, n, omega: int = 16, *, device=None) -> torch.Tensor:
    """keys (any int shape) -> int32 buckets in [0, n), n an int or a
    1-element tensor: the dynamic-n kernel, so a resize rebuilds nothing."""
    keys = _key_bits(keys, device)
    n = u32(n).reshape(1).to(device=keys.device, dtype=torch.int32)
    return _kernels(_BINOMIAL).lookup_dyn(keys, n, omega)


# ---------------------------------------------------------------------------
# mesh-sharded datapath
# ---------------------------------------------------------------------------


def shard_bounds(total: int, n_shards: int, index: int) -> tuple[int, int, int]:
    """-> ``(lo, hi, rows)``: shard ``index`` of ``n_shards`` holds keys
    ``[lo, hi)`` of a batch of ``total``, in a block of ``rows =
    ceil(total / n_shards)`` (the last blocks padded).  These are
    DTensor's ``Shard`` blocks, and a batch padded to a multiple of the
    shard count and split evenly."""
    rows = -(-total // n_shards)
    lo = min(index * rows, total)
    return lo, min(lo + rows, total), rows


def make_sharded_route(mesh, spec: RouterSpec):
    """The mesh-sharded bulk route (DESIGN.md §8): ``route(keys, fleet)``.

    ``keys`` is the whole 1-D batch, the same on every rank, whose length
    is a multiple of the size of the mesh axis ``spec.shard_axis`` (the
    caller pads); ``fleet`` is the device
    ``FleetState``, which every rank holds whole.  Each rank routes its
    contiguous shard of the keys in one launch of the fused route kernel
    (``route_bulk``): no collective, no host synchronisation.  The result
    is a DTensor ``Shard(0)`` over ``spec.shard_axis`` (replicated over the
    other axes) whose ``full_tensor()`` is the single-device result.

    With ``spec.donate_keys`` the replica ids are written into the key
    buffer (its rank's shard): the caller must not reuse it.

    ``route.block(local, fleet, donate=spec.donate_keys)`` is the launch
    alone: a rank's block of keys -> its block of ids, a plain tensor.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import P, placements

    names = tuple(mesh.mesh_dim_names)
    if spec.shard_axis not in names:
        raise ValueError(f"shard axis {spec.shard_axis!r} is not an axis of the mesh {names}")
    n_shards = mesh.size(names.index(spec.shard_axis))
    index = mesh.get_local_rank(spec.shard_axis)
    place = placements(P(spec.shard_axis), mesh)

    def block(local: torch.Tensor, fleet: FleetState, donate: bool = spec.donate_keys):
        return route_bulk(local, fleet, spec, out=local if donate else None)

    def route(keys, fleet: FleetState):
        total = keys.shape[0]
        if total % n_shards:
            raise ValueError(f"{total} keys do not split {n_shards} ways; pad the batch to a multiple")
        lo, hi, _ = shard_bounds(total, n_shards, index)
        return DTensor.from_local(block(keys[lo:hi], fleet), mesh, place, run_check=False,
                                  shape=(total,), stride=(1,))

    route.block = block
    return route
