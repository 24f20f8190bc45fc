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
* ``route_replicas_bulk(keys, fleet, pspec)`` — R-way placement: the family
  route, then the distinct-resolution pass (two launches);
* ``placement_diff_bulk(keys, old, new, pspec)`` — both placements and the
  moved mask (four launches).

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
from repro_torch.core.bulk import FleetState, PlacementSpec, RouterSpec
from repro_torch.device import resolve_device


def _kernels(spec: RouterSpec):
    from repro_torch.core.registry import make_bulk  # late: registry imports kernels

    return make_bulk(spec.engine).kernels


def route_bulk(keys: torch.Tensor, fleet: FleetState, spec: RouterSpec) -> torch.Tensor:
    """Fused routing: keys + device fleet state -> int32 replica ids, one
    kernel launch (DESIGN.md §7, §10)."""
    return _kernels(spec).route(keys, fleet.packed, fleet.table, fleet.state, spec.omega)


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


def route_replicas_bulk(keys: torch.Tensor, fleet: FleetState, pspec: PlacementSpec) -> tuple:
    """R-way replicated placement: keys (N,) + fleet state -> ``(replicas
    (N, r) int32 distinct alive shards, exhausted (N,) bool)``
    (``repro_torch.placement.store.route_replicas_impl`` says what they
    hold).  On CUDA tensors: one family-route launch (all ``r`` salted
    families) and one resolve launch; on CPU tensors their plain versions.
    ``n_alive >= 1`` is the caller's precondition, as for ``route_bulk``."""
    spec = pspec.router
    k = _kernels(spec)
    keys = keys.reshape(-1)
    base = k.route_family(keys, pspec.r, fleet.packed, fleet.table, fleet.state, spec.omega)
    replicas, exhausted, _ = k.resolve(keys, base, fleet.table, fleet.state,
                                       pspec.resolved_max_resalt)
    return replicas, exhausted


def placement_diff_bulk(
    keys: torch.Tensor, fleet_old: FleetState, fleet_new: FleetState, pspec: PlacementSpec
) -> tuple:
    """Bulk migration diff: ``(old (N, r), new (N, r), moved (N, r) bool,
    exhausted_new (N,))`` with ``moved[i, j] = new[i, j] not in old[i, :]``
    (membership, not positional inequality: a column swap is free, only a
    shard with no prior copy needs bytes).  On CUDA: two family-route
    launches and two resolve launches, the second computing ``moved``."""
    old, _ = route_replicas_bulk(keys, fleet_old, pspec)
    k = _kernels(pspec.router)
    keys = keys.reshape(-1)
    f = fleet_new
    routed = k.route_family(keys, pspec.r, f.packed, f.table, f.state, pspec.router.omega)
    new, exhausted, moved = k.resolve(keys, routed, f.table, f.state, pspec.resolved_max_resalt,
                                      old)
    return old, new, moved, exhausted


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
