"""Entry points for bulk consistent-hash routing over a ``RouterSpec``.

Each function resolves the spec's engine from
``repro_torch.core.registry.BULK_ENGINES`` per call and hands the operands
to that engine's kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs the plain torch version for CPU tensors:

* ``route_bulk(keys, fleet, spec)``          — fused lookup + divert;
* ``route_ingest_bulk(lo, hi, fleet, spec)`` — fused u64-id ingest;
* ``lookup_bulk_dyn(keys, n, spec)``         — bare lookup, n on the device.
"""
from __future__ import annotations

import torch

from repro_torch.core.bulk import FleetState, RouterSpec


def _kernels(spec: RouterSpec):
    from repro_torch.core.registry import make_bulk  # late: registry imports kernels

    return make_bulk(spec.engine).kernels


def route_bulk(keys: torch.Tensor, fleet: FleetState, spec: RouterSpec) -> torch.Tensor:
    """Fused routing: keys + device fleet state -> int32 replica ids, one
    kernel launch (DESIGN.md §7, §10)."""
    return _kernels(spec).route(keys, fleet.packed, fleet.table, fleet.state, spec.omega)


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
