"""BinomialHash routing datapath in PyTorch with hand-written CUDA kernels.

The counterpart of the JAX package ``repro``: same module names where they
help, plain functions on tensors, an explicit ``device``.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``, where the
kernels' plain torch versions run instead.  The kernels are compiled with
``nvcc`` at first use (``repro_torch.kernels.build``), never at import.

Main path: ``repro_torch.serving.batch_router.BatchRouter``.

The public surface (``__all__``) is the JAX package's, each name from the
port's counterpart of the module ``repro`` takes it from:

* ``BatchRouter`` / ``ServingTier`` — the batched serving datapath and the
  replicated tier built on it;
* ``RouterSpec`` / ``FleetState`` / ``BulkEngine`` — the engine-agnostic
  bulk-routing protocol;
* ``route_bulk`` / ``route_ingest_bulk`` / ``lookup_bulk_dyn`` /
  ``make_sharded_route`` — the bulk routing entry points (one kernel
  launch each on the card);
* ``make`` / ``make_bulk`` + the ``ENGINES`` / ``BULK_ENGINES`` registries —
  the scalar comparison suite and the pluggable device engines;
* ``SessionRouter`` / ``hash_session_ids`` — the scalar control plane and
  the vectorised session-id ingest;
* ``StorePlacement`` / ``PlacementSpec`` / ``PlacementRepairer`` +
  ``route_replicas_bulk`` / ``placement_diff_bulk`` — the R-way replicated
  placement tier;
* ``MetricsRegistry`` / ``LoadMonitor`` / ``LoadConfig`` / ``SpanTrace`` +
  ``route_load_bulk`` and the ``BalanceDriftAlarm`` /
  ``DisruptionBoundAlarm`` types — the observability tier.

Attributes resolve lazily (PEP 562): ``import repro_torch`` imports no
submodule, so it builds no kernel and touches no CUDA.
"""
from __future__ import annotations

import importlib

#: export name -> defining module (resolved on first attribute access);
#: ``__all__`` derives from this, so the two can never drift
_EXPORTS = {
    "BatchRouter": "repro_torch.serving.batch_router",
    "ServingTier": "repro_torch.serving.engine",
    "SessionRouter": "repro_torch.serving.router",
    "hash_session_ids": "repro_torch.serving.router",
    "RouterSpec": "repro_torch.core.bulk",
    "FleetState": "repro_torch.core.bulk",
    "BulkEngine": "repro_torch.core.bulk",
    "ENGINES": "repro_torch.core.registry",
    "BULK_ENGINES": "repro_torch.core.registry",
    "make": "repro_torch.core.registry",
    "make_bulk": "repro_torch.core.registry",
    "route_bulk": "repro_torch.kernels.ops",
    "route_ingest_bulk": "repro_torch.kernels.ops",
    "lookup_bulk_dyn": "repro_torch.kernels.ops",
    "make_sharded_route": "repro_torch.kernels.ops",
    "PlacementSpec": "repro_torch.core.bulk",
    "StorePlacement": "repro_torch.placement.store",
    "PlacementRepairer": "repro_torch.serving.lifecycle",
    "route_replicas_bulk": "repro_torch.kernels.ops",
    "placement_diff_bulk": "repro_torch.kernels.ops",
    "MetricsRegistry": "repro_torch.observability",
    "LoadMonitor": "repro_torch.observability",
    "LoadConfig": "repro_torch.observability",
    "SpanTrace": "repro_torch.observability",
    "BalanceDriftAlarm": "repro_torch.observability",
    "DisruptionBoundAlarm": "repro_torch.observability",
    "route_load_bulk": "repro_torch.kernels.ops",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute '{name}'")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: subsequent accesses skip the import
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
