"""Batched, recompile-free, storm-proof session routing — the serving-tier
datapath on a CUDA device, generic over the bulk engines (DESIGN.md §10).

``BatchRouter`` embeds a u32 ``SessionRouter`` as its control plane —
scalar lookups, stats and fleet-event bookkeeping all live there — and
routes whole key batches on the device in ONE kernel launch:

    keys[N] --route_bulk--> replicas[N]   (fused lookup + divert)

``engine="binomial"`` (the default) or ``engine="jump"`` picks the
``BULK_ENGINES`` entry, which pairs the kernels with the scalar oracle the
control plane runs, so device == scalar holds per engine (tests enforce).
The fleet state lives on the device as one ``FleetState`` (``[n_total,
n_alive]``, the packed removed-slot mask, the replacement table's
``slots`` permutation), read by the kernels from device memory: a fleet
event updates the host mirror (one bit flip and an O(1) permutation swap)
and copies the few-KiB state to the device once; ``route_keys`` itself
copies no state, never synchronises and returns a device tensor.  Removed
buckets resolve through at most two table redirects, so an event storm
costs the same per batch as a healthy fleet.

The pre-fusion two-stage pipeline (``lookup_bulk_dyn`` then
``memento_remap_table``, with ``buckets[N]`` in memory between them) is
kept behind ``fused=False`` as the benchmark baseline.

``device=None`` means CUDA; with no CUDA device the constructor raises.
``device="cpu"`` runs every kernel's plain torch version instead (tests).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.bulk import FleetState, RouterSpec
from repro_torch.core.memento_torch import memento_remap_table
from repro_torch.core.registry import make_bulk
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serving.lifecycle.errors import FleetUnavailableError
from repro_torch.serving.router import SessionRouter, hash_session_ids


class BatchRouter:
    """Route request batches through the fused single-launch kernel of a
    bulk engine."""

    def __init__(
        self,
        n_replicas: int,
        *,
        engine: str = "binomial",
        capacity: int | None = None,
        omega: int = 16,
        device=None,
        fused: bool = True,
    ):
        """``capacity=None`` sizes the device table at
        ``max(64, next_pow2(2 * n_replicas))``."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if capacity is None:
            capacity = max(64, bits.next_pow2(2 * n_replicas))
        spec = RouterSpec(engine=engine, capacity=capacity, omega=omega)
        if n_replicas > spec.capacity:
            raise ValueError(f"n_replicas ({n_replicas}) exceeds capacity ({spec.capacity})")
        self.device = resolve_device(device)
        self.spec = spec
        bulk = make_bulk(spec.engine)  # fails loudly on unknown engines
        # control-plane truth: the engine's u32 scalar oracle with table
        # resolution (the device semantics); an all-failed fleet is a state
        # the route entry points answer with FleetUnavailableError
        self.scalar = SessionRouter(n_replicas, engine=bulk.scalar_engine, omega=spec.omega)
        self.fused = fused
        # host mirror of the device fleet state, mutated incrementally on
        # fleet events; the device twin is refreshed only then
        self._fleet_host = FleetState.pack(self.domain, spec.capacity)
        self._fleet_dev: FleetState | None = None
        #: routing epoch: one tick per fleet event
        self._epoch = 0
        # event-storm coalescing state (see ``coalesced_events``)
        self._coalescing = False
        self._state_dirty = False
        self._put_state()

    # -- spec facade ----------------------------------------------------------
    @property
    def engine(self) -> str:
        return self.spec.engine

    @property
    def capacity(self) -> int:
        return self.spec.capacity

    @property
    def n_words(self) -> int:
        return self.spec.n_words

    @property
    def omega(self) -> int:
        return self.spec.omega

    @property
    def domain(self):
        return self.scalar.domain

    @property
    def stats(self):
        return self.scalar.stats

    # -- device-side fleet state -------------------------------------------
    def _resync_device_state(self) -> None:
        """Rebuild the device operands from control-plane truth (after
        scale-down, which may garbage-collect tombstones off the end)."""
        self._fleet_host.resync(self.domain)
        self._upload_state()

    def _put_state(self) -> None:
        """Re-pack the mirror's table + state and re-pin the device twin."""
        self._fleet_host.update(self.domain)
        self._upload_state()

    def _upload_state(self) -> None:
        """One host-to-device copy of the whole fleet state — event-time
        only, never per batch; deferred inside ``coalesced_events``."""
        if self._coalescing:
            self._state_dirty = True
            return
        self._fleet_dev = self._fleet_host.to(self.device)

    def _set_removed_bit(self, replica: int, removed: bool) -> None:
        """Incremental fleet-event update: flip one mask bit, re-pin."""
        self._fleet_host.set_removed(replica, removed)
        self._put_state()  # the permutation swapped O(1) entries

    # -- event-storm coalescing ---------------------------------------------
    @contextlib.contextmanager
    def coalesced_events(self):
        """Defer the device-state refresh across a burst of fleet events.

        Every event inside still mutates the host control plane at once
        (the scalar oracle and ``routing_epoch`` stay exact per event); on
        exit the final state lands in ONE wholesale resync + copy —
        bit-exact with per-event application, because the device operands
        are a pure function of the final control-plane state.  Re-entrant:
        the outermost context owns the flush.  The route entry points flush
        defensively, so a launch never reads a stale device twin.
        """
        if self._coalescing:
            yield
            return
        self._coalescing = True
        try:
            yield
        finally:
            self._coalescing = False
            if self._state_dirty:
                self._flush_events()

    def _flush_events(self) -> None:
        self._state_dirty = False
        self._fleet_host.resync(self.domain)
        self._upload_state()

    # -- routing ------------------------------------------------------------
    session_key = staticmethod(SessionRouter.session_key)

    def _check_routable(self) -> None:
        """Route-entry guard: typed error on an all-failed fleet, and land
        any coalesced events the launch would otherwise miss."""
        if self.scalar.alive == 0:
            raise FleetUnavailableError(epoch=self._epoch)
        if self._state_dirty and not self._coalescing:
            self._flush_events()

    def _coerce_keys(self, keys) -> torch.Tensor:
        """Any int keys -> contiguous int32 tensor of their low 32 bits on
        the router's device (the scalar oracle truncates alike).  A tensor
        already on the device stays there: no host round trip."""
        if isinstance(keys, torch.Tensor):
            if keys.dtype == torch.uint32:
                keys = keys.view(torch.int32)
            elif keys.dtype != torch.int32:
                keys = keys.to(torch.int64).to(torch.int32)  # wraps mod 2^32
            return keys.to(self.device).contiguous()
        if not (isinstance(keys, np.ndarray) and keys.dtype == np.uint32):
            keys = np.ascontiguousarray(keys, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)).to(self.device)

    def _dispatch(self, keys: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return ops.route_bulk(keys, self._fleet_dev, self.spec)
        # pre-fusion two-pass pipeline (benchmark baseline): buckets[N]
        # round-trips through memory between two launches; n is the state's
        # first element, already on the device
        fleet = self._fleet_dev
        buckets = ops.lookup_bulk_dyn(keys, fleet.state[:1], self.spec)
        return memento_remap_table(keys, buckets, fleet.packed, fleet.table, fleet.state)

    def route_keys(self, keys) -> torch.Tensor:
        """Pre-hashed keys (any int tensor or array) -> int32 replica ids, on
        the device: one kernel launch, no synchronisation.  Keys are
        truncated to u32 like the engine's scalar u32 oracle does."""
        self._check_routable()
        keys = self._coerce_keys(keys)
        if keys.numel() == 0:
            return torch.zeros(keys.shape, dtype=torch.int32, device=self.device)
        out = self._dispatch(keys)
        self.stats.lookups += keys.numel()
        return out

    def route_keys_np(self, keys) -> np.ndarray:
        """Numpy-out convenience wrapper around ``route_keys``."""
        return self.route_keys(keys).cpu().numpy()

    def route_ids(self, session_ids) -> torch.Tensor:
        """Raw u64 int session ids -> int32 replica ids, ONE fused launch:
        the splitmix64 session hash, the lookup and the divert all run in
        the ingest kernel, so no ``keys[N]`` array exists (DESIGN.md §9).
        Bit-exact with ``route_keys(hash_session_ids(ids))``."""
        self._check_routable()
        ids = np.ascontiguousarray(session_ids, dtype=np.uint64)
        if ids.size == 0:
            return torch.zeros(ids.shape, dtype=torch.int32, device=self.device)
        lo, hi = bits.np_split64(ids)
        out = ops.route_ingest_bulk(
            torch.from_numpy(lo.view(np.int32)).to(self.device),
            torch.from_numpy(hi.view(np.int32)).to(self.device),
            self._fleet_dev, self.spec,
        )
        self.stats.lookups += int(ids.size)
        return out

    def route_batch(self, session_ids) -> np.ndarray:
        """Session ids (str/int) -> int32 replica ids, one device round trip:
        vectorised ``hash_session_ids`` on the host, one fused launch, and
        movement bookkeeping in the bulk ``SessionStore`` (DESIGN.md §9)."""
        keys = hash_session_ids(session_ids)
        if keys.size == 0:
            return np.empty(keys.shape, dtype=np.int32)
        out = self.route_keys_np(keys)
        self.scalar.note_routes(keys, out)
        return out

    def route(self, session_id) -> int:
        """Scalar lookup through the control plane (bit-exact with the batch)."""
        return self.scalar.route(session_id)

    # -- fleet events --------------------------------------------------------
    # Each event mutates the scalar control plane, then refreshes the device
    # state: fail/recover flip one bit + re-pin the table; scale-up re-pins
    # table + counters; scale-down resyncs (tombstone GC can clear bits).
    def scale_up(self) -> int:
        if self.domain.total_count >= self.spec.capacity:
            raise ValueError(
                f"fleet at device-table capacity ({self.spec.capacity}); "
                "construct BatchRouter with a larger capacity"
            )
        r = self.scalar.scale_up()
        self._epoch += 1
        self._put_state()
        return r

    def scale_down(self) -> int:
        r = self.scalar.scale_down()
        self._epoch += 1
        self._resync_device_state()
        return r

    def fail(self, replica: int) -> None:
        self.scalar.fail(replica)
        self._epoch += 1
        if replica in self.domain.removed:
            self._set_removed_bit(replica, True)
        else:
            # failing the LAST slot is a true LIFO removal in the control
            # plane (slot space shrinks, tombstones may GC) — resync wholesale
            self._resync_device_state()

    def recover(self, replica: int) -> None:
        self.scalar.recover(replica)
        self._epoch += 1
        self._set_removed_bit(replica, False)

    @property
    def alive(self) -> int:
        return self.scalar.alive

    @property
    def routing_epoch(self) -> int:
        """Fleet-event counter: the epoch the next launch routes under."""
        return self._epoch
