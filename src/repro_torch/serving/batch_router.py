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

With a ``LoadMonitor`` attached (``attach_load_monitor``) the fused launch
is the instrumented one (``ops.route_load_bulk``): the same replica ids,
and the monitor's per-shard count advanced in the same launch.

With ``FailureDomains`` attached (``attach_domains``: racks of DataNodes,
which a rack-aware ``StorePlacement`` asks for), the racks' two-level fleet
takes the flat fleet's place: every DataNode event updates its rack's node
fleet, and the rack fleet where a rack loses its last alive DataNode or
gets one back (``RackDomains``); both levels go to the device in one copy.
The flat routes are refused from then on.  ``uploads`` counts the
host-to-device fleet copies made.

With a ``SpanTrace`` as ``tracer``, the single-host datapath records its
stages as nested spans on ``time.perf_counter_ns``: each ``route_keys``
call (guard, coercion, launch; trace id: the count of traced calls), each
burst of ``coalesced_events`` (each event, the flush) and each
``fleet.upload`` (trace id: the routing epoch a burst or upload began at).
``StorePlacement`` records into the same tracer.  With none, a stage pays
one ``is not None`` test: no clock read, no allocation.

Handed a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``), the router
splits every key batch over the spec's ``shard_axis``: every rank passes
the same batch, routes its own block in one launch of the fused kernel
(``ops.make_sharded_route``; the fleet state is whole on every rank, no
collective), and ``route_keys`` returns a DTensor sharded over the axis
(``route_keys_np`` gathers the whole batch's ids on every rank).  Under a
mesh ``fused=False``, ``route_ids`` and ``attach_load_monitor`` are
refused, as in the JAX package; ``donate_keys`` needs a mesh.

``device=None`` means CUDA (under a mesh, the mesh's device type); with no
CUDA device the constructor raises.  ``device="cpu"`` runs every kernel's
plain torch version instead (tests).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.bulk import FailureDomains, FleetState, RackDomains, RouterSpec
from repro_torch.core.memento_torch import memento_remap_table
from repro_torch.core.registry import make_bulk
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.observability.trace import (
    SPAN_BURST,
    SPAN_BURST_EVENT,
    SPAN_BURST_FLUSH,
    SPAN_FLEET_UPLOAD,
    SPAN_ROUTE_COERCE,
    SPAN_ROUTE_GUARD,
    SPAN_ROUTE_KEYS,
    SPAN_ROUTE_LAUNCH,
)
from repro_torch.serving.lifecycle.errors import FleetUnavailableError
from repro_torch.serving.router import SessionRouter, hash_session_ids
from repro_torch.sharding.rules import P, placements


#: "this keyword was not passed": a spec and spec fields given together
#: are a conflict, not a merge
_UNSET = object()


class BatchRouter:
    """Route request batches through the fused single-launch kernel of a
    bulk engine."""

    def __init__(
        self,
        n_replicas: int,
        spec: RouterSpec | None = None,
        *,
        mesh=None,
        device=None,
        fused: bool = True,
        max_chain: int = 4096,
        engine=_UNSET,
        capacity=_UNSET,
        omega=_UNSET,
        shard_axis=_UNSET,
        donate_keys=_UNSET,
        tracer=None,
    ):
        """Configuration is one ``RouterSpec`` (``BatchRouter(16, spec)``)
        or its fields as keywords (``BatchRouter(16, engine="jump")``), not
        both.  ``capacity=None`` sizes the device table at ``max(64,
        next_pow2(2 * n_replicas))``.  ``max_chain`` is inert: the table
        resolution has a hard two-redirect bound; it is validated and
        forwarded to the control plane as the JAX package's router does.
        A ``mesh`` (a ``DeviceMesh``) shards every key batch over the
        spec's ``shard_axis``; the router then runs on the mesh's device
        type.  ``tracer``: a ``SpanTrace`` the datapath's stages are
        recorded into (None: nothing recorded)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        kwargs = {
            name: value
            for name, value in (
                ("engine", engine), ("capacity", capacity), ("omega", omega),
                ("shard_axis", shard_axis), ("donate_keys", donate_keys),
            )
            if value is not _UNSET
        }
        if spec is not None:
            if not isinstance(spec, RouterSpec):
                raise TypeError(
                    f"the second positional argument is the RouterSpec (got "
                    f"{type(spec).__name__}); pass capacity and friends as keywords"
                )
            if kwargs:
                raise ValueError(
                    f"pass either a RouterSpec or individual spec fields, not "
                    f"both (got spec and {sorted(kwargs)})"
                )
        else:
            if kwargs.get("capacity") is None:
                kwargs["capacity"] = max(64, bits.next_pow2(2 * n_replicas))
            spec = RouterSpec(**kwargs)
        if n_replicas > spec.capacity:
            raise ValueError(f"n_replicas ({n_replicas}) exceeds capacity ({spec.capacity})")
        if max_chain < 0:
            raise ValueError(
                f"max_chain must be >= 0, got {max_chain}; note the table "
                "resolution has a hard two-redirect bound, so max_chain only "
                "labels the (unused) chain budget — any value >= 0 routes "
                "identically"
            )
        if mesh is not None and not fused:
            raise ValueError(
                "the two-pass baseline (fused=False) is single-host only; "
                "the mesh-sharded datapath always runs the fused kernel"
            )
        if spec.donate_keys and mesh is None:
            raise ValueError(
                "donate_keys applies to the mesh-sharded datapath only; "
                "pass a mesh or drop donate_keys"
            )
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
            device = mesh.device_type
        self.device = resolve_device(device)
        self.spec = spec
        bulk = make_bulk(spec.engine)  # fails loudly on unknown engines
        # control-plane truth: the engine's u32 scalar oracle with u32 table
        # resolution (the device semantics); an all-failed fleet is a state
        # the route entry points answer with FleetUnavailableError
        self.scalar = SessionRouter(
            n_replicas,
            engine=bulk.scalar_engine,
            chain_bits=32,
            omega=spec.omega,
            max_chain=max_chain,
            resolve="table",
            allow_empty=True,
        )
        self.max_chain = max_chain
        self.fused = fused
        self.mesh = mesh
        #: the mesh-sharded route (its ``block`` launches on a rank's block)
        self._sharded_route = None
        self._n_shards, self._shard_index, self._sharded_place = 1, 0, None
        if mesh is not None:
            self._sharded_route = ops.make_sharded_route(mesh, spec)
            self._n_shards = mesh.size(tuple(mesh.mesh_dim_names).index(spec.shard_axis))
            self._shard_index = mesh.get_local_rank(spec.shard_axis)
            self._sharded_place = placements(P(spec.shard_axis), mesh)
        # host mirror of the device fleet state, mutated incrementally on
        # fleet events; the device twin is refreshed only then (under a
        # mesh every rank holds its own whole twin)
        self._fleet_host = FleetState.pack(self.scalar.domain, spec.capacity)
        self._fleet_dev: FleetState | None = None
        #: the control plane over failure domains and its device twin (None:
        #: no domains attached)
        self.racks: RackDomains | None = None
        self._racks_dev = None
        #: host-to-device fleet copies made (the flat fleet, with the racks'
        #: levels where domains are attached: one copy each)
        self.uploads = 0
        #: routing epoch: one tick per fleet event
        self._epoch = 0
        # event-storm coalescing state (see ``coalesced_events``)
        self._coalescing = False
        self._state_dirty = False
        #: attached LoadMonitor (None = the bare route)
        self._load_monitor = None
        #: SpanTrace of the datapath's stages (None: nothing recorded), and
        #: the count of the calls it traced (their trace ids)
        self.tracer = tracer
        self.traced_calls = 0
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
    def shard_axis(self) -> str:
        return self.spec.shard_axis

    @property
    def donate_keys(self) -> bool:
        return self.spec.donate_keys

    @property
    def domain(self):
        """The membership the events keep: the flat control plane's, or with
        failure domains attached the DataNodes' (``RackDomains``)."""
        return self.scalar.domain if self.racks is None else self.racks

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
        tr = self.tracer
        if tr is not None:
            tr.open(SPAN_FLEET_UPLOAD, self._epoch)
        if self.racks is None:
            self._fleet_dev = self._fleet_host.to(self.device)
        else:
            self._racks_dev = self.racks.host.to(self.device)
        self.uploads += 1
        if tr is not None:
            tr.close()

    # -- failure domains ------------------------------------------------------
    def attach_domains(self, domains: FailureDomains) -> None:
        """Track ``domains`` (racks of this router's replicas, its
        DataNodes) from now on, in the flat fleet's place: a rack fleet and
        a node fleet a rack, through every event, uploaded together.  The
        replicas failed already fail there in ascending order.  Attaching
        the same layout again changes nothing; another is refused.  The
        layout is fixed: scale events are refused from then on, and so are
        the flat routes (the flat fleet is no longer kept)."""
        if self.racks is not None:
            if self.racks.domains != domains:
                raise ValueError(f"the router tracks {self.racks.domains}, not {domains}")
            return
        if domains.n_nodes != self.domain.total_count:
            raise ValueError(f"the layout holds {domains.n_nodes} DataNodes; the router has "
                             f"{self.domain.total_count} replicas")
        if self.mesh is not None:
            raise ValueError("failure domains are single-host only")
        racks = RackDomains(domains)
        for node in sorted(self.domain.removed):
            racks.fail(node)
        self.racks = racks
        self._fleet_dev = None
        self._upload_state()

    @property
    def racks_dev(self):
        """The device ``RackFleet`` (flushing coalesced events)."""
        self._check_routable()
        return self._racks_dev

    def _check_scale(self) -> None:
        if self.racks is not None:
            raise ValueError("a router with failure domains has a fixed layout: no scale events")

    def _check_flat(self) -> None:
        if self.racks is not None:
            raise ValueError("a router with failure domains keeps no flat fleet: place through "
                             "its StorePlacement")

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
        tr = self.tracer
        if tr is not None:
            burst = tr.open(SPAN_BURST, self._epoch)
        self._coalescing = True
        try:
            yield
        finally:
            self._coalescing = False
            if self._state_dirty:
                if tr is not None:
                    tr.open(SPAN_BURST_FLUSH)
                self._flush_events()
            if tr is not None:
                tr.close(burst)

    def _flush_events(self) -> None:
        self._state_dirty = False
        if self.racks is None:
            self._fleet_host.resync(self.domain)
        self._upload_state()

    # -- routing ------------------------------------------------------------
    session_key = staticmethod(SessionRouter.session_key)

    def _check_routable(self) -> None:
        """Route-entry guard: typed error on an all-failed fleet, and land
        any coalesced events the launch would otherwise miss."""
        if self.alive == 0:
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
        return torch.from_numpy(self._host_keys(keys).view(np.int32)).to(self.device)

    @staticmethod
    def _host_keys(keys) -> np.ndarray:
        """Any int array-like -> contiguous uint32 numpy array of the low 32
        bits."""
        if not (isinstance(keys, np.ndarray) and keys.dtype == np.uint32):
            keys = np.ascontiguousarray(keys, dtype=np.uint64).astype(np.uint32)
        return np.ascontiguousarray(keys)

    # -- load-monitor attachment (observability tier, DESIGN.md §15) --------
    def attach_load_monitor(self, monitor) -> None:
        """Instrument the fused launch with the monitor's device-side load
        accumulator (``ops.route_load_bulk``).  Replica ids stay bit-exact
        with the bare route; the count rides in the same launch.  Single-host
        fused datapath only: the mesh-sharded and two-pass paths are not
        instrumented."""
        if self.mesh is not None:
            raise ValueError(
                "load monitoring is single-host only; the mesh-sharded "
                "datapath is not instrumented"
            )
        if not self.fused:
            raise ValueError(
                "load monitoring requires the fused datapath "
                "(fused=False is the two-pass benchmark baseline)"
            )
        self._load_monitor = monitor

    def detach_load_monitor(self) -> None:
        self._load_monitor = None

    def _dispatch(self, keys: torch.Tensor) -> torch.Tensor:
        if self.fused:
            monitor = self._load_monitor
            if monitor is not None:
                n_keys = keys.numel()
                out, counts = ops.route_load_bulk(
                    keys, self._fleet_dev, monitor.counts_dev, self.spec,
                    sample_shift=monitor.effective_shift(n_keys),
                )
                monitor.note_dispatch(counts, n_keys)
                return out
            return ops.route_bulk(keys, self._fleet_dev, self.spec)
        # pre-fusion two-pass pipeline (benchmark baseline): buckets[N]
        # round-trips through memory between two launches; n is the state's
        # first element, already on the device
        fleet = self._fleet_dev
        buckets = ops.lookup_bulk_dyn(keys, fleet.state[:1], self.spec)
        return memento_remap_table(keys, buckets, fleet.packed, fleet.table, fleet.state)

    def _route_block(self, keys: torch.Tensor) -> torch.Tensor:
        """Mesh-sharded launch (``ops.make_sharded_route``): this rank
        routes its block of the flat batch (``ops.shard_bounds``), padded
        with zero keys to the block size, and keeps its ids without the
        padding.  A host batch uploads only the rank's block, into a buffer
        the router owns (which ``donate_keys`` lets the kernel overwrite); a
        device tensor the caller owns is never written."""
        lo, hi, rows = ops.shard_bounds(keys.numel(), self._n_shards, self._shard_index)
        local = self._coerce_keys(keys.reshape(-1)[lo:hi])
        # a block copied on its way (upload, cast) or padded is the router's
        owned = hi - lo < rows or (
            local.untyped_storage().data_ptr() != keys.untyped_storage().data_ptr())
        if hi - lo < rows:
            local = torch.cat([local, local.new_zeros(rows - (hi - lo))])
        donate = self.spec.donate_keys and owned
        return self._sharded_route.block(local, self._fleet_dev, donate)[: hi - lo]

    def _gather(self, block: torch.Tensor, total: int) -> torch.Tensor:
        """Every rank's block of a batch of ``total`` ids, in order: one
        all-gather of the padded blocks over the shard axis (a c10d
        collective, which gloo also runs on CUDA tensors)."""
        import torch.distributed as dist

        if self._n_shards == 1:
            return block
        rows = -(-total // self._n_shards)
        padded = torch.cat([block, block.new_zeros(rows - block.numel())])
        parts = [torch.empty_like(padded) for _ in range(self._n_shards)]
        dist.all_gather(parts, padded, group=self.mesh.get_group(self.spec.shard_axis))
        return torch.cat(parts)[:total]

    def _host_tensor(self, keys) -> torch.Tensor:
        if isinstance(keys, torch.Tensor):
            return keys
        return torch.from_numpy(self._host_keys(keys).view(np.int32))  # stays on the host

    def route_keys(self, keys):
        """Pre-hashed keys (any int tensor or array) -> int32 replica ids, on
        the device: one kernel launch, no synchronisation.  Keys are
        truncated to u32 like the engine's scalar u32 oracle does.  Under a
        mesh every rank passes the same batch and launches once on its
        block; the result is a DTensor of the batch's shape, sharded over
        ``shard_axis`` (along the flat batch: a batch whose first dim the
        shard count does not divide is gathered and replicated)."""
        if self.mesh is None:
            tr = self.tracer
            if tr is None:
                return self._route_local(keys, None)
            self.traced_calls += 1
            root = tr.open(SPAN_ROUTE_KEYS, self.traced_calls)
            try:
                return self._route_local(keys, tr)
            finally:
                tr.close(root)
        from torch.distributed.tensor import DTensor, Replicate

        self._check_routable()
        keys = self._host_tensor(keys)
        shape, total = tuple(keys.shape), keys.numel()
        if total == 0:
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        block = self._route_block(keys)
        self.stats.lookups += total
        if len(shape) > 1 and shape[0] % self._n_shards:
            # DTensor unflattens only whole rows of blocks
            whole = self._gather(block, total).reshape(shape)
            return DTensor.from_local(whole, self.mesh, [Replicate()] * self.mesh.ndim,
                                      run_check=False)
        out = DTensor.from_local(block, self.mesh, self._sharded_place, run_check=False,
                                 shape=(total,), stride=(1,))
        return out if len(shape) == 1 else out.reshape(shape)

    def _route_local(self, keys, tr) -> torch.Tensor:
        """``route_keys`` on one host; ``tr``: the tracer its stages are
        recorded into, inside the caller's ``route_keys`` span, or None."""
        if tr is not None:
            tr.open(SPAN_ROUTE_GUARD)
        self._check_flat()
        self._check_routable()
        if tr is not None:
            tr.next(SPAN_ROUTE_COERCE)
        keys = self._coerce_keys(keys)
        if keys.numel() == 0:
            return torch.zeros(keys.shape, dtype=torch.int32, device=self.device)
        if tr is not None:
            tr.next(SPAN_ROUTE_LAUNCH)  # closed with its root, at one clock reading
        out = self._dispatch(keys)
        self.stats.lookups += keys.numel()
        return out

    def route_keys_np(self, keys) -> np.ndarray:
        """Numpy-out convenience wrapper around ``route_keys``; under a mesh
        every rank gets the whole batch's ids."""
        if self.mesh is None:
            return self.route_keys(keys).cpu().numpy()
        self._check_routable()
        keys = self._host_tensor(keys)
        if keys.numel() == 0:
            return np.zeros(tuple(keys.shape), dtype=np.int32)
        block = self._route_block(keys)
        self.stats.lookups += keys.numel()
        return self._gather(block, keys.numel()).reshape(keys.shape).cpu().numpy()

    def route_ids(self, session_ids) -> torch.Tensor:
        """Raw u64 int session ids -> int32 replica ids, ONE fused launch:
        the splitmix64 session hash, the lookup and the divert all run in
        the ingest kernel, so no ``keys[N]`` array exists (DESIGN.md §9).
        Bit-exact with ``route_keys(hash_session_ids(ids))``.  Single-host
        only: under a mesh, pre-hash and call ``route_keys``."""
        if self.mesh is not None:
            raise ValueError(
                "route_ids is single-host only; under a mesh pre-hash with "
                "hash_session_ids and call route_keys"
            )
        self._check_flat()
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
        self.stats.lookups += int(ids.size)  # ct: host-ok — a numpy batch's length
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
        self._check_flat()
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
        self._check_scale()
        tr = self.tracer
        if tr is not None and self._coalescing:
            tr.open(SPAN_BURST_EVENT)
        r = self.scalar.scale_up()
        self._epoch += 1
        self._put_state()
        if tr is not None and self._coalescing:
            tr.close()
        return r

    def scale_down(self) -> int:
        self._check_scale()
        tr = self.tracer
        if tr is not None and self._coalescing:
            tr.open(SPAN_BURST_EVENT)
        r = self.scalar.scale_down()
        self._epoch += 1
        self._resync_device_state()
        if tr is not None and self._coalescing:
            tr.close()
        return r

    def fail(self, replica: int) -> None:
        tr = self.tracer
        if tr is not None and self._coalescing:
            tr.open(SPAN_BURST_EVENT)
        if self.racks is not None:
            self.racks.fail(replica)
            self._epoch += 1
            self._upload_state()
        else:
            self.scalar.fail(replica)
            self._epoch += 1
            if replica in self.domain.removed:
                self._set_removed_bit(replica, True)
            else:
                # failing the LAST slot is a true LIFO removal in the control
                # plane (slot space shrinks, tombstones may GC) — resync wholesale
                self._resync_device_state()
        if tr is not None and self._coalescing:
            tr.close()

    def recover(self, replica: int) -> None:
        tr = self.tracer
        if tr is not None and self._coalescing:
            tr.open(SPAN_BURST_EVENT)
        if self.racks is not None:
            self.racks.recover(replica)
            self._epoch += 1
            self._upload_state()
        else:
            self.scalar.recover(replica)
            self._epoch += 1
            self._set_removed_bit(replica, False)
        if tr is not None and self._coalescing:
            tr.close()

    @property
    def alive(self) -> int:
        return self.domain.alive_count

    @property
    def routing_epoch(self) -> int:
        """Fleet-event counter: the epoch the next launch routes under."""
        return self._epoch
