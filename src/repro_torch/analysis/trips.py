"""The runs of layer 3's ``sass-loops-bounded`` check: every kernel instance
on the counting build (``repro_torch.kernels.build.counting``), each launch
beside the same launch on the shipping build.

The counting build is the library's sources with ``ROUTING_COUNT_TRIPS``
defined: every loop whose ``// ct-loop:`` tag is not ``static`` keeps its
largest trip count (and, for the ``omega`` and ``max_chain`` loops, the
most steps any one key took) in a device array, which two entry points of
that build reset and read.  A run resets the array, launches one kernel on
the counting build, reads the array and the shape the launch took (the
build's own launch log), and launches the same kernel on the same operands
on the shipping build: the outputs must be equal bit for bit.
``sass_gate.bounded_check`` holds the counts to their bounds.

The fleets, per engine (``engine_runs``), each a healthy fleet and a storm
fleet over the same keys:
- the contract's (64 slots, 2,048 keys; the storm fails every odd slot);
- the serving fleet (``sass_gate.SERVING_FLEET``: 1000 in 1024, 0 and 250
  failed, 2^20 keys), with the placement at r = 3 and r = 16 and with a
  too-small ``max_resalt``: the family route and resolve alone, and at
  r = 3 ``place`` (both in one launch) without and with the old rows;
- 40000 in 65536 with 0 and 10,000 failed (``route_load``'s global
  instance, capacity > 4,096);
- the node route over 20 racks of 10 DataNodes (``RACKS``), healthy and
  with 20 DataNodes and a whole rack down, at r = 9 and r = 3, without and
  with the old rows (its rack columns from the shipping build);
- the lookups at n = 1 (the jump chunk's zero fill), 1025 (half the
  binomial keys go past the loop's first trip) and 2^31 - 1;
and for the chain remap (``chain_runs``), chain-mode fleets of 1000 in 1024
with 0 against 6, 50 and 90 % failed, and 90 % at ``max_chain`` 8.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis.sass_gate import (
    MAX_R,
    SERVING_FLEET,
    Launch,
    fleet_of,
    trip_loop_names,
)
from repro_torch.kernels import build

#: the contract's fleet and batch (``certify.EngineContract``'s defaults)
CONTRACT = (64, 64, 2048)
#: route_load's global-atomic instance: n, capacity, failed
WIDE_FLEET = (40000, 65536, 10000)
#: the placements run: r in registers, r past them, and a probe bound too
#: small for the fleet (keys exhaust it)
PLACE_RS = (3, 16)
SMALL_RESALT = 1
#: the node route's layout (racks, DataNodes a rack),
#: its failed DataNodes beside a whole rack, and its r
RACKS = (20, 10)
RACKS_FAILED, RACKS_DOWN = 20, 7
NODE_RS = (9, 3)
#: the bare lookups' extra n
LOOKUP_NS = (1, 1025, (1 << 31) - 1)
#: the chain fleets' failed shares, and the walk bound of the last run
CHAIN_SHARES = (0.06, 0.5, 0.9)
SHORT_CHAIN = 8
OMEGA = 16


@dataclasses.dataclass
class TripRun:
    """One launch on the counting build: which kernel, on which fleet (a
    group's healthy or storm side), the launch's parameters, and each
    counted loop's largest trips of one entry and steps of one key (by
    ``TripLoop`` name), and whether its outputs equal the shipping
    build's."""

    kind: str
    group: str
    storm: bool
    launch: Launch
    trips: dict
    steps: dict
    same: bool


def _u32(seed: int, size: int, device) -> torch.Tensor:
    x = np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _failed(n: int, k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(n - 1, size=k, replace=False)


class Counter:
    """The counting build on one device: runs a launch with its counters
    reset before and read after."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.lib = build.counting_library()
        self.names = trip_loop_names(build.CSRC / name for name in build.SOURCES)
        self.buf = torch.zeros(2 * len(self.names), dtype=torch.int32, device=self.device)

    def _stream(self) -> ctypes.c_void_p:
        return ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream)

    def measure(self, call: Callable[[], tuple]) -> tuple:
        """``call()``'s outputs, its one launch's (grid, items), and the
        counted loops' trips and steps by name."""
        if self.lib.routing_trips_reset(self._stream()) != len(self.names):
            raise RuntimeError("routing_trips_reset failed: the counting build's loops are "
                               f"not the {len(self.names)} TripLoop names of the sources")
        self.lib.routing_take_launches(None, 0)
        out = call()
        buf = (ctypes.c_int * 4)()
        made = self.lib.routing_take_launches(buf, 2)
        if made != 1:
            raise RuntimeError(f"a counted run made {made} launches; it must make one")
        if self.lib.routing_trips_read(ctypes.c_void_p(self.buf.data_ptr()),
                                       self._stream()) != len(self.names):
            raise RuntimeError("routing_trips_read failed")
        counts = self.buf.cpu().numpy().view(np.uint32).tolist()
        k = len(self.names)
        return (out, (buf[0], buf[1]), dict(zip(self.names, counts[:k])),
                dict(zip(self.names, counts[k:])))


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
        for x, y in zip(a, b))


def _run(counter: Counter, shipping, counting, kind: str, group: str, storm: bool, n: int,
         call: Callable, **params) -> TripRun:
    """``call(kernels)`` on the counting build (counted) and on the
    shipping build; ``n`` is the launch's key count, ``params`` the rest of
    its ``Launch``."""
    got, (grid, items), trips, steps = counter.measure(lambda: call(counting))
    want = call(shipping)
    return TripRun(kind, group, storm, Launch(n, grid, items, **params), trips, steps,
                   _same(got, want))


def engine_runs(engine: str, device) -> list:
    """Every kernel instance of ``engine`` but the chain remap, on the
    counting build over the module's fleets (see the module's note)."""
    from repro_torch.core.registry import make_bulk

    shipping = make_bulk(engine).kernels
    counting = shipping.using(build.counting_library)
    counter = Counter(device)
    runs = []

    def run(kind, group, storm, n, call, **params):
        runs.append(_run(counter, shipping, counting, kind, group, storm, n, call, **params))

    n_ser, cap_ser, k_ser, keys_ser = SERVING_FLEET
    groups = [("contract 64/64", CONTRACT[0], CONTRACT[1], list(range(1, CONTRACT[0], 2)),
               CONTRACT[2]),
              (f"serving {n_ser}/{cap_ser}", n_ser, cap_ser, _failed(n_ser, k_ser, 2), keys_ser)]
    for label, n, capacity, failed, batch in groups:
        keys, hi = _u32(0, batch, device), _u32(1, batch, device)
        tokens = keys[:batch // 8]
        n_dev = torch.tensor([n], dtype=torch.int32, device=device)
        healthy = fleet_of(engine, n, capacity, [], device)
        rs = PLACE_RS if n == n_ser else PLACE_RS[:1]
        old = {}
        for r in rs:
            base = shipping.route_family(keys, r, healthy.packed, healthy.table, healthy.state,
                                         OMEGA)
            old[r] = shipping.resolve(keys, base, healthy.table, healthy.state, 64)[0]
        for storm, removed in ((False, []), (True, failed)):
            fleet = healthy if not storm else fleet_of(engine, n, capacity, removed, device)
            args = (fleet.packed, fleet.table, fleet.state)
            run("route", label, storm, batch, lambda k: k.route(keys, *args, OMEGA),
                omega=OMEGA, capacity=capacity)
            run("ingest", label, storm, batch, lambda k: k.ingest(keys, hi, *args, OMEGA),
                omega=OMEGA, capacity=capacity)
            run("lookup_dyn", label, storm, batch, lambda k: k.lookup_dyn(keys, n_dev, OMEGA),
                omega=OMEGA)
            run("lookup_vec", label, storm, batch, lambda k: k.lookup_vec(keys, n, OMEGA),
                omega=OMEGA)
            run("lookup_router", label, storm, tokens.numel() * 8,
                lambda k: k.lookup_router(tokens, 3, 8, n, OMEGA), omega=OMEGA)
            run("route_load<true>", label, storm, batch,
                lambda k: k.route_load(keys, *args, torch.zeros(capacity, dtype=torch.int32,
                                                                device=device), OMEGA, 6),
                omega=OMEGA, capacity=capacity)
            for r in rs:
                resolve = "resolve<true>" if r <= 8 else "resolve<false>"
                run("route_family", label, storm, batch * r,
                    lambda k, r=r: k.route_family(keys, r, *args, OMEGA), omega=OMEGA,
                    capacity=capacity, r=r)
                base = shipping.route_family(keys, r, *args, OMEGA)
                for max_resalt in (64, SMALL_RESALT):
                    run(resolve if max_resalt == 64 else f"{resolve} max_resalt {max_resalt}",
                        label, storm, batch,
                        lambda k, r=r, base=base, m=max_resalt: k.resolve(
                            keys, base, fleet.table, fleet.state, m, old[r]),
                        r=r, max_resalt=max_resalt)
                if r > MAX_R:
                    continue  # place takes the two launches above
                for max_resalt, prev in ((64, None), (64, old[r]), (SMALL_RESALT, old[r])):
                    run("place" + (" old" if prev is not None else "")
                        + (f" max_resalt {max_resalt}" if max_resalt != 64 else ""),
                        label, storm, batch * r,
                        lambda k, r=r, m=max_resalt, prev=prev: k.place(
                            keys, r, *args, OMEGA, m, prev),
                        omega=OMEGA, capacity=capacity, r=r, max_resalt=max_resalt)
    n, capacity, k_wide = WIDE_FLEET
    keys = _u32(4, keys_ser, device)
    for storm, removed in ((False, []), (True, _failed(n, k_wide, 3))):
        fleet = fleet_of(engine, n, capacity, removed, device)
        run("route_load<false>", f"{n}/{capacity}", storm, keys_ser,
            lambda k, f=fleet: k.route_load(keys, f.packed, f.table, f.state,
                                            torch.zeros(capacity, dtype=torch.int32,
                                                        device=device), OMEGA, 6),
            omega=OMEGA, capacity=capacity)
    runs += node_runs(counter, shipping, counting, keys[:1 << 16], device)
    for n in LOOKUP_NS:
        n_dev = torch.tensor([n], dtype=torch.int32, device=device)
        run("lookup_dyn", f"n = {n}", False, keys_ser,
            lambda k, n_dev=n_dev: k.lookup_dyn(keys, n_dev, OMEGA), omega=OMEGA)
        if n > 1:
            run("lookup_vec", f"n = {n}", False, keys_ser,
                lambda k, n=n: k.lookup_vec(keys, n, OMEGA), omega=OMEGA)
    return runs


def rack_fleet(failed, device):
    """The device ``RackFleet`` of ``RACKS`` with the DataNodes ``failed``
    failed (in order)."""
    from repro_torch.core.bulk import FailureDomains, RackDomains

    plane = RackDomains(FailureDomains(*RACKS))
    for node in failed:
        plane.fail(int(node))
    return plane.host.to(device)


def node_runs(counter: Counter, shipping, counting, keys, device) -> list:
    """The node route on the counting build over ``RACKS``, healthy and
    storm (``RACKS_FAILED`` random DataNodes and every DataNode of rack
    ``RACKS_DOWN``), at each of ``NODE_RS``, without and with the old rows;
    the rack columns come from the shipping build's placement over the rack
    fleet."""
    from repro_torch.core.bulk import FailureDomains

    racks, per_rack = RACKS
    node_cap = FailureDomains(*RACKS).node_capacity
    n = racks * per_rack
    down = range(RACKS_DOWN * per_rack, (RACKS_DOWN + 1) * per_rack)
    failed = [int(d) for d in _failed(n, RACKS_FAILED, 6) if d not in down] + list(down)
    runs = []
    healthy = rack_fleet([], device)
    for storm, fleet in ((False, healthy), (True, rack_fleet(failed, device))):
        f = fleet.racks
        for r in NODE_RS:
            cols = shipping.place(keys, r, f.packed, f.table, f.state, OMEGA, 64)[0]
            old = None
            for prev in (None, "old"):
                if prev is not None:
                    h = healthy.racks
                    hcols = shipping.place(keys, r, h.packed, h.table, h.state, OMEGA, 64)[0]
                    old = shipping.node_route(keys, hcols, healthy.packed, healthy.table,
                                              healthy.state, per_rack, OMEGA)[0]
                runs.append(_run(
                    counter, shipping, counting, "node_route" + (" old" if prev else ""),
                    f"racks {racks}x{per_rack}", storm, keys.numel() * r,
                    lambda k, c=cols, o=old: k.node_route(keys, c, fleet.packed, fleet.table,
                                                          fleet.state, per_rack, OMEGA, o),
                    omega=OMEGA, capacity=node_cap, r=r))
    return runs


def chain_runs(device) -> list:
    """The chain remap on the counting build: the serving fleet in chain
    mode, healthy against 6, 50 and 90 % failed, then 90 % with walks cut
    at ``SHORT_CHAIN`` steps; its base buckets from the shipping build's
    ``lookup_dyn``."""
    from repro_torch.core.registry import make_bulk

    shipping = make_bulk("binomial").kernels
    counting = shipping.using(build.counting_library)
    counter = Counter(device)
    n, capacity, _, batch = SERVING_FLEET
    keys = _u32(5, batch, device)
    runs = []
    healthy = fleet_of("binomial", n, capacity, [], device, chain=True)
    cases = [(share, None) for share in CHAIN_SHARES] + [(CHAIN_SHARES[-1], SHORT_CHAIN)]
    for share, limit in cases:
        label = f"{share:.0%} failed" + ("" if limit is None else f", max_chain {limit}")
        storm = fleet_of("binomial", n, capacity, _failed(n, round(share * n), 9), device,
                         chain=True)
        for is_storm, fleet in ((False, healthy), (True, storm)):
            max_chain = fleet.max_chain if limit is None else limit
            buckets = shipping.lookup_dyn(keys, fleet.state[:1], OMEGA)
            runs.append(_run(counter, shipping, counting, "chain_remap", f"chain {label}",
                             is_storm, batch,
                             lambda k, f=fleet, b=buckets, m=max_chain: k.chain_remap(
                                 keys, b, f.packed, f.state, m),
                             max_chain=max_chain))
    return runs

