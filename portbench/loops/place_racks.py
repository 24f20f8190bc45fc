"""The erasure-coded store's loop: each batch of block groups through
``StorePlacement.place_keys`` over failure domains (``r`` distinct racks by
the store's R-way placement over the rack fleet, then each column's
DataNode inside its rack: at r = 9 the family route, ``resolve``'s row path
and the node route, three launches), each burst of DataNode events through
the router's ``coalesced_events``, which keeps the rack fleet and each
rack's node fleet and uploads both levels in one copy.

``judge`` holds every sampled batch to the plain reference
(``portbench/reference/racks.py``) under both levels as the reference
rebuilt them from the run's events, and to the configuration's
guarantees: ``r`` distinct alive DataNodes in ``r`` distinct racks a group,
none exhausted, the device fleet state of both levels at every epoch, and
no block off its base DataNode while that is alive, as ``router-1k``'s
``moved_undiverted`` holds its keys: so between two epochs with the same
rack columns a block moves only where its base failed, recovered or was
down at both (diverted before, re-aimed by the divert).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench.harness.judge import Check, blocks
from portbench.reference import fleet as ref_fleet
from portbench.reference import racks as ref_racks
from portbench.reference.hashing import u32
from portbench.reference.placement import place as place_flat

CALL = "place"


class Program:
    """The system under test."""

    def __init__(self, config: dict, workload: dict, device):
        from repro_torch.core.bulk import FailureDomains
        from repro_torch.core.registry import make_bulk
        from repro_torch.placement.store import StorePlacement
        from repro_torch.serving.batch_router import BatchRouter

        self.router = BatchRouter(config["replicas"], engine=config["engine"],
                                  capacity=config["capacity"], omega=config["omega"], device=device)
        domains = FailureDomains(config["racks"], config["nodes_per_rack"])
        self.store = StorePlacement(self.router, r=config["r"], domains=domains)
        self.kernels = make_bulk(config["engine"]).kernels

    def warm_up(self, pool) -> None:
        for _ in range(2):
            for keys in pool:
                self.call(keys)

    def call(self, keys):
        return self.store.place_keys(keys)

    def apply(self, events):
        with self.router.coalesced_events():
            for kind, node in events:
                getattr(self.router, kind)(node)

    def state(self):
        f = self.router.racks_dev
        return types.SimpleNamespace(leaves=f.leaves(), uploads=self.router.uploads)

    def launches(self) -> int:
        return sum(self.kernels.launches.values())


class Control:
    """The reference with the rack rule broken: the ``r`` columns placed
    flat over all the DataNodes (``placement.place``, as ``store-r3``
    places), blind to the racks; its state is the reference's own."""

    def __init__(self, config: dict, workload: dict, device, **over):
        self.device, self.omega, self.r = device, config["omega"], config["r"]
        self.flat = ref_fleet.Fleet(config["replicas"])
        self.racks = ref_racks.Racks(ref_racks.Layout.of(config))

    def warm_up(self, pool) -> None:
        pass

    def call(self, keys):
        rep, exhausted = place_flat(u32(keys), self.flat.tensors(self.device), self.omega, self.r)
        return rep.to(torch.int32), exhausted

    def apply(self, events):
        for kind, node in events:
            self.flat.apply(kind, node)
            self.racks.apply(kind, node)

    def state(self):
        return types.SimpleNamespace(leaves=tuple(torch.from_numpy(a) for a in self.racks.packed()),
                                     uploads=None)

    def launches(self) -> int:
        return 0


def state_diffs(program_states, reference_states) -> Check:
    """Epochs at which the program's device state of either level (the
    rack fleet's words, table and ``[n_total, n_alive]``, then the racks'
    node fleets stacked) differs from the state the reference rebuilt."""
    if len(program_states) != len(reference_states):
        return Check("fleet_state_diffs", abs(len(program_states) - len(reference_states)) or 1, 0)
    bad = 0
    for got, want in zip(program_states, reference_states):
        parts = [np.asarray(p.cpu()).view(np.int32) for p in got.leaves]
        bad += len(parts) != 6 or any(
            g.shape != w.shape or not np.array_equal(g, w)
            for g, w in zip(parts, (np.asarray(a).view(np.int32) for a in want.packed())))
    return Check("fleet_state_diffs", bad, 0)


def judge(run) -> list:
    cfg, r = run.config, run.config["r"]
    npr, n = cfg["nodes_per_rack"], cfg["replicas"]
    states = ref_racks.replay(ref_racks.Layout.of(cfg), run.history.bursts)
    mismatched = exhausted = duplicates = shared = dead = undiverted = 0
    for epoch, index, (rep, exh) in run.samples:
        t = states[epoch].tensors(run.device)
        down = torch.cat([level.removed for level in t.nodes])
        keys, got = u32(run.pool[index]), rep.reshape(-1, r).to(torch.int64)
        for lo, hi in blocks(keys.numel()):
            g = got[lo:hi]
            racks, _ = place_flat(keys[lo:hi], t.racks, cfg["omega"], r)
            want, base = ref_racks.nodes(keys[lo:hi], racks, t, cfg["omega"])
            mismatched += int((g != want).sum())
            exhausted += int(exh[lo:hi].sum())
            duplicates += int(((g[:, :, None] == g[:, None, :]).sum(dim=(1, 2)) > r).sum())
            racks = torch.div(g, npr, rounding_mode="floor")
            shared += int(((racks[:, :, None] == racks[:, None, :]).sum(dim=(1, 2)) > r).sum())
            inside = (g >= 0) & (g < n)
            dead += int((~inside | down[g.clamp(0, n - 1)]).sum())
            undiverted += int(((g != base) & ~down[base]).sum())
    return [
        Check("batches_compared", len(run.samples), 1, at_least=True),
        Check("mismatched_replicas", mismatched, 0),
        Check("exhausted_objects", exhausted, 0),
        Check("duplicate_rows", duplicates, 0),
        Check("shared_racks", shared, 0),
        Check("dead_replicas", dead, 0),
        Check("moved_undiverted", undiverted, 0),
        state_diffs(run.history.states, states),
    ]
