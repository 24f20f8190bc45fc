"""The routing tier's loop: each batch through ``BatchRouter.route_keys``
(one fused launch: lookup and divert), each burst of fleet events through
``BatchRouter.coalesced_events`` (the events on the host, then one upload
of the fleet state).

``judge`` holds every sampled batch to the plain reference under the fleet
state the reference rebuilt from the run's events, and to the
configuration's guarantees: every key on an alive replica, and no key
whose slot is alive moved off it.
"""
from __future__ import annotations

import torch

from portbench.harness.judge import Check, blocks, state_diffs
from portbench.reference import fleet as ref_fleet
from portbench.reference.hashing import route, u32

#: the call whose bytes ``portbench/roofline/route.py`` counts
CALL = "route"


class Program:
    """The system under test."""

    def __init__(self, config: dict, workload: dict, device):
        from repro_torch.core.registry import make_bulk
        from repro_torch.serving.batch_router import BatchRouter

        self.router = BatchRouter(config["replicas"], engine=config["engine"],
                                  capacity=config["capacity"], omega=config["omega"], device=device)
        self.kernels = make_bulk(config["engine"]).kernels

    def warm_up(self, pool) -> None:
        for _ in range(2):
            for keys in pool:
                self.call(keys)

    def call(self, keys):
        return self.router.route_keys(keys)

    def apply(self, events) -> None:
        with self.router.coalesced_events():
            for kind, slot in events:
                getattr(self.router, kind)(slot)

    def state(self) -> tuple:
        f = self.router._fleet_dev
        return f.packed, f.table, f.state

    def launches(self) -> int:
        return sum(self.kernels.launches.values())


class Control:
    """The reference in the program's place, cut by ``over`` (``omega``:
    fewer lookup rounds; ``redirects``: one divert round)."""

    def __init__(self, config: dict, workload: dict, device, **over):
        self.device, self.capacity = device, config["capacity"]
        self.omega = over.get("omega", config["omega"])
        self.redirects = over.get("redirects", 2)
        self.fleet = ref_fleet.Fleet(config["replicas"])
        self.tensors = self.fleet.tensors(device)

    def warm_up(self, pool) -> None:
        pass

    def call(self, keys):
        return route(u32(keys), self.tensors, self.omega, redirects=self.redirects)[0].to(torch.int32)

    def apply(self, events) -> None:
        for kind, slot in events:
            self.fleet.apply(kind, slot)
        self.tensors = self.fleet.tensors(self.device)

    def state(self) -> tuple:
        return tuple(torch.from_numpy(a) for a in self.fleet.packed(self.capacity))

    def launches(self) -> int:
        return 0


def judge(run) -> list:
    cfg = run.config
    states = ref_fleet.replay(cfg["replicas"], run.history.bursts)
    mismatched = dead = undiverted = 0
    for epoch, index, out in run.samples:
        t = states[epoch].tensors(run.device)
        keys, got = u32(run.pool[index]), out.reshape(-1).to(torch.int64)
        for lo, hi in blocks(keys.numel()):
            g = got[lo:hi]
            want, base = route(keys[lo:hi], t, cfg["omega"])
            mismatched += int((g != want).sum())
            inside = (g >= 0) & (g < t.n_total)
            dead += int((~inside | t.removed[g.clamp(0, t.n_total - 1)]).sum())
            undiverted += int(((g != base) & ~t.removed[base]).sum())
    return [
        Check("batches_compared", len(run.samples), 1, at_least=True),
        Check("mismatched_ids", mismatched, 0),
        Check("dead_routes", dead, 0),
        Check("moved_undiverted", undiverted, 0),
        state_diffs(run.history.states, states, cfg["capacity"]),
    ]
