"""The replicated store's loop: each batch of objects through
``StorePlacement.place_keys`` (the family route and ``resolve``, two
launches), each burst of OSD events through the router's
``coalesced_events``.  With ``register``, the first batch of the pool is
registered as the store's objects at set-up; with ``replan``, every burst
is followed by ``plan_migration`` against the fleet as it was before the
burst (the keys up, four launches, the plan copied back).

``judge`` holds every sampled batch and every sampled plan to the plain
reference under the fleet states the reference rebuilt from the run's
events, and to the configuration's guarantees: ``r`` distinct alive OSDs
an object, none exhausted.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench.harness.judge import Check, blocks, state_diffs
from portbench.reference import fleet as ref_fleet
from portbench.reference.hashing import u32
from portbench.reference.placement import moved, place

CALL = "place"


class Program:
    """The system under test."""

    def __init__(self, config: dict, workload: dict, device):
        from repro_torch.core.bulk import FleetState
        from repro_torch.core.registry import make_bulk
        from repro_torch.placement.store import StorePlacement
        from repro_torch.serving.batch_router import BatchRouter

        self.router = BatchRouter(config["replicas"], engine=config["engine"],
                                  capacity=config["capacity"], omega=config["omega"], device=device)
        self.store = StorePlacement(self.router, r=config["r"])
        self.kernels = make_bulk(config["engine"]).kernels
        self.register = workload.get("register", False)
        self._pack = FleetState.pack
        if workload.get("replan", False):
            self.after_burst = self._replan

    def _fleet(self):
        return self._pack(self.router.domain, self.router.capacity)

    def warm_up(self, pool) -> None:
        if self.register:
            self.store.register(pool[0].cpu().numpy().view(np.uint32))
        for _ in range(2):
            for keys in pool:
                self.call(keys)
        if hasattr(self, "after_burst"):
            self.after_burst(self._fleet())

    def call(self, keys):
        return self.store.place_keys(keys)

    def apply(self, events):
        before = self._fleet() if hasattr(self, "after_burst") else None
        with self.router.coalesced_events():
            for kind, slot in events:
                getattr(self.router, kind)(slot)
        return before

    def _replan(self, before):
        return self.store.plan_migration(before)

    def state(self) -> tuple:
        f = self.router._fleet_dev
        return f.packed, f.table, f.state

    def launches(self) -> int:
        return sum(self.kernels.launches.values())


class Control:
    """The reference in the program's place, cut by ``over``
    (``max_resalt``: fewer resolve probes; ``omega``; ``redirects``)."""

    def __init__(self, config: dict, workload: dict, device, **over):
        self.device, self.capacity, self.r = device, config["capacity"], config["r"]
        self.omega = over.get("omega", config["omega"])
        self.cut = {"max_resalt": over.get("max_resalt"), "redirects": over.get("redirects", 2)}
        self.fleet = ref_fleet.Fleet(config["replicas"])
        self.tensors = self.fleet.tensors(device)
        self.keys = None
        if workload.get("replan", False):
            self.after_burst = self._replan

    def _place(self, keys, tensors):
        return place(u32(keys), tensors, self.omega, self.r, **self.cut)

    def warm_up(self, pool) -> None:
        self.keys = pool[0]

    def call(self, keys):
        rep, exhausted = self._place(keys, self.tensors)
        return rep.to(torch.int32), exhausted

    def apply(self, events):
        before = self.tensors
        for kind, slot in events:
            self.fleet.apply(kind, slot)
        self.tensors = self.fleet.tensors(self.device)
        return before

    def _replan(self, before):
        old, _ = self._place(self.keys, before)
        new, _ = self._place(self.keys, self.tensors)
        return types.SimpleNamespace(keys=self.keys.cpu().numpy().view(np.uint32),
                                     old=old.cpu().numpy(), new=new.cpu().numpy(),
                                     moved=moved(new, old).cpu().numpy())

    def state(self) -> tuple:
        return tuple(torch.from_numpy(a) for a in self.fleet.packed(self.capacity))

    def launches(self) -> int:
        return 0


def judge(run) -> list:
    cfg, r = run.config, run.config["r"]
    states = ref_fleet.replay(cfg["replicas"], run.history.bursts)
    mismatched = exhausted = duplicates = dead = 0
    for epoch, index, (rep, exh) in run.samples:
        t = states[epoch].tensors(run.device)
        keys, got = u32(run.pool[index]), rep.reshape(-1, r).to(torch.int64)
        for lo, hi in blocks(keys.numel()):
            g = got[lo:hi]
            want, _ = place(keys[lo:hi], t, cfg["omega"], r)
            mismatched += int((g != want).sum())
            exhausted += int(exh[lo:hi].sum())
            duplicates += int(((g[:, :, None] == g[:, None, :]).sum(dim=(1, 2)) > r).sum())
            inside = (g >= 0) & (g < t.n_total)
            dead += int((~inside | t.removed[g.clamp(0, t.n_total - 1)]).sum())
    checks = [
        Check("batches_compared", len(run.samples), 1, at_least=True),
        Check("mismatched_replicas", mismatched, 0),
        Check("exhausted_objects", exhausted, 0),
        Check("duplicate_rows", duplicates, 0),
        Check("dead_replicas", dead, 0),
        state_diffs(run.history.states, states, cfg["capacity"]),
    ]
    if not run.workload.get("replan", False):
        return checks
    registered = u32(run.pool[0])
    wrong = 0
    for burst, plan in run.plans:
        before, after = states[burst - 1].tensors(run.device), states[burst].tensors(run.device)
        keys = torch.from_numpy(np.asarray(plan.keys, np.uint32).view(np.int32)).to(run.device)
        wrong += int((u32(keys) != registered).sum()) if keys.numel() == registered.numel() \
            else registered.numel()
        parts = [torch.from_numpy(np.asarray(a)).to(run.device).reshape(-1, r)
                 for a in (plan.old, plan.new, plan.moved)]
        for lo, hi in blocks(registered.numel()):
            old, _ = place(registered[lo:hi], before, cfg["omega"], r)
            new, _ = place(registered[lo:hi], after, cfg["omega"], r)
            for got, want in zip(parts, (old, new, moved(new, old))):
                wrong += int((got[lo:hi].to(want.dtype) != want).sum())
    return checks + [Check("plans_compared", len(run.plans), 1, at_least=True),
                     Check("plan_mismatches", wrong, 0)]
