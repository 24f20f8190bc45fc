"""The benchmark's plain reference held against the port's plain versions
and its scalar oracles, at small sizes on the CPU, across event sequences
and at r = 3.

Run from the repository root: ``python -m pytest portbench/tests``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import traffic  # noqa: E402
from portbench.reference import fleet as ref_fleet  # noqa: E402
from portbench.reference.hashing import lookup, route, u32  # noqa: E402
from portbench.reference.placement import moved, place  # noqa: E402
from repro_torch.core.binomial_torch import binomial_lookup_dyn  # noqa: E402
from repro_torch.core.bulk import FleetState, PlacementSpec, RouterSpec  # noqa: E402
from repro_torch.core.memento_torch import binomial_memento_route  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.router import SessionRouter  # noqa: E402


def _keys(seed: int, n: int) -> torch.Tensor:
    x = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32))


def _bursts(seed: int, workload: dict, n: int, count: int) -> list:
    schedule = traffic.Schedule(seed, workload, n)
    return [schedule.start()] + [schedule.burst() for _ in range(count)]


def _plane(n: int, capacity: int, bursts):
    """The port's control plane after each burst, and its packed fleet
    state (the plane moves on when the next is drawn)."""
    plane = SessionRouter(n, engine="binomial32", chain_bits=32, resolve="table",
                          allow_empty=True)
    for burst in bursts:
        for kind, slot in burst:
            getattr(plane, kind)(slot)
        yield plane, FleetState.pack(plane.domain, capacity)


#: fleets of ``n`` slots in ``capacity`` and their traffic, as the cells'
WORKLOADS = {
    "storm": {"n": 1000, "capacity": 1024, "start": {"failed": 250},
              "bursts": {"every_s": 1, "size": 40}},
    "degraded": {"n": 200, "capacity": 256, "start": {"failed": 50},
                 "bursts": {"every_s": 1, "size": 2}},
    "healthy": {"n": 1000, "capacity": 1024, "start": {"failed": 0},
                "bursts": {"every_s": 1, "size": 3}},
    "small": {"n": 20, "capacity": 1024, "start": {"failed": 5},
              "bursts": {"every_s": 1, "size": 2}},
}


@pytest.mark.parametrize("n", [1, 2, 3, 7, 1000, 1024, 1025, 65536, 2**31 - 1])
@pytest.mark.parametrize("omega", [1, 4, 16])
def test_lookup_matches_the_port(n, omega):
    keys = _keys(n + omega, 4096)
    want = binomial_lookup_dyn(keys, n, omega).to(torch.int64)
    assert torch.equal(lookup(u32(keys), n, omega), want)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fleet_rebuilt_from_events_matches_the_port(name, seed):
    w = WORKLOADS[name]
    n = w["n"]
    bursts = _bursts(seed, w, n, 6)
    ours = ref_fleet.replay(n, bursts)
    for mine, (_, theirs) in zip(ours, _plane(n, w["capacity"], bursts)):
        words, table, state = mine.packed(w["capacity"])
        assert np.array_equal(words, theirs.packed.view(np.int32))
        assert np.array_equal(table, theirs.table)
        assert np.array_equal(state, theirs.state.view(np.int32))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_route_matches_the_plain_route_and_the_scalar_oracle(name, seed):
    w = WORKLOADS[name]
    n = w["n"]
    bursts = _bursts(seed, w, n, 4)
    keys = _keys(seed, 2048)
    for mine, (plane, packed) in zip(ref_fleet.replay(n, bursts), _plane(n, w["capacity"], bursts)):
        got, base = route(u32(keys), mine.tensors("cpu"), 16)
        f = packed.to("cpu")
        want = binomial_memento_route(keys, f.packed, f.table, f.state, 16).to(torch.int64)
        assert torch.equal(got, want)
        for i in range(0, 2048, 97):
            assert int(got[i]) == plane.domain.locate(int(u32(keys[i])))
        # a key whose slot is alive stays on it; no key lands on a failed slot
        t = mine.tensors("cpu")
        assert not bool(((got != base) & ~t.removed[base]).any())
        assert not bool(t.removed[got].any())


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_place_matches_the_port_at_r3(name, seed):
    w = WORKLOADS[name]
    n = w["n"]
    bursts = _bursts(seed, w, n, 3)
    keys = _keys(seed, 4096)
    pspec = PlacementSpec(router=RouterSpec(engine="binomial", capacity=w["capacity"]), r=3)
    states = list(zip(ref_fleet.replay(n, bursts), _plane(n, w["capacity"], bursts)))
    for (mine, (_, packed)), (before, (_, old_packed)) in zip(states[1:], states):
        rep, exhausted = place(u32(keys), mine.tensors("cpu"), 16, 3)
        want, want_exhausted = ops.route_replicas_bulk(keys, packed.to("cpu"), pspec)
        assert torch.equal(rep, want.to(torch.int64))
        assert torch.equal(exhausted, want_exhausted)
        assert not bool(exhausted.any())
        old, _ = place(u32(keys), before.tensors("cpu"), 16, 3)
        o, nw, mv, _ = ops.placement_diff_bulk(keys, old_packed.to("cpu"), packed.to("cpu"), pspec)
        assert torch.equal(old, o.to(torch.int64)) and torch.equal(moved(rep, old), mv)


@pytest.mark.parametrize("cut, field, name", [({"max_resalt": 0}, "exhausted", "storm"),
                                              ({"max_resalt": 0}, "exhausted", "degraded"),
                                              ({"redirects": 1}, "dead", "storm")])
def test_the_controls_break_a_stated_guarantee(cut, field, name):
    """The cuts the controls make are visible at test sizes."""
    w = WORKLOADS[name]
    mine = ref_fleet.replay(w["n"], _bursts(7, w, w["n"], 0))[0].tensors("cpu")
    keys = u32(_keys(7, 1 << 15))
    rep, exhausted = place(keys, mine, 16, 3, **cut)
    if field == "exhausted":
        assert int(exhausted.sum()) > 0
    else:
        assert int(mine.removed[rep].sum()) > 0


def test_omega_one_differs_from_omega_sixteen():
    keys = u32(_keys(8, 1 << 15))
    assert int((lookup(keys, 1000, 1) != lookup(keys, 1000, 16)).sum()) > 100


@pytest.mark.parametrize("event", [("fail", 999), ("recover", 3), ("fail", -1), ("drain", 4)])
def test_fleet_refuses_events_the_traffic_never_sends(event):
    fleet = ref_fleet.Fleet(1000)
    with pytest.raises(ValueError):
        fleet.apply(*event)


def test_schedule_is_a_function_of_the_seed():
    spec = WORKLOADS["storm"]
    a, b = _bursts(11, spec, 1000, 5), _bursts(11, spec, 1000, 5)
    assert a == b and _bursts(12, spec, 1000, 5) != a
    # failures and recoveries alternate over the same slots, never the last
    assert sorted(s for _, s in a[1]) == sorted(s for _, s in a[2])
    assert all(s < 999 for burst in a for _, s in burst)
