"""What decides ``correct`` in the erasure-coded store's cell
(``store-ec-rs63.degraded``, loop ``place_racks``) has to fail what it
should, at test sizes on the CPU: the control (the reference placing the
9 blocks flat over the DataNodes, blind to the racks) reads shared racks;
a program whose answer is altered, whose group has two blocks in one rack,
whose blocks leave a base DataNode that stays alive, or whose burst is
left undone reads not correct; the sound program reads correct with every
check 0, and its uploads a burst read 1.

Run from the repository root: ``python -m pytest portbench/tests``.
"""
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cell  # noqa: E402
from portbench.harness.registry import Bench  # noqa: E402
from portbench.reference import racks as ref_racks  # noqa: E402
from portbench.reference.hashing import lookup, u32  # noqa: E402

CELL = "store-ec-rs63.degraded"
BENCH = Bench(ROOT)
LOOP = BENCH.loop(BENCH.workload(CELL)["loop"])
SMALL = {"batch_keys": 1 << 12, "compare_batches": 3, "profile_s": 0.1,
         "bursts": {"every_s": 0.08, "size": 2}}


def _run(make_program=None, seed=2**31 + 17, trace=False):
    result, checks = cell.run(ROOT, CELL, seed, 0.5, trace, t_start=time.perf_counter(),
                              device="cpu", make_program=make_program, overrides=SMALL)
    return result, {c.name for c in checks if not c.ok}


def _broken(fault):
    class Broken(LOOP.Program):
        def call(self, keys):
            rep, exhausted = super().call(keys)
            rep = rep.clone()
            if fault == "altered":
                rep[0, 0] = (rep[0, 0] + 1) % 200
            elif fault == "shared_rack":
                # column 1 into column 0's rack, on another of its DataNodes
                per_rack = 10
                rack, local = divmod(int(rep[0, 0]), per_rack)
                rep[0, 1] = rack * per_rack + (local + 1) % per_rack
            elif fault == "moved":
                # every column 0 on its base's neighbour in the rack
                per_rack = 10
                rack = torch.div(rep[:, 0].to(torch.int64), per_rack, rounding_mode="floor")
                base = lookup(ref_racks.node_keys(u32(keys), rep.shape[1])[:, 0], per_rack, 16)
                rep[:, 0] = (rack * per_rack + (base + 1) % per_rack).to(rep.dtype)
            return rep, exhausted

        def apply(self, events):
            return super().apply([] if fault == "stale" else events)

    return Broken


def test_the_sound_program_is_correct_and_uploads_once_a_burst():
    result, failing = _run(trace=True)
    assert result["correct"] and not failing, result["checks"]
    assert result["checks"]["shared_racks"]["value"] == 0
    assert result["metrics"]["uploads_per_burst"]["value"] == 1.0


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**32 + 7])
def test_the_control_shares_racks(seed):
    control = lambda config, workload, device: LOOP.Control(  # noqa: E731
        config, workload, device, **workload["control"])
    result, failing = _run(control, seed)
    assert not result["correct"]
    assert result["checks"]["shared_racks"]["value"] > 0
    assert {"shared_racks", "mismatched_replicas"} <= failing


@pytest.mark.parametrize("fault, check", [("altered", "mismatched_replicas"),
                                          ("shared_rack", "shared_racks"),
                                          ("moved", "moved_undiverted"),
                                          ("stale", "fleet_state_diffs")])
def test_a_broken_program_is_not_correct(fault, check):
    result, failing = _run(_broken(fault))
    assert not result["correct"] and check in failing, (fault, result["checks"])
