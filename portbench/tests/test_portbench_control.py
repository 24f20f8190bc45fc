"""What decides ``correct`` has to fail what it should.

* The control, the reference put in the program's place with the cut its
  traffic file names (``omega`` 1, one divert redirect, no resolve probes),
  comes out not correct: at test sizes on the CPU here, and at the cell's
  own size on the card (marker ``cuda``: ``python -m pytest -m cuda
  portbench/tests``).
* A run driven whole, past the harness's look for a card, with the timed
  path broken underneath, comes out not correct for each fault the cell
  can have: an answer altered where it is produced, half of the batch left
  out, and (cells with fleet events) a burst that leaves the state as it
  was.  The sound program comes out correct.
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

BENCH = Bench(ROOT)
CELLS = [w["name"] for w in BENCH.manifest["workloads"]]
SMALL = {"batch_keys": 1 << 14, "compare_batches": 3, "compare_plans": 2, "profile_s": 0.1}


def _small(name: str) -> dict:
    bursts = BENCH.workload(name).get("bursts")
    if bursts:  # several bursts in a short window
        return {**SMALL, "bursts": {**bursts, "every_s": 0.08}}
    return SMALL


def _run(name, seed, make_program=None, *, device="cpu", seconds=0.5, overrides=None):
    result, checks = cell.run(ROOT, name, seed, seconds, False, t_start=time.perf_counter(),
                              device=device, make_program=make_program,
                              overrides=_small(name) if overrides is None else overrides)
    return result, [c for c in checks if not c.ok]


def _control(name):
    loop = BENCH.loop(BENCH.workload(name)["loop"])
    return lambda config, workload, device: loop.Control(config, workload, device,
                                                         **workload["control"])


def _broken(name, fault):
    loop = BENCH.loop(BENCH.workload(name)["loop"])

    class Broken(loop.Program):
        def call(self, keys):
            if fault == "half":
                half = keys.numel() // 2
                got = super().call(keys[:half])
                if isinstance(got, tuple):
                    rep, flags = got
                    return (torch.cat([rep, rep.new_zeros((keys.numel() - half,) + rep.shape[1:])]),
                            torch.cat([flags, flags.new_zeros(keys.numel() - half)]))
                return torch.cat([got, got.new_zeros(keys.numel() - half)])
            got = super().call(keys)
            if fault == "altered":
                rep = (got[0] if isinstance(got, tuple) else got).clone()
                rep.view(-1)[0] = (rep.view(-1)[0] + 1) % 1000
                return (rep, got[1]) if isinstance(got, tuple) else rep
            return got

        def apply(self, events):
            return super().apply([] if fault == "stale" else events)

    return Broken


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    result, failing = _run(name, 2**31 + 3)
    assert result["correct"] and not failing and result["failed"] == 0


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**32 + 7])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed):
    result, failing = _run(name, seed, _control(name))
    assert not result["correct"], result["checks"]
    assert {c.name for c in failing} & {"mismatched_ids", "dead_routes", "mismatched_replicas",
                                        "exhausted_objects", "duplicate_rows"}


FAULTS = [(name, fault) for name in CELLS for fault in ("altered", "half", "stale")
          if fault != "stale" or BENCH.workload(name).get("bursts")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    result, failing = _run(name, 2**31 + 5, _broken(name, fault))
    assert not result["correct"], (fault, result["checks"])
    if fault == "stale":
        assert "fleet_state_diffs" in {c.name for c in failing}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name, seed):
    """The control at the cell's own sizes, on the card; its readings are
    printed (the upper readings of ``PERF.md``).  The control computes each
    batch in plain torch, far slower than the kernels, so it answers fewer
    batches than a run of the program does."""
    result, failing = _run(name, seed, _control(name), device=card, seconds=8.0, overrides={})
    print(f"control {name} seed {seed}: "
          + ", ".join(f"{k} {v['value']}" for k, v in result["checks"].items()))
    assert not result["correct"]
    assert result["checks"]["batches_compared"]["value"] >= 1
