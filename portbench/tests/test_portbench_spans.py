"""The port's own spans in a traced run (``portbench/harness/spans.py``):
idle gaps named by the stage the host was in, with the loop's own names
where no stage overlaps; the clock map and its anchors; the new metrics of
a traced run for exactly the cells that list them; a port without a
``tracer`` (an older one) read as before, with no new metric; and, on the
card (``-m cuda``), every launch of a port kernel inside the stage that
made it.
"""
import gc
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cell, spans  # noqa: E402
from portbench.harness.registry import Bench  # noqa: E402

BENCH = Bench(ROOT)
CELLS = [w["name"] for w in BENCH.manifest["workloads"]]
NEW = ("call_launch_us", "burst_event_us", "burst_event_us.replan", "burst_flush_ms",
       "burst_flush_ms.replan", "replan_upload_ms", "replan_copy_back_ms",
       "idle_in_program_pct", "idle_in_program_pct.replan")
#: read from the device's timeline: a CPU run has none
DEVICE = {"idle_in_program_pct", "idle_in_program_pct.replan", "route_roofline",
          "place_roofline", "place_roofline.replan", "device_idle_pct", "device_idle_pct.replan"}
SMALL = {"batch_keys": 1 << 12, "compare_batches": 2, "compare_plans": 1, "profile_s": 0.25}
KERNELS = frozenset({"route_kernel"})


def _span(name, a_us, b_us, sid, parent=0):
    """A stage as the tracer records it, ``a_us``..``b_us`` on a host
    clock that the anchors below map one to one onto the profiler's."""
    return types.SimpleNamespace(name=name, t_start_ns=int(a_us * 1000), t_end_ns=int(b_us * 1000),
                                 span_id=sid, parent_id=parent)


ONE_TO_ONE = ((0.0, 0.0), (1e9, 1e6))


def _timeline(busy, host=(), launches=()):
    events = [("k", True, a, b, 0) for a, b in busy]
    events += [(n, False, a, b, 0) for n, a, b in host]
    events += [("cudaLaunchKernel", False, a, b, c) for a, b, c in launches]
    events += [("void routing::route_kernel<B, K>(K)", True, b + 1, b + 2, c) for a, b, c in launches]
    return events


def test_a_gap_is_named_by_the_stage_whose_own_time_covers_it_most():
    # a burst from 100 to 900 µs: 3 events of 150 µs, then a flush whose
    # upload is short; the card idles from 50 to 1000
    stages = [_span("coalesced_events", 100, 900, 1), _span("coalesced_events.event", 100, 250, 2, 1),
              _span("coalesced_events.event", 250, 400, 3, 1),
              _span("coalesced_events.event", 400, 550, 4, 1),
              _span("coalesced_events.flush", 550, 900, 5, 1), _span("fleet.upload", 600, 650, 6, 5)]
    events = _timeline([(0, 50), (1000, 1e6)], host=[("portbench.burst", 90, 910)])
    _, _, pct, gaps = spans.reduce(events, ONE_TO_ONE, stages, KERNELS)
    # events 450 µs of own time, the flush 300, the upload 50, the root none
    assert gaps[0][0] == "coalesced_events.event" and gaps[0][1] == pytest.approx(950e-6)
    assert pct == pytest.approx(100 * 800 / 1e6)


def test_a_deeper_stage_takes_the_gap_where_it_holds_most_of_it():
    stages = [_span("plan_migration", 0, 1000, 1), _span("plan_migration.diff", 0, 100, 2, 1),
              _span("plan_migration.copy_back", 100, 1000, 3, 1)]
    events = _timeline([(0, 100), (1000, 1e6)], host=[("portbench.replan", 0, 1000)])
    _, _, _, gaps = spans.reduce(events, ONE_TO_ONE, stages, KERNELS)
    assert gaps[0][:2] == ["plan_migration.copy_back", pytest.approx(900e-6)]


@pytest.mark.parametrize("stage_us, want", [(600, "route_keys.launch"), (300, "issue")])
def test_a_gap_the_port_holds_less_than_half_of_is_the_loops(stage_us, want):
    # the card idles 1000 µs; the host is in the launch stage for
    # ``stage_us`` of them and waits in the loop for the rest
    stages = [_span("route_keys", 0, 100 + stage_us, 1),
              _span("route_keys.launch", 50, 100 + stage_us, 2, 1)]
    events = _timeline([(0, 100), (1100, 1e6)])
    _, _, _, gaps = spans.reduce(events, ONE_TO_ONE, stages, KERNELS)
    assert gaps[0][:2] == [want, pytest.approx(1000e-6)]


def test_a_gap_carries_the_collectors_time_inside_it():
    stages = [_span("route_keys", 0, 5000, 1), _span("route_keys.launch", 10, 5000, 2, 1)]
    events = _timeline([(0, 100), (5000, 1e6)])
    pauses = [(1_000_000, 4_000_000), (7_000_000, 8_000_000)]  # host ns
    _, _, _, gaps = spans.reduce(events, ONE_TO_ONE, stages, KERNELS, pauses)
    assert gaps[0] == ["route_keys.launch", pytest.approx(4900e-6), pytest.approx(3000e-6)]


@pytest.mark.parametrize("host, want", [([("portbench.burst", 0, 500)], "burst"),
                                        ([("portbench.replan", 200, 900)], "replan"),
                                        ([], "issue")])
def test_a_gap_no_stage_overlaps_keeps_the_loops_own_name(host, want):
    stages = [_span("route_keys", 1000, 1040, 1), _span("route_keys.launch", 1010, 1040, 2, 1)]
    events = _timeline([(0, 100), (800, 1e6)], host=host)
    _, _, pct, gaps = spans.reduce(events, ONE_TO_ONE, stages, KERNELS)
    assert gaps[0][:2] == [want, pytest.approx(700e-6)] and pct == 0


@pytest.mark.parametrize("shift_us, unaligned", [(0.0, 0), (4.0, 0), (-4.0, 0), (12.0, 2), (-12.0, 2)])
def test_a_launch_must_lie_inside_the_stage_that_made_it(shift_us, unaligned):
    stages = [_span("route_keys.launch", 100, 140, 1), _span("place_keys.launch", 300, 360, 2),
              _span("route_keys.coerce", 500, 520, 3)]
    launches = [(102 + shift_us, 138 + shift_us, 7), (302 + shift_us, 358 + shift_us, 8)]
    # a launch of a kernel the port does not declare is not checked
    events = _timeline([(0, 1e6)], launches=launches + [(505, 510, 9)])
    events = [e if e[4] != 9 or not e[1] else ("void at::fill_kernel(float)",) + e[1:]
              for e in events]
    n, bad, _, _ = spans.reduce(events, ONE_TO_ONE, stages, KERNELS)
    assert (n, bad) == (2, unaligned)


def test_the_clock_map_is_linear_through_its_anchors():
    to_us = spans.clock_map(((1_000_000.0, 10.0), (3_000_000.0, 2010.5)))
    assert to_us(1_000_000) == pytest.approx(10.0)
    assert to_us(3_000_000) == pytest.approx(2010.5)
    assert to_us(2_000_000) == pytest.approx(1010.25)


@pytest.mark.parametrize("before, after", [([], []), ([-3000.0], []), ([], [30.0, 9000.0]),
                                           ([-3000.0, -40.0], [25.0])])
def test_an_anchor_is_the_offset_that_puts_each_call_inside_its_bracket(before, after):
    # five calls of 4 µs, each bracketed by host readings 3 µs before and
    # 1 + i µs after it (the host's overheads are not symmetric), 2 ms
    # between the first two; the profiler's µs clock is the host's less
    # 7 ms; other synchronising calls (the profiler's own, the loop's
    # drain) lie before and after them
    starts = [1000.0 + 15.0 * i + (2000.0 if i else 0.0) for i in range(5)]
    calls = [(a - 7000.0, a - 7000.0 + 4.0) for a in starts]
    brackets = [(int((a - 3.0) * 1e3), int((a + 4.0 + 1.0 + i) * 1e3))
                for i, a in enumerate(starts)]
    others = [calls[0][0] + x for x in before] + [calls[-1][1] + x for x in after]
    calls = sorted(calls + [(x, x + 4.0) for x in others])
    host, prof = spans._anchor(brackets, calls, brackets[-1][1])
    assert host == brackets[-1][1] and prof - host / 1e3 == pytest.approx(-7000.0, abs=1.0)


def test_anchors_that_no_calls_fit_are_refused():
    brackets = [(0, 10_000), (50_000, 60_000)]
    with pytest.raises(RuntimeError, match="no run"):
        spans._anchor(brackets, [(0.0, 1.0), (500.0, 501.0)], 0)


def _small(name):
    bursts = BENCH.workload(name).get("bursts")
    return {**SMALL, "bursts": {**bursts, "every_s": 0.06}} if bursts else SMALL


def _traced(name, seed=2**31 + 29):
    result, checks = cell.run(ROOT, name, seed, 0.4, True, t_start=time.perf_counter(),
                              device="cpu", overrides=_small(name))
    assert result["correct"], result["checks"]
    return result


def _listed(name, metrics):
    return {m["name"] for m in BENCH.manifest["per_layer"]
            if m["name"] in metrics and name in m["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_new_metrics_of_exactly_its_cells(name, capfd):
    result = _traced(name)
    got = set(result["metrics"])
    assert got & set(NEW) == _listed(name, NEW) - DEVICE
    assert got - set(NEW) == _listed(name, {m["name"] for m in BENCH.manifest["per_layer"]}) \
        - set(NEW) - DEVICE
    for m in got & set(NEW):
        assert result["metrics"][m]["value"] >= 0
    err = capfd.readouterr().err
    assert "dropped 0;" in err and "spans unaligned: 0 of 0" in err


BURSTS = [n for n in CELLS if BENCH.workload(n).get("bursts")]


@pytest.mark.parametrize("name", BURSTS)
def test_the_span_means_cover_as_many_bursts_as_the_window(name, capfd):
    _traced(name)
    found = re.search(r"(\d+) bursts \((\d+) in the window\)", capfd.readouterr().err)
    alone, window = int(found[1]), int(found[2])
    assert window >= 5 and abs(alone - window) <= 1, found[0]


def test_the_span_stretch_leaves_nothing_frozen():
    _traced("store-r3.degraded")
    assert gc.get_freeze_count() == 0


def _failing_in_the_stretch(monkeypatch, fault):
    """Programs whose calls raise ``fault`` once a tracer is attached: the
    window and the traced stretch run as before, the program-span stretch
    does not."""
    loop = Bench.loop

    def failing(self, name):
        mod = loop(self, name)

        class Program(mod.Program):
            def call(self, keys):
                if self.router.tracer is not None:
                    raise fault
                return super().call(keys)

        return types.SimpleNamespace(Program=Program, Control=mod.Control, judge=mod.judge,
                                     CALL=mod.CALL)

    monkeypatch.setattr(Bench, "loop", failing)


@pytest.mark.parametrize("name", ["router-1k.steady", "store-r3.degraded"])
def test_a_failed_batch_in_the_span_stretch_ends_the_run(name, monkeypatch):
    _failing_in_the_stretch(monkeypatch, ValueError("refused"))
    with pytest.raises(RuntimeError, match="batches of the program-span stretch failed"):
        _traced(name)


def test_a_fault_of_the_span_stretch_is_not_swallowed(monkeypatch):
    def broken(*args, **kwargs):
        raise KeyError("a reduction at fault")

    monkeypatch.setattr(spans, "reduce", broken)
    with pytest.raises(KeyError, match="a reduction at fault"):
        _traced("router-1k.storm")


class _OldRouter:
    """A router as an older port has it: the same answers, no ``tracer``."""

    def __init__(self, router):
        self._router = router

    def __getattr__(self, name):
        if name == "tracer":
            raise AttributeError(name)
        return getattr(self._router, name)


def _older_port(monkeypatch):
    loop = Bench.loop

    def older(self, name):
        mod = loop(self, name)

        class Program(mod.Program):
            def __init__(self, *args):
                super().__init__(*args)
                self.router = _OldRouter(self.router)

        return types.SimpleNamespace(Program=Program, Control=mod.Control, judge=mod.judge,
                                     CALL=mod.CALL)

    monkeypatch.setattr(Bench, "loop", older)


@pytest.mark.parametrize("name", CELLS)
def test_a_port_without_a_tracer_reads_as_before_and_gives_no_new_metric(name, monkeypatch):
    now = _traced(name)
    _older_port(monkeypatch)
    before = _traced(name)
    assert not set(before["metrics"]) & set(NEW)
    assert set(before["metrics"]) == set(now["metrics"]) - set(NEW)
    assert before["breakdown"].keys() == now["breakdown"].keys()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_every_launch_lies_inside_its_stage_on_the_card(card, name):
    """A traced run as the benchmark makes it, in a process of its own: the
    spans mapped onto the profiler's clock put every launch of a port
    kernel inside the ``*.launch`` or ``plan_migration.diff`` stage that
    made it, within ``SLACK_US``; the ring dropped nothing; the cell's new
    metrics are all there."""
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                           str(2**31 + 71), "--seconds", "3", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900, check=False)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"], (result["checks"], done.stderr[-3000:])
    line = next(x for x in done.stderr.splitlines() if x.startswith("spans unaligned:"))
    bad, total = (int(v) for v in line.split(":")[1].split(" of "))
    assert bad == 0 and total > 0, line
    assert "dropped 0;" in done.stderr
    assert _listed(name, NEW) <= set(result["metrics"])
