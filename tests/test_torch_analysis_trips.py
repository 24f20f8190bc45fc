"""Layer 3's ``sass-loops-bounded`` on the CPU: the counting build's sites
in the kernel sources, the bound formulas at the contract's and the serving
fleet's launches, the jump chains' bound against a simulation of its lane
refill, and the check's verdicts on synthetic counts.  The counting build
itself runs only on the card (``chip_smoke.py`` phase 1 certify,
``tests/test_torch_cuda.py::test_sass_gate_on_card``)."""
import dataclasses
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.analysis import sass_gate  # noqa: E402
from repro_torch.analysis.report import FAIL, PASS, SKIPPED, WAIVED, render_trip_table  # noqa: E402
from repro_torch.analysis.sass_gate import BOUNDS, Launch, jump_chain_trips  # noqa: E402
from repro_torch.analysis.trips import TripRun  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

PATHS = [build.CSRC / name for name in build.SOURCES]
LOOPS, FINDINGS = sass_gate.counted_loops(PATHS)
NAMES = sass_gate.trip_loop_names(PATHS)

#: the contract's launch (2,048 keys: one key a lane, 8 blocks of 256) and
#: the serving fleet's at 2^20 keys (4 keys a lane over 1,024 blocks), and
#: 2^24 keys over a resident grid of 1,056 blocks (8 keys a lane)
CONTRACT = Launch(2048, 8, 1, omega=16, capacity=64, r=3, max_resalt=64, max_chain=4096)
SERVING = Launch(1 << 20, 1024, 4, omega=16, capacity=1024, r=16, max_resalt=1, max_chain=8)
WIDE = Launch(1 << 24, 1056, 8, omega=16, capacity=65536)


def test_every_bounded_loop_is_counted_once():
    assert FINDINGS == []
    tagged = [lp for p in PATHS for lp in sass_gate.source_loops(p) if lp.bound != "static"]
    assert sorted((lp.file, lp.first) for lp in tagged) == sorted((c.file, c.line) for c in LOOPS)
    assert [c.name for c in LOOPS] == NAMES and len(LOOPS) == 29
    assert {c.tag for c in LOOPS} == set(BOUNDS) - {"static"}


def test_every_counter_is_declared_before_its_loop_tag():
    """``CT_TRIPS(<name>)`` stands before each counted loop's tag (so the
    counter outlives the loop and records on every exit) and
    ``CT_TRIP(<name>)`` opens its body."""
    for c in LOOPS:
        lines = (build.CSRC / c.file).read_text().splitlines()
        above = [no for no, line in enumerate(lines[:c.line - 1], 1)
                 if f"CT_TRIPS({c.name})" in line]
        assert len(above) == 1, c
        between = lines[above[0]:c.line - 1]
        assert all(line.lstrip().startswith(("//", "#pragma", "CT_KEY_STEPS")) for line in between), c
        head = "\n".join(lines[c.line - 1:c.line + 2])  # a loop head may take two lines
        assert f"{{\n    CT_TRIP({c.name});" in re.sub(r"\n\s*", "\n    ", head), c


def test_the_counters_are_compiled_out_of_the_shipping_build():
    text = (build.CSRC / "routing.cuh").read_text()
    shipping = text.split("#ifdef ROUTING_COUNT_TRIPS", 1)[1].split("#else", 1)[1].split("#endif")[0]
    assert re.findall(r"#define (\w+)\([^)]*\)(.*)", shipping) == [
        ("CT_TRIPS", ""), ("CT_TRIP", ""), ("CT_KEY_STEPS", ""), ("CT_STEPS", "")]
    assert "-DROUTING_COUNT_TRIPS" in build.COUNT_FLAGS
    assert "-DROUTING_COUNT_TRIPS" not in build.NVCC_FLAGS
    assert build._digest(build.COUNT_FLAGS) != build._digest()


def test_an_uncounted_loop_is_found(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("enum TripLoop : int { A, B, C, TRIP_LOOPS };\n"
                   "CT_TRIPS(A);\n"
                   "// ct-loop: chunk: counted\n"
                   "for (int i = 0; i < n; ++i) {\n  CT_TRIP(A);\n}\n"
                   "// ct-loop: grid: not counted\n"
                   "for (int j = 0; j < n; ++j) {\n}\n"
                   "CT_TRIPS(B);\n"
                   "// ct-loop: static: never counted\n"
                   "for (int k = 0; k < 4; ++k) {\n  CT_TRIP(B);\n}\n"
                   "// ct-loop: r: a counter with no declaration\n"
                   "for (int m = 0; m < r; ++m) {\n  CT_TRIP(C);\n}\n")
    loops, bad = sass_gate.counted_loops([src])
    assert [c.name for c in loops] == ["A"]
    assert bad == ["k.cu:17: CT_TRIP(C) with no CT_TRIPS(C) before it",
                   "k.cu:8: a grid loop with 0 CT_TRIP counters",
                   "k.cu:12: a static loop counted (['B'])",
                   "k.cu:16: a r loop with 0 CT_TRIP counters",
                   "TripLoop B counts no loop", "TripLoop C counts no loop"]


def test_every_tag_has_a_formula_of_the_launch():
    for tag, bound in BOUNDS.items():
        assert isinstance(bound.text, str) and bound.text
        assert isinstance(bound.trips(CONTRACT), int), tag
    assert set(sass_gate.LOOP_BOUNDS) == {"JUMP_CHAINS", "PLACE_GRID", "NODE_GRID"}
    assert set(sass_gate.KEY_STEPS) == {"omega", "max_chain"} == {
        c.tag for c in LOOPS if c.tag in sass_gate.KEY_STEPS}


@pytest.mark.parametrize("launch, want", [
    # omega, chunk, grid, capacity, r, max_resalt, max_chain; jump chains
    (CONTRACT, dict(omega=15, chunk=1, grid=1, capacity=1, r=3, max_resalt=64, max_chain=4096,
                    jump=7)),
    (SERVING, dict(omega=15, chunk=4, grid=1, capacity=4, r=16, max_resalt=1, max_chain=8,
                   jump=19)),
    (WIDE, dict(omega=15, chunk=8, grid=8, capacity=256, r=0, max_resalt=0, max_chain=0,
                jump=35)),
], ids=["contract", "serving", "2^24"])
def test_formulas_give_the_hand_derived_bounds(launch, want):
    got = {tag: BOUNDS[tag].trips(launch) for tag in want if tag != "jump"}
    got["jump"] = jump_chain_trips(launch)
    assert got == want
    # resolve: one key a thread (items 1), so the grid bound is n over the threads
    resolve = Launch(1 << 20, 512, 1)
    assert BOUNDS["grid"].trips(resolve) == -(-(1 << 20) // (512 * sass_gate.THREADS)) == 8


@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("objects, grid", [(1, 1), (85, 1), (86, 1), (4097, 3), (1 << 20, 1024)])
def test_place_grid_bound_is_the_busiest_warps_chunks(r, objects, grid):
    """``place_kernel``'s chunk loop: warp w of the grid takes the chunks of
    ⌊256 / r⌋ whole objects starting at w, w + grid x WARPS, ...; the bound
    is the busiest warp's count, and no chunk holds more than 256 family
    keys (32 x items)."""
    per = 32 * sass_gate.MAX_ITEMS // r
    assert per * r <= 32 * sass_gate.MAX_ITEMS < (per + 1) * r
    warps = grid * sass_gate.WARPS
    chunks = -(-objects // per)
    busiest = max(len(range(w, chunks, warps)) for w in range(min(warps, chunks)))
    launch = Launch(objects * r, grid, sass_gate.MAX_ITEMS, r=r)
    assert sass_gate.place_grid_trips(launch) == busiest


def _lane_refill_trips(key_trips: list) -> int:
    """Trips of jump_chains' loop over one chunk: 32 lanes, each taking the
    chunk's next key in the trip its key's chain ends."""
    left = [key_trips[i] if i < len(key_trips) else 0 for i in range(32)]
    cursor, trips = 32, 0
    while any(left):
        trips += 1
        for lane in range(32):
            if left[lane]:
                left[lane] -= 1
                if not left[lane] and cursor < len(key_trips):
                    left[lane], cursor = key_trips[cursor], cursor + 1
    return trips


@pytest.mark.parametrize("omega", [1, 4, 5, 16])
@pytest.mark.parametrize("items", [1, 3, 8])
def test_jump_chain_bound_holds_under_lane_refill(omega, items):
    """Each key's chain takes g go steps (0 <= g <= ω) and ends in the trip
    of its step min(g + 1, ω), four steps a trip; however its keys' chains
    fall, the chunk's loop stays within ``jump_chain_trips``, and the
    worst case reaches it where a chunk's keys fill the lanes evenly."""
    rng = np.random.default_rng(omega * 10 + items)
    bound = jump_chain_trips(Launch(32 * items, 1, items, omega=omega))
    most = 0
    for trial in range(300):
        count = int(rng.integers(1, 32 * items + 1)) if trial % 3 else 32 * items
        go = rng.integers(0, omega + 1, size=count)
        if trial % 5 == 0:  # one long chain last: the list schedule's tail
            go[:-1] = rng.integers(0, 4, size=count - 1)
            go[-1] = omega
        trips = [-(-min(g + 1, omega) // 4) for g in go]
        most = max(most, _lane_refill_trips(trips))
    assert most <= bound
    full = _lane_refill_trips([-(-omega // 4)] * (32 * items))
    assert full == items * -(-omega // 4) <= bound


def _runs(**trips) -> list:
    """One healthy and one storm run of a route launch at the serving
    fleet's shape, each loop at the given trips (steps = trips + 1 for the
    binomial loop)."""
    out = []
    for storm in (False, True):
        counts = dict.fromkeys(NAMES, 0) | {k: v for k, v in trips.items() if k in NAMES}
        steps = dict.fromkeys(NAMES, 0) | {"BINOMIAL_REST": counts["BINOMIAL_REST"] + 1}
        out.append(TripRun("route", "serving 1000/1024", storm, SERVING, counts, steps, True))
    return out


def _binomial():
    return [c for c in LOOPS if c.engine in ("binomial", "both") and c.name in
            ("BINOMIAL_REST", "BINOMIAL_QUEUE", "CHUNKS")]


def test_counts_at_the_bound_pass_and_one_over_fails():
    loops = _binomial()
    check, table = sass_gate.bounded_check(_runs(BINOMIAL_REST=15, BINOMIAL_QUEUE=4, CHUNKS=1),
                                           loops)
    assert check.status == PASS, check.detail
    assert "seeded omega = 4 bounds fail ['BINOMIAL_REST']" in check.detail
    rows = {(r["name"], r["counts"]): r for r in table}
    assert rows["BINOMIAL_QUEUE", "trips"]["bound"] == 4
    assert rows["BINOMIAL_QUEUE", "trips"]["storm_ratio"] == 1.0
    assert rows["BINOMIAL_REST", "steps"]["healthy"] == 16
    assert any("BINOMIAL_QUEUE" in row for row in render_trip_table(table))
    for name, over in (("BINOMIAL_QUEUE", 5), ("CHUNKS", 2), ("BINOMIAL_REST", 16)):
        counts = dict(BINOMIAL_REST=15, BINOMIAL_QUEUE=4, CHUNKS=1) | {name: over}
        check, _ = sass_gate.bounded_check(_runs(**counts), loops)
        assert check.status == FAIL and f"{name} trips {over} > bound" in check.detail


def test_a_loop_never_entered_fails():
    check, _ = sass_gate.bounded_check(_runs(BINOMIAL_REST=15, BINOMIAL_QUEUE=0, CHUNKS=1),
                                       _binomial())
    assert check.status == FAIL and "never entered" in check.detail and "BINOMIAL_QUEUE" in check.detail


def test_outputs_that_differ_from_the_shipping_build_fail():
    runs = _runs(BINOMIAL_REST=15, BINOMIAL_QUEUE=4, CHUNKS=1)
    runs[1] = dataclasses.replace(runs[1], same=False)
    check, _ = sass_gate.bounded_check(runs, _binomial())
    assert check.status == FAIL and "outputs differ from the shipping build" in check.detail


def test_counters_that_miss_the_seeded_violation_fail():
    """With at most 3 trips of the binomial loop the seeded ω = 4 bounds
    pass, which says the counters did not reach a key that went further."""
    check, _ = sass_gate.bounded_check(_runs(BINOMIAL_REST=3, BINOMIAL_QUEUE=4, CHUNKS=1),
                                       _binomial())
    assert check.status == FAIL and "the counters do not reach them" in check.detail


def _chain_runs(steps: int, max_chain: int) -> list:
    launch = Launch(1 << 20, 1024, 4, max_chain=max_chain)
    counts = dict.fromkeys(NAMES, 0) | {"CHAIN_WALK": 500, "CHAIN_SCAN": 1}
    walked = dict.fromkeys(NAMES, 0) | {"CHAIN_WALK": steps}
    return [TripRun("chain_remap", "chain 90% failed", True, launch, counts, walked, True)]


def test_the_chain_walk_is_waived_only_within_max_chain():
    loops = [c for c in LOOPS if c.engine == "chain"]
    check, table = sass_gate.bounded_check(_chain_runs(8, 8), loops, waiver="bounded by max_chain")
    assert check.status == WAIVED and check.waiver == "bounded by max_chain"
    assert [(r["name"], r["counts"], r["bound"], r["storm"]) for r in table] == [
        ("CHAIN_WALK", "steps", 8, 8), ("CHAIN_SCAN", "trips", 1, 1)]
    over, _ = sass_gate.bounded_check(_chain_runs(9, 8), loops, waiver="bounded by max_chain")
    assert over.status == FAIL and "CHAIN_WALK steps 9 > bound 8" in over.detail
    unwaived, _ = sass_gate.bounded_check(_chain_runs(8, 8), loops)
    assert unwaived.status == FAIL and "no waiver reason" in unwaived.detail


def test_on_the_cpu_the_check_is_skipped_with_its_reason():
    for gate in sass_gate.gate_all(["binomial"], "cpu"):
        (check,) = [c for c in gate.checks if c.invariant == "sass-loops-bounded"]
        assert check.status == SKIPPED and check.detail == sass_gate.CPU_SKIP
        assert gate.trips == []
