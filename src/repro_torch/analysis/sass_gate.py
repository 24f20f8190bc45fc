"""Layer 3 — the SASS gate: certify the *compiled* kernels (DESIGN.md §11),
the counterpart of the JAX package's HLO gate (``repro.analysis.hlo_gate``).

Layer 1 proves the wrappers' glue is constant-time; a kernel's own loops
are machine code that no dispatch mode sees.  This layer reads them.  The
kernel library (``kernels.build.library``) is disassembled with
``cuobjdump -sass``; a second build of the same sources with the same code
generation flags, as a ``-cubin -lineinfo`` (``kernels.build.cubin``), is
disassembled with ``nvdisasm --print-line-info``, and must give the
library's SASS instruction for instruction, so its line info describes the
code that launches.  Four checks per engine:

``sass-loops-declared``
    Every back edge (``repro_torch.analysis.sass``) of every kernel function
    of the engine is classified on the function's control-flow graph.  A
    natural loop must map, through its source line, to a loop of
    ``csrc/routing.cu`` / ``routing.cuh`` tagged ``// ct-loop: <bound>``
    with a bound of ``BOUNDS``; an untagged loop fails.  The compiler's own
    back edges are handled explicitly, never matched to a tag:
    - a *rejoin* (the out-of-line divergent path of a warp vote, reached
      only through ``BRA.DIV``, jumping back into the body) is a jump, not
      a loop: counted, and passed;
    - a *pad* (the unreachable self-branch after the last ``EXIT``) never
      runs: counted, and passed;
    - a call (``CALL.REL``) to a subroutine such as the IEEE division's slow
      path (``__cuda_sm3x_div_rn_noftz_f32_slowpath``) or the 64-bit
      division is a call, not a loop; the subroutine's own back edges are
      classified like the body's, and one whose line lies outside the
      kernel sources fails;
    - an inlined device function (``Binomial::rest``, ``jump_chains``)
      carries the innermost source location in the line info, so its loops
      map to their own lines (``routing.cuh:66``).
    The chain remap's walk (``max_chain``) is the one data-bounded loop:
    its function is reported on its own (engine ``chain``) and passes as
    ``waived``, with the chain baseline's reason, as in layer 1; a
    ``max_chain`` loop with no reason given fails.
    The check proves that every loop of the compiled code is *declared*:
    it comes from a source loop whose tag names a bound; the next check
    measures the bound.
``sass-loops-bounded``
    The counterpart of the JAX package's ``hlo-while-static``: where the
    reference proves each loop's trip count static, this proves each
    loop's trips stay within a bound that is a function of the launch
    alone (``BOUNDS``' formulas of the key count, the launch's grid and
    items, ω, the capacity, r, ``max_resalt`` and ``max_chain``; the jump
    chains' lane-refilling loop has its own, ``jump_chain_trips``).  The
    counting build of the same sources (``kernels.build.counting``) keeps
    every counted loop's largest trips of one entry, and for the ``omega``
    and ``max_chain`` loops the most steps of one key, in a device array;
    ``analysis.trips`` runs every kernel instance on it over the contract's
    fleets, the serving fleet, chain-mode fleets up to 90 % failed, r = 3
    and 16 and a too-small ``max_resalt``, n = 1, 1025 and 2^31 - 1, and
    capacity 65,536, each launch beside the shipping build's.  It fails on
    a count over its bound, a loop no run entered, an output that differs
    from the shipping build's, and a seeded run whose bounds, evaluated at
    ω = ``SEED_OMEGA``, fail no ``omega`` loop.  The chain remap's walk
    passes as ``waived`` only while every key's steps stay within
    ``max_chain``.  ``bounded_check`` gives the loop table the report
    carries (``SassGateResult.trips``).
``sass-severity-flat``
    A healthy fleet and a storm fleet (0 and capacity/2 removals at the
    contract's capacity; on the card also the serving fleet, 1000 of 1024
    with 0 and 250 failed, at 2^20 keys) give each fleet-reading path the
    same recorded ops, the same launches and, on the card, the same launch
    shapes: the (grid, items) of each launch, as the library logged them
    where it launched (``take_launches``).  On the CPU the paths run their
    plain versions, and the chain path is left out: its plain walk is the
    waived loop itself.  This holds the host side flat (what is launched,
    and how wide); the trips of a kernel's own loops follow the keys and the
    fleet within their bounds, which ``sass-loops-bounded`` counts.
``sass-op-budget``
    Each function's static SASS size stays within ``MAX_SASS``.

With ``device="cpu"`` the checks that read SASS are ``skipped`` with the
reason; the severity check runs on the plain versions.  On the card a
missing ``nvcc``, ``cuobjdump`` or ``nvdisasm`` fails the gate, naming it.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import re
import subprocess
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.analysis import sass
from repro_torch.analysis.certify import EngineContract, contract_for, record
from repro_torch.analysis.report import FAIL, PASS, SKIPPED, WAIVED, CheckResult, SassGateResult

#: each kernel function's mangled name, up to its parameters, by (engine,
#: kind); ``resolve`` and ``chain_remap`` are one function for both engines
FUNCTIONS = {
    (engine, kind): name.format(E=mangled)
    for engine, mangled in (("binomial", "8Binomial"), ("jump", "4Jump"))
    for kind, name in (
        ("route", "_ZN7routing12route_kernelINS_{E}ENS_9KeySourceEEEv"),
        ("ingest", "_ZN7routing12route_kernelINS_{E}ENS_8IdSourceEEEv"),
        ("lookup_dyn", "_ZN7routing17lookup_dyn_kernelINS_{E}EEEv"),
        ("lookup_vec", "_ZN7routing17lookup_vec_kernelINS_{E}ENS_9KeySourceEEEv"),
        ("lookup_router", "_ZN7routing17lookup_vec_kernelINS_{E}ENS_15RouterKeySourceEEEv"),
        ("route_family", "_ZN7routing12route_kernelINS_{E}ENS_15FamilyKeySourceEEEv"),
        ("resolve", "_ZN7routing14resolve_kernelE"),
        ("resolve_rows", "_ZN7routing19resolve_rows_kernelE"),
        ("route_load", "_ZN7routing17route_load_kernelINS_{E}ELb1EEEv"),
        ("route_load_global", "_ZN7routing17route_load_kernelINS_{E}ELb0EEEv"),
        ("chain_remap", "_ZN7routing18chain_remap_kernelE"),
        ("place", "_ZN7routing12place_kernelINS_{E}EEEv"),
        ("node_route", "_ZN7routing17node_route_kernelINS_{E}EEEv"),
    )
}

#: the kernels' launch constants (routing.cu): threads and warps a block,
#: keys a lane of a warp's chunk, the resolve's register columns
THREADS, WARPS, MAX_ITEMS, MAX_R = 256, 8, 8, 8


@dataclasses.dataclass(frozen=True)
class Launch:
    """What a counted loop's bound may read: one launch's parameters, never
    its keys or its fleet's failures.

    n             the launch's keys (a family route and place: N x r; a
                  router call: tokens x top_k; resolve: N, one thread a key)
    grid, items   the launch's shape, as the library logged it (resolve:
                  items 1; its row path, r > 8: the keys a warp takes;
                  place: MAX_ITEMS, a chunk holding the whole objects
                  whose family keys fit in 32 x items)
    omega         the lookup's unroll bound
    capacity      the fleet's slot space (the histogram's bins)
    r, max_resalt the placement's replication factor and probe bound
    max_chain     the chain walk's rejection bound
    """

    n: int
    grid: int
    items: int
    omega: int = 0
    capacity: int = 0
    r: int = 0
    max_resalt: int = 0
    max_chain: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Bound:
    """A ct-loop tag's bound: its text, and the largest count of trips of
    one entry of such a loop, as a formula of the launch."""

    text: str
    trips: Callable[[Launch], int]


#: what a ``// ct-loop: <bound>`` tag may name: each loop's trips are
#: bounded by one of these.  Each formula is the tightest bound the tag's
#: loops allow, read from their code in routing.cu / routing.cuh:
#: - omega: ``Binomial::rest`` runs the lookup's trips 1 .. ω - 1 (the first
#:   is ``first_trip``), so ω - 1 trips, and a key takes at most ω steps;
#: - chunk: a warp's chunk holds at most 32 x items keys, and each chunk
#:   loop walks them (or the queued ones among them) 32 a trip: items trips;
#: - grid: the warp's chunks of 32 x items keys, one stride of the grid's
#:   warps apart: ⌈⌈n / (32 items)⌉ / (grid x WARPS)⌉ trips (resolve, one
#:   key a thread and items 1: ⌈n / (grid x THREADS)⌉);
#: - capacity: the block's bins, THREADS a trip: ⌈capacity / THREADS⌉;
#: - r: a key's columns, at most r (``taken_row`` compares at most r - 1);
#:   the row path's staging and write-back and ``place``'s write-back walk a
#:   span of at most 32 rows, 32 words a trip: ⌈32 r / 32⌉ = r trips;
#: - max_resalt: at most max_resalt probes a column;
#: - max_chain: a walked key takes at most max_chain steps (the count held
#:   is each key's steps; the loop's trips follow its keys' walks);
#: - static: a compile-time count, unrolled, so no back edge and nothing
#:   counted; the largest such count in the sources.
BOUNDS = {
    "omega": Bound("the lookup's unroll bound ω (per key)", lambda L: L.omega - 1),
    "chunk": Bound("a warp's chunk: at most 32 x MAX_ITEMS keys", lambda L: L.items),
    "grid": Bound("the launch's grid-stride walk: n over the resident grid",
                  lambda L: _cdiv(_cdiv(L.n, 32 * L.items), L.grid * WARPS)),
    "capacity": Bound("the fleet's capacity (histogram bins)",
                      lambda L: _cdiv(L.capacity, THREADS)),
    "r": Bound("the replication factor", lambda L: L.r),
    "max_resalt": Bound("the placement's probe bound", lambda L: L.max_resalt),
    "max_chain": Bound("the chain walk's rejection bound", lambda L: L.max_chain),
    "static": Bound("a compile-time count, unrolled", lambda L: max(MAX_ITEMS, MAX_R, 4)),
}


def jump_chain_trips(launch: Launch) -> int:
    """The trips of ``jump_chains``' warp loop (routing.cu), which refills
    its lanes.  Each lane runs one key's chain, four steps a trip, and
    takes the chunk's next key in the trip its chain ends; a key takes at
    most ω steps, so at most P = ⌈ω / 4⌉ trips.  The lanes are 32 machines
    taking the chunk's keys in order as each frees: the key that ends last
    started once all 32 lanes had been busy on the other keys' trips, so
    the loop runs T <= (W - p) / 32 + p trips, W the keys' total trips and
    p <= P the last key's.  With count <= 32 x items keys, W <= count x P:
    T <= (count + 31) P / 32 <= (32 items + 31) P / 32."""
    return (32 * launch.items + 31) * _cdiv(launch.omega, 4) // 32


def place_grid_trips(launch: Launch) -> int:
    """The trips of ``place_kernel``'s and ``node_route_kernel``'s chunk
    loops (routing.cu): a chunk holds ⌊32 items / r⌋ whole objects, so that
    no object's r columns straddle two warps, and the n / r objects take
    ⌈(n / r) / ⌊32 items / r⌋⌉ chunks, one resident grid's warps apart."""
    return _cdiv(_cdiv(launch.n // launch.r, 32 * launch.items // launch.r),
                 launch.grid * WARPS)


#: counted loops whose trips take a bound of their own, beside their tag's
LOOP_BOUNDS = {"JUMP_CHAINS": jump_chain_trips, "PLACE_GRID": place_grid_trips,
               "NODE_GRID": place_grid_trips}

#: tags whose loops also record each key's steps, and the steps' bound
KEY_STEPS = {"omega": lambda L: L.omega, "max_chain": lambda L: L.max_chain}

#: bounds that follow the data rather than the launch: passed only as waived
WAIVED_BOUNDS = {"max_chain"}

#: per-function static SASS budget (generous: the largest function, the
#: binomial ingest route, is 1,968 instructions in the sm_90a build)
MAX_SASS = 4096

#: the serving fleet of the card's severity check: n, capacity, failed, keys
SERVING_FLEET = (1000, 1024, 250, 1 << 20)

_LOOP = re.compile(r"\b(for|while)\s*\(")
_TAG = re.compile(r"//\s*ct-loop:\s*([a-z_]+)")


# ---------------------------------------------------------------------------
# the source's loops and their tags
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SourceLoop:
    file: str   # the source's file name, e.g. "routing.cu"
    first: int  # the line of its `for` / `while`
    last: int   # the line its body ends on
    bound: str  # its tag's bound, "" if untagged


def _blank_comments(text: str) -> str:
    """The source with comments and literals blanked (newlines kept), so
    that offsets still give lines."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i) + 2
        elif text[i] in "\"'":
            j = i + 1
            while j < n and text[j] != text[i]:
                j += 2 if text[j] == "\\" else 1
            j += 1
        else:
            i += 1
            continue
        for k in range(i, j):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


def _match(code: str, i: int, open_: str, close: str) -> int:
    """Offset of the bracket closing the one at ``i``."""
    depth = 0
    for k in range(i, len(code)):
        if code[k] == open_:
            depth += 1
        elif code[k] == close:
            depth -= 1
            if depth == 0:
                return k
    raise ValueError(f"unbalanced {open_}{close} from offset {i}")


def source_loops(path: Path) -> list:
    """Every ``for`` / ``while`` loop of a CUDA source with its line extent
    and its tag: a ``// ct-loop: <bound>`` comment on the loop's line or on
    the comment and ``#pragma`` lines directly above it."""
    text = path.read_text()
    lines = text.splitlines()
    code = _blank_comments(text)
    loops = []
    for m in _LOOP.finditer(code):
        head = code.index("(", m.start())
        end = _match(code, head, "(", ")") + 1
        k = end
        while code[k].isspace():
            k += 1
        stop = _match(code, k, "{", "}") if code[k] == "{" else code.index(";", k)
        first = code.count("\n", 0, m.start()) + 1
        tags = _TAG.findall(lines[first - 1])
        above = first - 2
        while above >= 0 and lines[above].lstrip().startswith(("//", "#pragma")):
            tags += _TAG.findall(lines[above])
            above -= 1
        loops.append(SourceLoop(path.name, first, code.count("\n", 0, stop) + 1,
                                tags[0] if tags else ""))
    return loops


def tag_findings(paths: Iterable[Path]) -> list:
    """What is wrong with the tags of the sources: untagged loops, unknown
    bounds, and tags that sit on no loop (empty = every loop declared)."""
    out = []
    for path in paths:
        loops = source_loops(path)
        for lp in loops:
            if not lp.bound:
                out.append(f"{path.name}:{lp.first}: loop without a ct-loop tag")
            elif lp.bound not in BOUNDS:
                out.append(f"{path.name}:{lp.first}: unknown bound {lp.bound!r}")
        tagged = {lp.first for lp in loops if lp.bound}
        lines = path.read_text().splitlines()
        for no, line in enumerate(lines, 1):
            if not _TAG.search(line):
                continue
            k = no
            while k <= len(lines) and lines[k - 1].lstrip().startswith(("//", "#pragma")):
                k += 1
            if no not in tagged and k not in tagged:
                out.append(f"{path.name}:{no}: ct-loop tag on no loop")
    return out


@dataclasses.dataclass(frozen=True)
class CountedLoop:
    """A loop the counting build counts: its ``TripLoop`` name and index
    (routing.cuh), its source loop's file and line, and its tag."""

    name: str
    index: int
    file: str
    line: int
    tag: str

    @property
    def where(self) -> str:
        return f"{self.file}:{self.line}"

    @property
    def engine(self) -> str:
        """Whose kernels hold it: "binomial", "jump", "chain" (the chain
        remap), or "both"."""
        head = self.name.split("_")[0]
        return {"BINOMIAL": "binomial", "JUMP": "jump", "CHAIN": "chain"}.get(head, "both")


_ENUM = re.compile(r"enum\s+TripLoop\s*:\s*int\s*\{([^}]*)\}")
_COUNTS = re.compile(r"\bCT_TRIP\((\w+)\)")
_DECLARES = re.compile(r"\bCT_TRIPS\((\w+)\)")


def trip_loop_names(paths: Iterable[Path]) -> list:
    """The ``TripLoop`` enumerators in order (the counters' indices), the
    closing ``TRIP_LOOPS`` left out."""
    for path in paths:
        m = _ENUM.search(_blank_comments(path.read_text()))
        if m:
            names = [x.strip() for x in m.group(1).split(",") if x.strip()]
            return names[:-1] if names[-1] == "TRIP_LOOPS" else names
    raise ValueError("no `enum TripLoop` in the kernel sources")


def counted_loops(paths: Iterable[Path]) -> tuple:
    """``(loops, findings)``: each counted loop (the source loop holding a
    ``CT_TRIP(<name>)`` as its innermost loop), and what is wrong with the
    counting: a loop whose tag is not ``static`` with no counter or two, a
    counted ``static`` loop, a counter on no loop or with no ``CT_TRIPS``
    declaring it before, a name not in ``TripLoop`` or counted twice, and a
    ``TripLoop`` name that counts no loop (empty = every bounded loop
    counted once)."""
    paths = list(paths)
    names = trip_loop_names(paths)
    found, bad = {}, []
    for path in paths:
        loops = source_loops(path)
        rows = _blank_comments(path.read_text()).splitlines()
        declared = {}
        sites = collections.defaultdict(list)
        for no, row in enumerate(rows, 1):
            if row.lstrip().startswith("#"):
                continue  # the macros' own definitions
            for m in _DECLARES.finditer(row):
                declared.setdefault(m.group(1), no)
            for m in _COUNTS.finditer(row):
                name = m.group(1)
                lp = innermost(loops, path.name, no)
                if lp is None:
                    bad.append(f"{path.name}:{no}: CT_TRIP({name}) outside any loop")
                elif declared.get(name, no) >= no:
                    bad.append(f"{path.name}:{no}: CT_TRIP({name}) with no CT_TRIPS({name}) "
                               "before it")
                else:
                    sites[lp].append(name)
        for lp in loops:
            counted = sites.get(lp, [])
            if lp.bound == "static":
                if counted:
                    bad.append(f"{path.name}:{lp.first}: a static loop counted ({counted})")
                continue
            if len(counted) != 1:
                bad.append(f"{path.name}:{lp.first}: a {lp.bound or 'untagged'} loop with "
                           f"{len(counted)} CT_TRIP counters")
                continue
            (name,) = counted
            if name not in names:
                bad.append(f"{path.name}:{lp.first}: CT_TRIP({name}) is not a TripLoop")
            elif name in found:
                bad.append(f"{path.name}:{lp.first}: {name} counts a second loop "
                           f"({found[name].where})")
            else:
                found[name] = CountedLoop(name, names.index(name), path.name, lp.first, lp.bound)
    bad += [f"TripLoop {name} counts no loop" for name in names if name not in found]
    return sorted(found.values(), key=lambda c: c.index), bad


def innermost(loops: list, file: str, line: int) -> Optional[SourceLoop]:
    """The innermost source loop of ``file`` whose extent holds ``line``."""
    holding = [lp for lp in loops if lp.file == file and lp.first <= line <= lp.last]
    return min(holding, key=lambda lp: lp.last - lp.first) if holding else None


# ---------------------------------------------------------------------------
# the compiled kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FunctionLoops:
    """One kernel function's back edges, classified and mapped."""

    name: str
    size: int
    loops: list = dataclasses.field(default_factory=list)  # (file:line, bound)
    undeclared: list = dataclasses.field(default_factory=list)  # what fails
    rejoins: int = 0
    pads: int = 0
    calls: int = 0

    def bounds(self) -> dict:
        return dict(collections.Counter(b for _, b in self.loops))


def map_loops(fn: sass.Function, loops: list, sources: Iterable[str]) -> FunctionLoops:
    """Classify ``fn``'s back edges and map each loop to its tagged source
    loop (``loops``, of the files named in ``sources``)."""
    out = FunctionLoops(fn.name, fn.size)
    out.calls = sum(i.op == "CALL" for i in fn.instructions)
    for ins, kind in sass.classify(fn):
        where = f"{Path(ins.file).name}:{ins.line}" if ins.file else "no line info"
        if kind == "rejoin":
            out.rejoins += 1
        elif kind == "pad":
            out.pads += 1
        elif kind != "loop":
            out.undeclared.append(f"{ins.address:#06x} {ins.text} ({where}): {kind} back edge")
        elif Path(ins.file).name not in sources:
            out.undeclared.append(f"{ins.address:#06x} loop at {where}, outside the kernel sources")
        else:
            lp = innermost(loops, Path(ins.file).name, ins.line)
            if lp is None or not lp.bound:
                out.undeclared.append(f"{ins.address:#06x} loop at {where}: no tagged loop holds it")
            else:
                out.loops.append((where, lp.bound))
    return out


def _run(cmd: list) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


@functools.cache
def library_sass() -> dict:
    """The kernel library's SASS (``cuobjdump -sass``), parsed: ``{function
    name: sass.Function}``."""
    from repro_torch.kernels import build

    return sass.parse(_run([build.cuda_tool("cuobjdump"), "-sass", str(build.build())]))


@functools.cache
def compiled() -> dict:
    """``{function name prefix: FunctionLoops}`` of the built kernels, after
    checking that the line-info cubin's SASS is the library's, and the
    source's tags.  Raises ``RuntimeError`` where a build or tool fails or
    the two builds differ."""
    from repro_torch.kernels import build

    lib, cub = build.build(), build.cubin()
    cuobjdump, nvdisasm = build.cuda_tool("cuobjdump"), build.cuda_tool("nvdisasm")
    in_lib = library_sass()
    in_cubin = sass.parse(_run([cuobjdump, "-sass", str(cub)]))
    lined = sass.parse(_run([nvdisasm, "--print-line-info", str(cub)]))
    paths = [build.CSRC / name for name in build.SOURCES]
    bad = tag_findings(paths)
    if bad:
        raise RuntimeError("the kernel sources' loop tags: " + "; ".join(bad))
    loops = [lp for p in paths for lp in source_loops(p)]
    out = {}
    for prefix in sorted(set(FUNCTIONS.values())):
        names = [n for n in in_lib if n.startswith(prefix)]
        if len(names) != 1:
            raise RuntimeError(f"{len(names)} functions named {prefix}... in {lib.name}")
        name = names[0]
        a, b, c = in_lib[name], in_cubin.get(name), lined.get(name)
        if b is None or c is None:
            raise RuntimeError(f"{name} is missing from the line-info build {cub.name}")
        if [i.normalized() for i in a.instructions] != [i.normalized() for i in b.instructions]:
            raise RuntimeError(f"{name}: the -lineinfo cubin's SASS differs from the library's")
        if [(i.address, i.normalized()) for i in b.instructions] != [
                (i.address, i.normalized()) for i in c.instructions]:
            raise RuntimeError(f"{name}: nvdisasm and cuobjdump disagree on the cubin")
        out[prefix] = map_loops(c, loops, build.SOURCES)
    return out


def loop_table(kinds: Iterable[tuple]) -> dict:
    """``{"kind[engine]": FunctionLoops}`` for the given (engine, kind)
    keys of ``FUNCTIONS`` (builds and disassembles on first use)."""
    found = compiled()
    return {f"{k}[{e}]": found[FUNCTIONS[e, k]] for e, k in kinds}


def _loops_check(table: dict, waiver: str = "") -> CheckResult:
    undeclared = [f"{key}: {u}" for key, fl in table.items() for u in fl.undeclared]
    parts = []
    for key, fl in table.items():
        bounds = ", ".join(f"{b} x{n}" for b, n in sorted(fl.bounds().items()))
        parts.append(f"{key} {len(fl.loops)} loops ({bounds}), {fl.rejoins} rejoins, "
                     f"{fl.pads} pads, {fl.calls} calls")
    if undeclared:
        return CheckResult("sass-loops-declared", FAIL,
                           "undeclared back edges: " + "; ".join(undeclared[:8]))
    waived = [key for key, fl in table.items() if set(fl.bounds()) & WAIVED_BOUNDS]
    if waived and not waiver:
        return CheckResult("sass-loops-declared", FAIL,
                           f"data-bounded loops in {waived} and no waiver reason; "
                           + "; ".join(parts))
    if waived:
        return CheckResult("sass-loops-declared", WAIVED,
                           f"data-bounded loops in {waived}; " + "; ".join(parts), waiver=waiver)
    return CheckResult("sass-loops-declared", PASS,
                       "every back edge is a tagged loop or the compiler's own: "
                       + "; ".join(parts))


def _budget_check(table: dict, max_sass: int) -> CheckResult:
    over = {key: fl.size for key, fl in table.items() if fl.size > max_sass}
    sizes = ", ".join(f"{key} {fl.size}" for key, fl in table.items())
    if over:
        return CheckResult("sass-op-budget", FAIL,
                           f"{over} exceed the {max_sass}-instruction budget")
    return CheckResult("sass-op-budget", PASS,
                       f"within the {max_sass}-instruction budget: {sizes}")


# ---------------------------------------------------------------------------
# bounded loops: the counting build's trips against their bounds
# ---------------------------------------------------------------------------

#: the seeded violation: the ω the bounds are evaluated at while the kernels
#: launched at the contract's 16, so that every ω loop must fail
SEED_OMEGA = 4


def _held(loop: CountedLoop) -> list:
    """What is held to a bound for ``loop``: ``(counts, bound(launch))`` for
    its trips (a data-bounded ``max_chain`` loop's trips are not) and, for
    the ``omega`` and ``max_chain`` tags, each key's steps."""
    out = []
    if loop.tag not in WAIVED_BOUNDS:
        out.append(("trips", LOOP_BOUNDS.get(loop.name, BOUNDS[loop.tag].trips)))
    if loop.tag in KEY_STEPS:
        out.append(("steps", KEY_STEPS[loop.tag]))
    return out


def over_bounds(runs: list, loops: list, omega: Optional[int] = None) -> list:
    """``(run, loop, counts, count, bound)`` for each count over its bound
    (``omega``: the bounds evaluated at that ω instead of the launch's); a
    loop a launch did not enter holds nothing on it."""
    out = []
    for run in runs:
        launch = run.launch if omega is None else dataclasses.replace(run.launch, omega=omega)
        for lp in loops:
            for counts, bound in _held(lp):
                got = getattr(run, counts)[lp.name]
                most = bound(launch) if got else 0
                if got > most:
                    out.append((run, lp, counts, got, most))
    return out


def _side(runs: list, lp: CountedLoop, counts: str, storm: bool) -> Optional[tuple]:
    """(largest count, bounds, largest count/bound) over one side's runs of
    a group, or None where the side has no run."""
    bound = dict(_held(lp))[counts]
    side = [(getattr(r, counts)[lp.name], bound(r.launch)) for r in runs if r.storm == storm]
    if not side:
        return None
    return (max(c for c, _ in side), sorted({b for _, b in side}),
            max((c / b if b else float(c > 0)) for c, b in side))


def trip_table(runs: list, loops: list) -> list:
    """The loop table: per counted loop, each count it holds (trips,
    steps), and each fleet group that entered it, its bound on the group's
    launches, the healthy and the storm side's largest count and each
    one's largest ratio to its bound; the kernels that entered it."""
    rows = []
    for lp in loops:
        for counts, _ in _held(lp):
            for group in dict.fromkeys(r.group for r in runs):
                # the group's launches of the kernels that entered the loop
                kinds = {r.kind for r in runs if r.group == group and r.trips[lp.name]}
                mine = [r for r in runs if r.group == group and r.kind in kinds]
                if not mine:
                    continue
                healthy, storm = _side(mine, lp, counts, False), _side(mine, lp, counts, True)
                bounds = sorted({b for side in (healthy, storm) if side for b in side[1]})
                rows.append(dict(
                    loop=lp.where, name=lp.name, tag=lp.tag, counts=counts, fleet=group,
                    bound=bounds[0] if len(bounds) == 1 else f"{bounds[0]}-{bounds[-1]}",
                    healthy=healthy and healthy[0], storm=storm and storm[0],
                    healthy_ratio=healthy and round(healthy[2], 4),
                    storm_ratio=storm and round(storm[2], 4),
                    kernels=sorted({r.kind.split(" ")[0] for r in mine if r.trips[lp.name]})))
    return rows


def bounded_check(runs: list, loops: list, waiver: str = "") -> tuple:
    """``sass-loops-bounded`` over ``runs`` (``analysis.trips``) for the
    counted ``loops`` of one engine: ``(CheckResult, loop table)``.

    Fails where a count exceeds its bound on its launch (a ``max_chain``
    walk's steps too, waiver or not), where a loop records no trip in any
    run, where a run's outputs differ from the shipping build's, and where
    the seeded bounds (``SEED_OMEGA``) fail no ``omega`` loop of the runs
    (the counters would not reach it).  Passes as ``waived`` (with
    ``waiver``) where a loop is ``max_chain``-tagged and all else holds."""
    table = trip_table(runs, loops)
    over = over_bounds(runs, loops)
    silent = [lp.where + f" {lp.name}" for lp in loops
              if not any(r.trips[lp.name] for r in runs)]
    differ = sorted({f"{r.kind} on {r.group}{' storm' if r.storm else ''}"
                     for r in runs if not r.same})
    omega_loops = [lp for lp in loops if lp.tag == "omega"]
    seeded = {lp.name for _, lp, *_ in over_bounds(runs, omega_loops, SEED_OMEGA)}
    unseeded = [lp.name for lp in omega_loops if lp.name not in seeded]
    problems = (
        [f"{r.kind} on {r.group}{' storm' if r.storm else ''}: {lp.where} {lp.name} {counts} "
         f"{got} > bound {most}" for r, lp, counts, got, most in over[:8]]
        + [f"never entered: {', '.join(silent)}"] * bool(silent)
        + [f"outputs differ from the shipping build: {', '.join(differ)}"] * bool(differ)
        + [f"the seeded omega = {SEED_OMEGA} bounds pass {unseeded}: the counters do not "
           "reach them"] * bool(unseeded))
    held = sum(len(_held(lp)) for lp in loops)
    largest = {}  # per loop and count, its largest count/bound
    for r in table:
        key = f"{r['name']} {r['counts']}"
        ratios = [x for x in (r["healthy_ratio"], r["storm_ratio"]) if x is not None]
        largest[key] = max(largest.get(key, 0.0), *ratios)
    summary = (f"{len(loops)} counted loops ({held} counts held) over {len(runs)} launches, "
               f"outputs bit-exact with the shipping build, every loop entered"
               + (f"; seeded omega = {SEED_OMEGA} bounds fail {sorted(seeded)}" if omega_loops
                  else "")
               + "; largest count/bound "
               + ", ".join(f"{key} {ratio:.4f}" for key, ratio in largest.items()))
    if problems:
        return CheckResult("sass-loops-bounded", FAIL, "; ".join(problems)), table
    waived = [lp.name for lp in loops if lp.tag in WAIVED_BOUNDS]
    if waived and not waiver:
        return CheckResult("sass-loops-bounded", FAIL,
                           f"data-bounded loops {waived} and no waiver reason; " + summary), table
    if waived:
        return CheckResult("sass-loops-bounded", WAIVED,
                           f"data-bounded loops {waived} within their bounds; " + summary,
                           waiver=waiver), table
    return CheckResult("sass-loops-bounded", PASS,
                       "every counted loop within its bound on every launch: " + summary), table


def engine_loops(engine: str) -> list:
    """The counted loops the kernel functions of ``engine`` hold ("chain":
    the chain remap's)."""
    from repro_torch.kernels import build

    loops, bad = counted_loops(build.CSRC / name for name in build.SOURCES)
    if bad:
        raise RuntimeError("the kernel sources' trip counters: " + "; ".join(bad))
    if engine == "chain":
        return [lp for lp in loops if lp.engine == "chain"]
    return [lp for lp in loops if lp.engine in (engine, "both")]


# ---------------------------------------------------------------------------
# severity
# ---------------------------------------------------------------------------


def fleet_of(engine: str, n: int, capacity: int, failed, device, chain: bool = False):
    """The device operands of a control plane of ``n`` replicas with the
    slots ``failed`` failed: a ``FleetState`` (table resolution), or with
    ``chain`` a ``ChainFleet`` (chain resolution)."""
    from repro_torch.core.bulk import ChainFleet, FleetState
    from repro_torch.core.registry import make_bulk
    from repro_torch.serving.router import SessionRouter

    scalar = make_bulk(engine).scalar_engine
    plane = (SessionRouter(n, engine=scalar, chain_bits=32) if chain else
             SessionRouter(n, engine=scalar, chain_bits=32, resolve="table", allow_empty=True))
    for b in failed:
        plane.fail(int(b))
    packed = (ChainFleet if chain else FleetState).pack(plane.domain, capacity)
    return packed.to(device)


def _paths(engine: str, fleet, chain, keys, capacity: int, on_card: bool) -> dict:
    """Name -> call for each fleet-reading path of one engine: the call
    routes ``keys`` over ``fleet`` (the chain path over ``chain``, card
    only)."""
    from repro_torch.core.bulk import PlacementSpec, RouterSpec
    from repro_torch.kernels import ops
    from repro_torch.observability.load import LoadConfig

    spec = RouterSpec(engine, capacity, 16)
    counts = torch.zeros(capacity, dtype=torch.int32, device=keys.device)
    pspec = PlacementSpec(spec, r=3)
    shift = LoadConfig().sample_shift
    paths = {
        "route": lambda: ops.route_bulk(keys, fleet, spec),
        "ingest": lambda: ops.route_ingest_bulk(keys, keys, fleet, spec),
        "load_pass": lambda: ops.route_load_bulk(keys, fleet, counts, spec, sample_shift=shift),
        "placement": lambda: ops.route_replicas_bulk(keys, fleet, pspec),
    }
    if on_card:
        paths["chain"] = lambda: ops.route_chain_bulk(keys, chain, spec)
    return paths


#: the launches the library's log keeps (``LOG_LAUNCHES`` in routing.cu)
LOG_LAUNCHES = 16


def clear_launches() -> None:
    """Empty this thread's launch log, however many launches it counted."""
    from repro_torch.kernels import build

    build.library().routing_take_launches(None, 0)


def take_launches() -> list:
    """The (grid, items) of each kernel launch this thread made since the
    last take, read from the library's launch log (``routing_take_launches``,
    written where each kernel is launched), and the log emptied.  Raises if
    more launches were made than the log keeps."""
    from repro_torch.kernels import build

    buf = (ctypes.c_int * (2 * LOG_LAUNCHES))()
    made = build.library().routing_take_launches(buf, LOG_LAUNCHES)
    if made > LOG_LAUNCHES:
        raise RuntimeError(f"{made} launches since the last take; the log keeps {LOG_LAUNCHES}")
    return [(buf[2 * i], buf[2 * i + 1]) for i in range(made)]


def _observe(engine: str, fleet, chain, keys, capacity: int, on_card: bool) -> dict:
    """Name -> (op histogram, launches, launched shapes, synchronising
    calls) of one call of each path; the shapes (grid, items) are those the
    library logged as it launched (card only)."""
    from repro_torch.core.registry import make_bulk

    k = make_bulk(engine).kernels
    out = {}
    for name, call in _paths(engine, fleet, chain, keys, capacity, on_card).items():
        if on_card:
            clear_launches()
        rec = record(call, kernels=[k], sync_check=on_card)
        out[name] = (rec.histogram(), rec.launches, take_launches() if on_card else [], rec.syncs)
    return out


def severity_check(engine: str, contract: EngineContract, device="cpu") -> CheckResult:
    """``sass-severity-flat``: healthy against storm fleets, per path."""
    on_card = torch.device(device).type == "cuda"
    cap = contract.capacity
    cases = [(f"{cap}/{cap}", cap, cap, list(range(1, cap, 2)), contract.batch)]
    if on_card:
        n, cap_s, n_fail, batch = SERVING_FLEET
        failed = np.random.default_rng(2).choice(n - 1, size=n_fail, replace=False)
        cases.append((f"{n}/{cap_s}", n, cap_s, failed, batch))
    diffs, seen = [], []
    for label, n, capacity, failed, batch in cases:
        x = np.random.default_rng(0).integers(0, 2**32, size=batch, dtype=np.uint32)
        keys = torch.from_numpy(x.view(np.int32)).to(device)
        runs = []
        for removed in ([], failed):
            fleet = fleet_of(engine, n, capacity, removed, device)
            chain = fleet_of(engine, n, capacity, removed, device, chain=True) if on_card else None
            runs.append(_observe(engine, fleet, chain, keys, capacity, on_card))
        healthy, storm = runs
        for name in healthy:
            h, s = healthy[name], storm[name]
            if h[3] or s[3]:
                diffs.append(f"{label} {name}: synchronising calls {h[3] + s[3]}")
            elif h != s:
                diffs.append(f"{label} {name}: launches/shapes {h[1:3]} vs {s[1:3]}"
                             + ("" if h[0] == s[0] else " (op histograms differ)"))
            seen.append(f"{label} {name}: {sum(h[0].values())} ops"
                        + (f", launches {h[1]}, launched (grid, items) {h[2]}" if on_card else ""))
    if diffs:
        return CheckResult("sass-severity-flat", FAIL,
                           "healthy vs storm differ — the path specialised on fleet-event "
                           "severity: " + "; ".join(diffs))
    where = "" if on_card else " (plain versions; the chain path's plain walk is the waived loop)"
    return CheckResult("sass-severity-flat", PASS,
                       f"identical across severity{where}: " + "; ".join(seen))


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

CPU_SKIP = ("needs the CUDA build: --device cpu reads no SASS (nvcc, cuobjdump and "
            "nvdisasm run where the kernels are built)")


def bounded(engine: str, device, waiver: str = "") -> tuple:
    """``sass-loops-bounded`` for ``engine`` ("chain": the chain remap) on
    the card: the counting build's runs (``analysis.trips``) held to their
    bounds; ``(CheckResult, loop table)``.  A failed build or launch fails
    the check, naming it."""
    from repro_torch.analysis import trips

    try:
        runs = trips.chain_runs(device) if engine == "chain" else trips.engine_runs(engine, device)
        return bounded_check(runs, engine_loops(engine), waiver)
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        return CheckResult("sass-loops-bounded", FAIL, str(exc)), []


def gate_engine(engine: str, device="cpu", *, max_sass: int = MAX_SASS) -> SassGateResult:
    """The four SASS checks on one engine's kernel functions (all but the
    chain remap, which ``gate_chain`` reports)."""
    contract = contract_for(engine)
    result = SassGateResult(engine=engine)
    if torch.device(device).type != "cuda":
        result.checks = [CheckResult("sass-loops-declared", SKIPPED, CPU_SKIP),
                         CheckResult("sass-loops-bounded", SKIPPED, CPU_SKIP),
                         severity_check(engine, contract, device),
                         CheckResult("sass-op-budget", SKIPPED, CPU_SKIP)]
        return result
    kinds = [(e, k) for e, k in FUNCTIONS if e == engine and k != "chain_remap"]
    try:
        table = loop_table(kinds)
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        table = None
        result.checks.append(CheckResult("sass-loops-declared", FAIL, str(exc)))
    else:
        result.op_count = sum(fl.size for fl in table.values())
        result.checks.append(_loops_check(table))
    check, result.trips = bounded(engine, device)
    result.checks.append(check)
    result.checks.append(severity_check(engine, contract, device))
    result.checks.append(_budget_check(table, max_sass) if table is not None
                         else CheckResult("sass-op-budget", FAIL, result.checks[0].detail))
    return result


def gate_chain(device="cpu", *, max_sass: int = MAX_SASS) -> SassGateResult:
    """The loops and budget of the chain remap (one function for both
    engines): its walk passes as ``waived``, with the chain baseline's
    reason; its severity is the ``chain`` path of each engine's check."""
    from repro_torch.analysis.markers import waivers_of
    from repro_torch.core.memento_torch import memento_remap

    result = SassGateResult(engine="chain")
    if torch.device(device).type != "cuda":
        result.checks += [CheckResult(inv, SKIPPED, CPU_SKIP)
                          for inv in ("sass-loops-declared", "sass-loops-bounded",
                                      "sass-op-budget")]
        return result
    waiver = waivers_of(memento_remap)["while-free"]
    try:
        table = loop_table([("binomial", "chain_remap")])
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        check, result.trips = bounded("chain", device, waiver)
        result.checks += [CheckResult("sass-loops-declared", FAIL, str(exc)), check,
                          CheckResult("sass-op-budget", FAIL, str(exc))]
        return result
    table = {"chain_remap": table["chain_remap[binomial]"]}
    result.op_count = table["chain_remap"].size
    result.checks.append(_loops_check(table, waiver))
    check, result.trips = bounded("chain", device, waiver)
    result.checks.append(check)
    result.checks.append(_budget_check(table, max_sass))
    return result


def gate_all(engines: Optional[Iterable[str]] = None, device="cpu",
             include_chain: bool = True) -> list:
    from repro_torch.core.registry import BULK_ENGINES

    names = list(engines) if engines is not None else sorted(BULK_ENGINES)
    out = [gate_engine(name, device) for name in names]
    if include_chain:
        out.append(gate_chain(device))
    return out
