"""SASS text of the compiled kernels: functions, instructions, their
source lines, and their loops — the counterpart of the loop walker in the
JAX package's ``repro.roofline.hlo_parse``.

``parse`` reads either dump of an sm_90a build:

* ``cuobjdump -sass`` (``Function : <name>`` headers, branch targets as
  addresses), the form the shared library gives;
* ``nvdisasm --print-line-info`` of a ``-cubin -lineinfo`` build
  (``.text.<name>:`` headers, ``.L_x_N:`` / ``$__internal_...:`` labels as
  branch targets, and ``//## File "<path>", line <n>`` before the
  instructions of each source line, the innermost inlined location).

A *back edge* is a branch (``BRA``, ``JMP``) whose target address is at or
below its own.  Not every back edge is a loop, so ``classify`` sorts them
on the function's control-flow graph (immediate dominators):

* ``loop``     the target dominates the branch: a natural loop, which the
               SASS gate maps to a tagged loop of the source;
* ``rejoin``   an out-of-line path the compiler placed after the body (the
               divergent fallback of a warp vote, reached only through
               ``BRA.DIV``) branching back to a point that does not
               dominate it — a jump, not a loop;
* ``pad``      the unreachable self-branch after a function's last
               ``EXIT``, which pads the function and never runs;
* ``unknown``  anything else, which the gate fails.

A subroutine the compiler calls (``CALL.REL`` to ``$__internal_...``, e.g.
the IEEE division's slow path or the 64-bit division) is an entry of its
own: its loops are found the same way, and it returns (``RET.REL``) to its
call site — a call is not a loop.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_CUOBJDUMP_HEAD = re.compile(r"^\s*Function\s*:\s*(\S+)")
_NVDISASM_HEAD = re.compile(r"^\.text\.(\S+):\s*$")
_LABEL = re.compile(r"^(\.L_x_\d+|\$[\w$.]+):\s*$")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LINE = re.compile(r'^\s*//## File "([^"]+)", line (\d+)')
_PRED = re.compile(r"^@!?U?P[T0-9]\s+")
_TARGET_LABEL = re.compile(r"`\(([^)]+)\)")
_TARGET_ADDR = re.compile(r"(?:^|[\s,])(0x[0-9a-f]+)\s*$")

#: opcodes that transfer control to a label or address
BRANCHES = ("BRA", "JMP")


@dataclasses.dataclass
class Instruction:
    address: int
    text: str            # the instruction as dumped, predicate included, no ';'
    file: str = ""       # innermost source location (nvdisasm line info)
    line: int = 0
    target_label: str = ""
    target: Optional[int] = None  # resolved branch/call target

    @property
    def predicated(self) -> bool:
        return bool(_PRED.match(self.text))

    @property
    def opcode(self) -> str:
        """Mnemonic with its modifiers, e.g. ``BRA.DIV``, ``CALL.REL.NOINC``."""
        return _PRED.sub("", self.text).split(None, 1)[0]

    @property
    def op(self) -> str:
        """Mnemonic without modifiers, e.g. ``BRA``."""
        return self.opcode.split(".")[0]

    def normalized(self) -> str:
        """Opcode and operands with the branch target as an address, so the
        two dump formats compare equal."""
        text = _TARGET_LABEL.sub(lambda m: "" if self.target is None else hex(self.target),
                                 self.text)
        return " ".join(text.replace(",", " , ").split())


@dataclasses.dataclass
class Function:
    name: str
    instructions: list = dataclasses.field(default_factory=list)
    labels: dict = dataclasses.field(default_factory=dict)  # label -> address

    @property
    def size(self) -> int:
        return len(self.instructions)

    def back_edges(self) -> list:
        """Every branch whose target address is at or below its own."""
        return [i for i in self.instructions if i.op in BRANCHES and i.target is not None
                and i.target <= i.address]


def parse(text: str) -> dict:
    """Functions of a ``cuobjdump -sass`` or ``nvdisasm`` dump, by name."""
    functions: dict = {}
    fn: Optional[Function] = None
    where = ("", 0)
    pending: list = []  # labels waiting for their instruction
    for raw in text.splitlines():
        m = _CUOBJDUMP_HEAD.match(raw) or _NVDISASM_HEAD.match(raw)
        if m:
            fn = functions.setdefault(m.group(1), Function(m.group(1)))
            fn.labels[fn.name] = 0  # nvdisasm names the function in RET.REL
            where = ("", 0)
            continue
        if fn is None:
            continue
        if raw.startswith("//----") or raw.lstrip().startswith(".section"):
            fn = None  # nvdisasm: the next section is not this function's code
            continue
        m = _LINE.match(raw)
        if m:
            where = (m.group(1), int(m.group(2)))
            continue
        m = _LABEL.match(raw.strip())
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(raw)
        if not m:
            continue
        address = int(m.group(1), 16)
        fn.labels.update(dict.fromkeys(pending, address))
        pending.clear()
        ins = Instruction(address, m.group(2).strip(), *where)
        lab = _TARGET_LABEL.search(ins.text)
        if lab:
            ins.target_label = lab.group(1)
        elif ins.op in BRANCHES or ins.op == "CALL":
            addr = _TARGET_ADDR.search(ins.text)
            if addr:
                ins.target = int(addr.group(1), 16)
        fn.instructions.append(ins)
    for fn in functions.values():
        for ins in fn.instructions:
            if ins.target_label:
                ins.target = fn.labels.get(ins.target_label)
    return functions


def sizes(text: str) -> dict:
    """Static SASS instruction count of each function of a dump."""
    return {name: fn.size for name, fn in parse(text).items()}


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------


def _successors(fn: Function) -> tuple[dict, list, set]:
    """Instruction-level successor map, the entries (the function's first
    instruction and every ``CALL.REL`` target), and the taken edges of
    ``BRA.DIV`` (to a warp vote's out-of-line divergent path)."""
    ins = fn.instructions
    succ: dict = {}
    entries = [ins[0].address] if ins else []
    div_edges: set = set()
    for k, i in enumerate(ins):
        nxt = ins[k + 1].address if k + 1 < len(ins) else None
        out = []
        op = i.op
        if op in BRANCHES:
            if i.opcode not in ("BRA", "BRA.DIV", "JMP"):
                raise ValueError(f"{fn.name}: unknown branch at {i.address:#x}: {i.text}")
            if i.target is None:
                raise ValueError(f"{fn.name}: unresolved target at {i.address:#x}: {i.text}")
            out.append(i.target)
            if i.opcode == "BRA.DIV":
                div_edges.add((i.address, i.target))
            if (i.predicated or i.opcode == "BRA.DIV") and nxt is not None:
                out.append(nxt)
        elif op in ("EXIT", "RET"):
            if i.predicated and nxt is not None:
                out.append(nxt)
        elif op in ("BRX", "JMX"):
            raise ValueError(f"{fn.name}: indirect branch at {i.address:#x}: {i.text}")
        else:
            if op == "CALL" and i.target is not None:
                entries.append(i.target)
            if nxt is not None:
                out.append(nxt)
        succ[i.address] = out
    return succ, entries, div_edges


def _reach(succ: dict, entries: list, skip: set = frozenset()) -> list:
    """Addresses reachable from the entries, in reverse postorder, not
    following the edges in ``skip``."""
    seen: set = set()
    post: list = []
    for entry in entries:
        if entry in seen or entry not in succ:
            continue
        seen.add(entry)
        stack = [(entry, iter(succ[entry]))]
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if nxt in succ and nxt not in seen and (node, nxt) not in skip:
                    seen.add(nxt)
                    stack.append((nxt, iter(succ[nxt])))
                    break
            else:
                post.append(node)
                stack.pop()
    return post[::-1]


def _idoms(succ: dict, entries: list) -> dict:
    """Immediate dominators (Cooper, Harvey and Kennedy's iteration) under
    a virtual root joining the entries; an entry's idom is the root, None."""
    order = _reach(succ, entries)
    rank = {a: k for k, a in enumerate(order)}
    preds: dict = {a: [] for a in order}
    for a in order:
        for b in succ[a]:
            if b in rank:
                preds[b].append(a)
    root = object()
    idom: dict = {e: root for e in entries if e in rank}
    rank[root] = -1

    def meet(a, b):
        while a is not b:
            while rank[a] > rank[b]:
                a = idom[a]
            while rank[b] > rank[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for a in order:
            if idom.get(a) is root:
                continue
            new = None
            for p in preds[a]:
                if p in idom:
                    new = p if new is None else meet(p, new)
            if new is not None and idom.get(a) is not new:
                idom[a] = new
                changed = True
    return {a: (None if d is root else d) for a, d in idom.items()}


def classify(fn: Function) -> list:
    """``(instruction, kind)`` for every back edge of ``fn``:

    * ``loop``      its target dominates it (a natural loop);
    * ``rejoin``    reached only through a ``BRA.DIV`` (a warp vote's
                    out-of-line divergent path) and jumping back to a point
                    that does not dominate it;
    * ``pad``       unreachable self-branch (after the last ``EXIT``);
    * ``unknown``   anything else: unreachable code that branches back, or
                    a back edge into a loop with a second entry.
    """
    succ, entries, div_edges = _successors(fn)
    idom = _idoms(succ, entries)
    no_div = set(_reach(succ, entries, div_edges))
    out = []
    for i in fn.back_edges():
        if i.address not in idom:
            kind = "pad" if i.target == i.address else "unknown"
        else:
            a, dominated = i.address, False
            while a is not None:
                if a == i.target:
                    dominated = True
                    break
                a = idom[a]
            if dominated:
                kind = "loop"
            elif i.address not in no_div:
                kind = "rejoin"
            else:
                kind = "unknown"
        out.append((i, kind))
    return out
