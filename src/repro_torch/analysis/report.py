"""Structured results of the constant-time certifier (DESIGN.md §11) — a
copy of the JAX package's ``repro.analysis.report`` with one more result
type, ``SassGateResult``, for the port's third layer.

One ``Report`` aggregates the layers — graph certification targets, AST
lint findings and the SASS gate's results on the compiled kernels — and
serializes to one JSON artifact.  The JSON is keyed by engine and
invariant (``engines.<engine>.<target>.<invariant>``), so a regression
diff pinpoints exactly which guarantee broke on which datapath.

For results the JAX package's report can hold (targets, lint, HLO gate),
``to_json()`` and ``render()`` give its bytes exactly, section headers
included; the ``sass`` key and section appear only when the SASS gate ran.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

PASS = "pass"
FAIL = "fail"
WAIVED = "waived"
SKIPPED = "skipped"


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One invariant's verdict on one certification target."""

    invariant: str
    status: str  # pass | fail | waived | skipped
    detail: str
    waiver: Optional[str] = None  # the allowlist reason, when status == waived

    def to_dict(self) -> dict:
        d = {"status": self.status, "detail": self.detail}
        if self.waiver:
            d["waiver"] = self.waiver
        return d


@dataclasses.dataclass
class TargetReport:
    """All invariant verdicts for one recorded callable of one engine."""

    engine: str
    target: str  # e.g. "route/plain", "ingest/cuda", "chain/memento_remap"
    checks: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.status != FAIL for c in self.checks)

    def failures(self) -> list:
        return [c for c in self.checks if c.status == FAIL]

    def to_dict(self) -> dict:
        return {c.invariant: c.to_dict() for c in self.checks}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One AST-lint violation (layer 2)."""

    path: str
    line: int
    rule: str
    message: str
    source: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class HloGateResult:
    """The JAX package's layer-3 verdicts for one engine's compiled fused
    route; kept so that a report holds the same results as the reference's."""

    engine: str
    checks: list = dataclasses.field(default_factory=list)
    op_count: int = 0

    @property
    def ok(self) -> bool:
        return all(c.status != FAIL for c in self.checks)

    def to_dict(self) -> dict:
        return {
            "op_count": self.op_count,
            "checks": {c.invariant: c.to_dict() for c in self.checks},
        }


@dataclasses.dataclass
class SassGateResult(HloGateResult):
    """Layer-3 verdicts of the port for one engine's compiled kernels, in
    the HLO gate's shape: ``op_count`` is the static SASS size of the
    engine's kernel functions (0 where the SASS was not read)."""


@dataclasses.dataclass
class Report:
    """The aggregate certification report."""

    targets: list = dataclasses.field(default_factory=list)
    lint: list = dataclasses.field(default_factory=list)
    hlo: list = dataclasses.field(default_factory=list)
    sass: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (
            all(t.ok for t in self.targets)
            and not self.lint
            and all(h.ok for h in self.hlo)
            and all(s.ok for s in self.sass)
        )

    def to_dict(self) -> dict:
        engines: dict = {}
        for t in self.targets:
            engines.setdefault(t.engine, {})[t.target] = t.to_dict()
        out = {
            "ok": self.ok,
            "engines": engines,
            "lint": [f.to_dict() for f in self.lint],
            "hlo": {h.engine: h.to_dict() for h in self.hlo},
        }
        if self.sass:
            out["sass"] = {s.engine: s.to_dict() for s in self.sass}
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def render(self) -> str:
        """Human-readable summary table (the CLI's stdout).  The section
        headers are the JAX package's, so that the same results render to
        the same bytes."""
        lines: list[str] = []
        mark = {PASS: "ok", FAIL: "FAIL", WAIVED: "waived", SKIPPED: "skip"}
        if self.targets:
            lines.append("== jaxpr certifier ==")
            for t in self.targets:
                verdict = "OK" if t.ok else "FAIL"
                lines.append(f"  [{verdict}] {t.engine:<12} {t.target}")
                for c in t.checks:
                    note = f" ({c.waiver})" if c.waiver else ""
                    lines.append(
                        f"      {mark[c.status]:>6}  {c.invariant:<22} {c.detail}{note}"
                    )
        lines.append("== ast lint ==")
        if self.lint:
            lines.extend(f"  FAIL {f}" for f in self.lint)
        else:
            lines.append("  ok (no findings)")
        if self.hlo:
            lines.append("== hlo gate ==")
            for h in self.hlo:
                verdict = "OK" if h.ok else "FAIL"
                lines.append(f"  [{verdict}] {h.engine} ({h.op_count} HLO ops)")
                for c in h.checks:
                    lines.append(
                        f"      {mark[c.status]:>6}  {c.invariant:<22} {c.detail}"
                    )
        if self.sass:
            lines.append("== sass gate ==")
            for s in self.sass:
                verdict = "OK" if s.ok else "FAIL"
                lines.append(f"  [{verdict}] {s.engine} ({s.op_count} SASS instructions)")
                for c in s.checks:
                    note = f" ({c.waiver})" if c.waiver else ""
                    lines.append(
                        f"      {mark[c.status]:>6}  {c.invariant:<22} {c.detail}{note}"
                    )
        lines.append(f"== verdict: {'CERTIFIED' if self.ok else 'FAILED'} ==")
        return "\n".join(lines)
