"""Layer 2 — AST lint: source checks the recorder cannot see (DESIGN.md
§11), the JAX package's ``repro.analysis.lint`` pointed at the port.

A recording only shows the ops one call dispatched; some constant-time
hazards live in the Python around them.  Four rules, scoped to the
hot-path source tree (``src/repro_torch/{core,kernels,serving}`` by
default):

``host-sync``
    Host-synchronising calls inside *hot functions*.  A function is hot if
    it follows the kernel-body naming convention (``_kernel*`` /
    ``*_body``) or is one of the datapath entry points in ``HOT_FUNCTIONS``
    (qualified names; the explicit tuple stands in for the JAX package's
    ``jax.jit`` test).  Flagged calls: ``.item()`` / ``.tolist()`` /
    ``.cpu()`` / ``.numpy()`` / ``.block_until_ready()`` / ``.bit_length()``
    on expressions, ``float(...)`` / ``int(...)`` / ``bool(...)`` casts,
    ``np.asarray`` / ``np.array`` / ``np.frombuffer`` materialisation,
    ``torch.cuda.synchronize`` and ``jax.device_get``.  On a CUDA tensor
    each of these waits for the device; none belongs on a hot path.  A
    deliberate host step on *host* operands (a numpy batch's length, a
    Python int) is annotated in-line with ``# ct: host-ok`` plus a reason,
    which suppresses the finding on that line.  The C entry points' host
    code in ``kernels/csrc`` is scanned for the synchronising CUDA runtime
    calls (``cudaDeviceSynchronize``, ``cudaStreamSynchronize``,
    ``cudaEventSynchronize``, ``cudaMemcpy`` without ``Async``,
    ``cudaMalloc``, ``cudaFree``; waiver ``// ct: host-ok``): the host half
    of the recorder's ``callback-free``, which no dispatch mode sees.

``bare-int``
    Integer literals outside the int64 range (2^63 and above) used directly
    in arithmetic / bitwise expressions inside hot functions: the port's
    u32 values travel as int64, where such a literal does not fit and torch
    refuses it or promotes the expression.  Wrapping the literal in an
    explicit cast (``_i64(...)``, ``torch.tensor(..., dtype=...)``,
    ``np.uint64(...)``) keeps the carrier's discipline and satisfies the
    rule.

``config-mutation``
    Process-global framework configuration changed in library source:
    ``torch.backends.*`` flag assignments, ``torch.set_default_dtype`` /
    ``set_default_device`` / ``set_float32_matmul_precision`` /
    ``use_deterministic_algorithms``, and the JAX package's
    ``jax.config.update(...)`` / ``jax.config.<flag> = ...``.  Global flips
    belong to tests and tools; library code changing them changes numerics
    for every caller.

The lint is intentionally small and calibrated to this codebase — a
tripwire for specific regressions, not a general-purpose style checker.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, Optional

from repro_torch.analysis.report import LintFinding

#: default lint scope, relative to the package directory
DEFAULT_SCOPE = ("core", "kernels", "serving")

#: in-line waiver token: a line carrying this comment is exempt
WAIVER_TOKEN = "ct: host-ok"

#: the datapath entry points, as ``<module>.<qualified name>``
HOT_FUNCTIONS = (
    *(f"repro_torch.kernels.fused.RoutingKernels.{m}" for m in (
        "route", "route_load", "ingest", "lookup_dyn", "lookup_vec", "lookup_router",
        "route_family", "resolve", "chain_remap")),
    "repro_torch.serving.batch_router.BatchRouter.route_keys",
    "repro_torch.serving.batch_router.BatchRouter.route_ids",
    *(f"repro_torch.kernels.ops.{f}" for f in (
        "route_bulk", "route_load_bulk", "route_ingest_bulk", "lookup_bulk_dyn",
        "route_chain_bulk", "route_replicas_bulk", "placement_diff_bulk",
        "binomial_bulk_lookup", "binomial_bulk_lookup_dyn")),
)

#: hot-function naming convention (kernel bodies / unrolled bodies)
_HOT_NAME = re.compile(r"(^_kernel)|(_body$)")

#: attribute calls that synchronise with (or escape to) the host
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "block_until_ready", "bit_length"}

#: builtin casts that read a tensor's value on the host
_SYNC_BUILTINS = {"float", "int", "bool"}

#: np.<attr> calls that materialise on host
_NP_MATERIALISE = {"asarray", "array", "frombuffer"}

#: synchronising calls by dotted name
_SYNC_CALLS = {"torch.cuda.synchronize", "jax.device_get", "device_get"}

#: explicit cast callables that make a wide literal carrier-safe
_CAST_NAMES = {
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "asarray", "array", "full", "constant", "tensor", "_i64",
}

#: process-global framework configuration calls
_CONFIG_CALLS = {
    "jax.config.update", "config.update",
    "torch.set_default_dtype", "torch.set_default_device",
    "torch.set_float32_matmul_precision", "torch.use_deterministic_algorithms",
}

#: synchronising CUDA runtime calls in the C entry points' host code
_CUDA_SYNC = re.compile(
    r"\bcuda(DeviceSynchronize|StreamSynchronize|EventSynchronize|Memcpy|Malloc|Free)\s*\("
)

_INT64_MAX = 1 << 63


def _dotted(node: ast.AST) -> str:
    """'np.asarray' for Attribute/Name chains, '' for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, module: str, hot: frozenset):
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[LintFinding] = []
        self._hot_depth = 0
        self._scope = [module] if module else []
        self._hot = hot

    # -- helpers ------------------------------------------------------------

    def _line(self, lineno: int) -> str:
        return self.lines[lineno - 1] if 0 < lineno <= len(self.lines) else ""

    def _waived(self, lineno: int) -> bool:
        return WAIVER_TOKEN in self._line(lineno)

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        if not self._waived(node.lineno):
            self.findings.append(
                LintFinding(
                    path=self.path,
                    line=node.lineno,
                    rule=rule,
                    message=message,
                    source=self._line(node.lineno).strip(),
                )
            )

    # -- traversal ----------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scope.append(node.name)
        hot = bool(_HOT_NAME.search(node.name)) or ".".join(self._scope) in self._hot
        self._hot_depth += hot
        self.generic_visit(node)
        self._hot_depth -= hot
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if self._hot_depth:
            if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_ATTRS:
                self._emit(
                    node,
                    "host-sync",
                    f".{node.func.attr}() synchronises with the host inside a "
                    "hot function (annotate '# ct: host-ok — <why>' if the "
                    "operand is provably on the host)",
                )
            elif name in _SYNC_BUILTINS:
                self._emit(
                    node,
                    "host-sync",
                    f"{name}() reads its operand on the host inside a hot function",
                )
            elif name.startswith("np.") and name[3:] in _NP_MATERIALISE:
                self._emit(
                    node,
                    "host-sync",
                    f"{name}() materialises on host inside a hot function "
                    "(keep device data in tensors)",
                )
            elif name in _SYNC_CALLS:
                self._emit(node, "host-sync", f"{name}() waits for the device")
        # config mutation is flagged everywhere, hot or not
        if name in _CONFIG_CALLS:
            self._emit(
                node,
                "config-mutation",
                f"{name}() changes process-global framework config in library "
                "code — move the flip to test/tool setup",
            )
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            dotted = _dotted(target)
            if dotted.startswith(("jax.config.", "config.jax_", "torch.backends.")):
                self._emit(
                    node,
                    "config-mutation",
                    f"assignment to {dotted} mutates global framework config "
                    "in library code",
                )
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if self._hot_depth:
            for side in (node.left, node.right):
                if (
                    isinstance(side, ast.Constant)
                    and type(side.value) is int
                    and not -_INT64_MAX <= side.value < _INT64_MAX
                ):
                    self._emit(
                        node,
                        "bare-int",
                        f"bare literal {side.value:#x} exceeds int64, the port's "
                        "u32 carrier — wrap it in an explicit cast "
                        "(_i64(...) / torch.tensor(..., dtype=...))",
                    )
        self.generic_visit(node)


def _strip_casts(tree: ast.AST) -> None:
    """Neutralise wide literals that are *arguments of explicit casts* so
    ``visit_BinOp`` never sees them (the cast pins the dtype before any
    carrier arithmetic runs)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _CAST_NAMES:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant) and type(sub.value) is int:
                        sub.value = 0


def lint_source(
    source: str, path: str = "<string>", module: str = "",
    hot: Iterable[str] = HOT_FUNCTIONS,
) -> list[LintFinding]:
    """Lint one module's source text; returns findings (empty = clean).
    ``module`` is the module's dotted name, against which ``hot`` names the
    entry points (``<module>.<Class>.<method>``; with no module, the bare
    qualified name)."""
    tree = ast.parse(source, filename=path)
    _strip_casts(tree)
    linter = _Linter(path, source, module, frozenset(hot))
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.rule))


def lint_cuda_source(source: str, path: str = "<string>") -> list[LintFinding]:
    """Synchronising CUDA runtime calls in C/C++ source (comments skipped;
    ``// ct: host-ok`` on the line waives one)."""
    findings = []
    for no, line in enumerate(source.splitlines(), 1):
        code = line.split("//", 1)[0]
        m = _CUDA_SYNC.search(code)
        if m and WAIVER_TOKEN not in line:
            findings.append(LintFinding(
                path=path, line=no, rule="host-sync",
                message=f"cuda{m.group(1)}() synchronises the host with the device "
                        "in a launch path (use the stream-ordered Async form)",
                source=line.strip(),
            ))
    return findings


def lint_paths(
    root: Optional[pathlib.Path] = None,
    scope: Iterable[str] = DEFAULT_SCOPE,
) -> list[LintFinding]:
    """Lint every ``.py`` and CUDA source under ``root/<scope dirs>`` (root
    defaults to the installed ``repro_torch`` package directory)."""
    if root is None:
        import repro_torch

        root = pathlib.Path(repro_torch.__file__).parent
    findings: list[LintFinding] = []
    for sub in scope:
        base = root / sub
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*")):
            rel = path.relative_to(root.parent)
            if path.suffix == ".py":
                module = ".".join(rel.with_suffix("").parts)
                findings.extend(lint_source(path.read_text(), str(rel),
                                            module.removesuffix(".__init__")))
            elif path.suffix in (".cu", ".cuh"):
                findings.extend(lint_cuda_source(path.read_text(), str(rel)))
    return findings
