"""The port's constant-time certifier (``repro_torch.analysis``) on the CPU,
held to the JAX package's certifier where the two meet.

* Seeded violations — a data-dependent loop, a float64 leak, a quadratic
  unroll, a host copy, an in-call device move, a data-sized output — each
  trip exactly the invariant built to catch them (the cases of
  ``tests/test_certifier.py``), and a seeded engine makes the CLI exit
  nonzero;
* every registered engine's plain and entry-point targets certify, the
  chain baseline passes only through its waiver, and the ``/cuda`` targets
  and the SASS checks are skipped here with the reason;
* the report's bytes equal the JAX package's for the same results, and the
  targets' labels and the invariants correspond one to one with its;
* the SASS parser and the gate's logic on short dumps written out here, and
  the loop tags of ``csrc/routing.cu`` against the source's loops.

The reference's certifier itself cannot run under this JAX (it stops at
``jax.experimental.enable_x64``), so its labels are listed without tracing
and its invariant names read from its source.
"""
import ast
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import certify as ref_certify  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro_torch.analysis import certify, report, sass, sass_gate  # noqa: E402
from repro_torch.analysis.certify import EngineContract, certify_all, certify_callable, record  # noqa: E402
from repro_torch.analysis.markers import constant_time_waiver, waivers_of  # noqa: E402
from repro_torch.analysis.report import FAIL, PASS, SKIPPED, WAIVED  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

#: tiny contract for fixtures — invariants don't care about scale
SMALL = EngineContract(batch=8, capacity=64)

KEYS8 = torch.arange(8, dtype=torch.int32)


def _check(rep, invariant):
    (res,) = [c for c in rep.checks if c.invariant == invariant]
    return res


def _tracer(fn, *operands):
    """omega -> the recording of ``fn(*operands, omega)``."""
    return lambda om: record(lambda: fn(*operands, om))


def _only(rep, invariant, check_affine=True):
    """``invariant`` failed and every other invariant passed (or, for
    unroll-affine of a non-ω target, was skipped)."""
    for c in rep.checks:
        if c.invariant == invariant:
            assert c.status == FAIL, c
        elif c.invariant == "unroll-affine" and not check_affine:
            assert c.status == SKIPPED, c
        else:
            assert c.status == PASS, c


# ---------------------------------------------------------------------------
# seeded violations — each trips exactly its invariant
# ---------------------------------------------------------------------------


def _while_route(keys, omega):
    """Trip count depends on key VALUES — the storm-cliff bug class."""
    k = keys.to(torch.int64)
    steps = 0
    while bool((k > 0).any()):
        k = k >> 1
        steps += 1
    return torch.full(keys.shape, steps, dtype=torch.int32)


def test_data_dependent_while_fails_certification():
    rep = certify_callable("fixture", "route/plain", _tracer(_while_route, KEYS8),
                           contract=SMALL, check_affine=False)
    res = _check(rep, "while-free")
    assert "item read" in res.detail
    _only(rep, "while-free", check_affine=False)
    assert not rep.ok


def test_waiver_downgrades_while_to_waived_with_reason():
    rep = certify_callable(
        "fixture", "route/plain", _tracer(_while_route, KEYS8), contract=SMALL,
        waivers={"while-free": "fixture: bounded by construction"}, check_affine=False,
    )
    res = _check(rep, "while-free")
    assert res.status == WAIVED
    assert res.waiver == "fixture: bounded by construction"
    assert rep.ok  # waived is not failed...
    assert rep.to_dict()["while-free"]["waiver"]  # ...but never silent


def _f64_route(keys, omega):
    """Accumulates in float64 — breaks the dtype closure."""
    acc = keys.to(torch.float64)
    for _ in range(omega):
        acc = acc * 1.0000001 + 1.0
    return acc.to(torch.int32)


def test_f64_leak_fails_dtype_closed():
    rep = certify_callable("fixture", "route/plain", _tracer(_f64_route, KEYS8), contract=SMALL)
    assert "float64" in _check(rep, "dtype-closed").detail
    _only(rep, "dtype-closed")


def _quadratic_route(keys, omega):
    """O(ω²) ops — unroll depth is NOT the declared ω."""
    out = keys.to(torch.int64)
    for i in range(omega):
        for _ in range(i + 1):
            out = out + 1
    return out.to(torch.int32)


def test_quadratic_unroll_fails_affine():
    rep = certify_callable("fixture", "route/plain", _tracer(_quadratic_route, KEYS8),
                           contract=SMALL)
    _only(rep, "unroll-affine")


def test_op_budget_fails_affine():
    rep = certify_callable("fixture", "route/plain", _tracer(_f64_route, KEYS8),
                           contract=dataclasses.replace(SMALL, max_eqns=8,
                                                        allowed_dtypes=frozenset({"float64", "int32"})))
    assert "budget" in _check(rep, "unroll-affine").detail
    _only(rep, "unroll-affine")


@pytest.mark.parametrize("escape", ["numpy", "tolist"])
def test_host_copy_fails_callback_free(escape):
    def route(keys, omega):
        host = getattr(keys, escape)()
        return torch.as_tensor(np.asarray(host, dtype=np.int32))

    rep = certify_callable("fixture", "route/plain", _tracer(route, KEYS8), contract=SMALL,
                           check_affine=False)
    assert f"Tensor.{escape}" in _check(rep, "callback-free").detail
    _only(rep, "callback-free", check_affine=False)


def _transfer_route(keys, omega):
    """Moves a tensor to another device inside the call."""
    keys.to("meta")
    return keys.to(torch.int32)


def test_in_call_device_move_fails_transfer_count():
    rep = certify_callable("fixture", "route/plain", _tracer(_transfer_route, KEYS8),
                           contract=SMALL, check_affine=False)
    assert "1 cross-device" in _check(rep, "transfer-count").detail
    _only(rep, "transfer-count", check_affine=False)


def test_data_sized_output_fails_while_free_and_bincount_is_held():
    def spill(keys, omega):  # a replica id past the minlength grows the output
        return torch.bincount(keys.to(torch.int64) + 60, minlength=64)

    def held(keys, omega):
        return torch.bincount(keys.to(torch.int64), minlength=64)

    rep = certify_callable("fixture", "load", _tracer(spill, KEYS8), contract=SMALL,
                           check_affine=False)
    assert "aten.bincount.default" in _check(rep, "while-free").detail
    _only(rep, "while-free", check_affine=False)
    rep = certify_callable("fixture", "load", _tracer(held, KEYS8), contract=SMALL,
                           check_affine=False)
    assert rep.ok and "bincount held" in _check(rep, "while-free").detail


def test_recorder_notes_ops_launches_and_devices():
    rec = record(lambda: (KEYS8.to(torch.int64) + 1).to(torch.int32))
    assert [op.name for op in rec.ops] == [
        "aten._to_copy.default", "aten.add.Tensor", "aten._to_copy.default"]
    assert rec.ops[1].dtypes == ("int64",) and rec.ops[1].devices == ("cpu",)
    assert not any(op.transfer for op in rec.ops) and rec.launches == {}


# ---------------------------------------------------------------------------
# the real contract
# ---------------------------------------------------------------------------


@functools.cache
def _cpu_report():
    return certify_all(device="cpu")


def test_every_registered_engine_certifies_on_the_cpu():
    from repro_torch.core.registry import BULK_ENGINES

    rep = _cpu_report()
    assert rep.ok, rep.render()
    by_engine = {}
    for t in rep.targets:
        by_engine.setdefault(t.engine, {})[t.target] = t
    for name in BULK_ENGINES:
        targets = by_engine[name]
        for label in ("route/plain", "ingest/plain", "lookup_dyn/plain", "route/lifecycle",
                      "placement/route_replicas", "serving/streaming",
                      "observability/load_pass"):
            assert {c.status for c in targets[label].checks} == {PASS}, targets[label].to_dict()
        for label in ("route/cuda", "ingest/cuda", "lookup_dyn/cuda"):
            checks = targets[label].checks
            assert {c.status for c in checks} == {SKIPPED}
            assert all("needs a CUDA device" in c.detail for c in checks)
    # the unroll is exactly ω: binomial's lookup costs the same ops each trip
    assert "+64/iteration" in _check(by_engine["binomial"]["route/plain"], "unroll-affine").detail
    assert "bincount held" in _check(by_engine["jump"]["observability/load_pass"],
                                     "while-free").detail


def test_chain_baseline_passes_only_via_waiver():
    from repro_torch.core import memento_torch

    (chain,) = [t for t in _cpu_report().targets if t.target == "chain/memento_remap"]
    res = _check(chain, "while-free")
    assert res.status == WAIVED and "max_chain" in res.waiver
    assert _check(chain, "unroll-affine").status == SKIPPED
    for inv in ("dtype-closed", "callback-free", "transfer-count"):
        assert _check(chain, inv).status == PASS
    # remove the waiver and the same recording goes red
    keys = certify.keys_for(SMALL)
    mask = torch.zeros(64, dtype=torch.bool)
    mask[[1, 3, 5]] = True
    unmarked = certify_callable(
        "binomial", "chain/memento_remap",
        lambda om: record(lambda: memento_torch.memento_remap(
            keys, (keys.to(torch.int64) & 7).to(torch.int32), mask, 8, 0)),
        contract=SMALL, waivers={}, check_affine=False,
    )
    assert _check(unmarked, "while-free").status == FAIL


def test_waiver_requires_reason():
    with pytest.raises(ValueError, match="reason"):
        constant_time_waiver("")(lambda: None)


def test_waivers_seen_through_wrapping():
    @constant_time_waiver("test: bounded", invariant="while-free")
    def fn(x):
        return x

    @functools.wraps(fn)
    def wrapped(x):
        return fn(x)

    assert waivers_of(wrapped) == {"while-free": "test: bounded"}
    assert waivers_of(lambda: None) == {}


# ---------------------------------------------------------------------------
# parity with the JAX package: labels, invariants, report bytes
# ---------------------------------------------------------------------------


def _labels(module, monkeypatch, **kw):
    """(engine, target) of every target ``module.certify_all`` builds, with
    ``certify_callable`` stubbed so that nothing runs."""
    seen = []

    def stub(engine, target, tracer, **_):
        seen.append((engine, target))
        return module.TargetReport(engine, target) if hasattr(module, "TargetReport") else None

    monkeypatch.setattr(module, "certify_callable", stub)
    if hasattr(module, "skipped_target"):
        monkeypatch.setattr(module, "skipped_target", lambda e, t, _r: stub(e, t, None))
    module.certify_all(**kw)
    return seen


def test_target_labels_correspond_to_the_reference(monkeypatch):
    ref = _labels(ref_certify, monkeypatch)
    port = _labels(certify, monkeypatch, device="cpu")
    rename = {"/jnp": "/plain", "/pallas": "/cuda"}

    def ported(label):
        for old, new in rename.items():
            label = label.replace(old, new)
        return label

    assert sorted((e, ported(t)) for e, t in ref) == sorted(port)
    assert len(port) == 2 * 10 + 1


def test_invariant_names_correspond_to_the_reference():
    def names(module, call):
        tree = ast.parse(Path(module.__file__).read_text())
        return {n.args[0].value for n in ast.walk(tree)
                if isinstance(n, ast.Call) and getattr(n.func, "id", "") == call
                and n.args and isinstance(n.args[0], ast.Constant)}

    assert names(ref_certify, "CheckResult") == set(certify.INVARIANTS)
    from repro.analysis import hlo_gate

    rename = {"hlo-while-static": "sass-loops-declared", "hlo-severity-flat": "sass-severity-flat",
              "hlo-op-budget": "sass-op-budget"}
    port_sass = {c.invariant for r in sass_gate.gate_all(["jump"], "cpu") for c in r.checks}
    assert {rename[n] for n in names(hlo_gate, "CheckResult")} == port_sass


def _mirror(obj, module):
    """The same result built from ``module``'s classes."""
    if isinstance(obj, list):
        return [_mirror(x, module) for x in obj]
    if dataclasses.is_dataclass(obj):
        cls = getattr(module, type(obj).__name__)
        theirs = {f.name for f in dataclasses.fields(cls)}
        # the port's extra fields (the report's SASS gate) must be empty
        assert all(not getattr(obj, f.name) for f in dataclasses.fields(obj)
                   if f.name not in theirs)
        return cls(**{name: _mirror(getattr(obj, name), module) for name in theirs})
    return obj


def test_report_bytes_equal_the_reference():
    rep = certify_all(["jump"], device="cpu")
    rep.targets.append(certify.skipped_target("jump", "route/cuda", "why"))
    rep.lint = [report.LintFinding("a.py", 3, "host-sync", ".item() ...", "x.item()")]
    rep.hlo = [report.HloGateResult("jump", [report.CheckResult("hlo-op-budget", PASS, "ok"),
                                             report.CheckResult("hlo-severity-flat", FAIL, "d")],
                                    op_count=12)]
    ref = _mirror(rep, ref_report)
    assert type(ref) is ref_report.Report
    assert rep.to_json() == ref.to_json()
    assert rep.render() == ref.render()
    empty = report.Report()
    assert empty.to_json() == ref_report.Report().to_json()
    assert empty.render() == ref_report.Report().render()


def test_report_adds_the_sass_gate_only_when_it_ran():
    rep = report.Report(sass=sass_gate.gate_all(["jump"], "cpu"))
    data = json.loads(rep.to_json())
    assert set(data["sass"]["jump"]["checks"]) == {
        "sass-loops-declared", "sass-severity-flat", "sass-op-budget"}
    assert "== sass gate ==" in rep.render() and rep.ok


# ---------------------------------------------------------------------------
# the SASS parser and the gate's logic
# ---------------------------------------------------------------------------

#: cuobjdump -sass of a function with one loop: 0x0040 branches back to 0x0020
CUOBJDUMP = """
\t\tFunction : _Z4loopPii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   MOV R0, RZ ;                           /* 0x000000ff00007202 */
        /*0020*/                   IADD3 R0, R0, 0x1, RZ ;                /* 0x0000000100007810 */
        /*0030*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;    /* 0x000000100000780c */
        /*0040*/              @!P0 BRA 0x20 ;                             /* 0xfffffff800008947 */
        /*0050*/                   EXIT ;                                 /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                              /* 0xfffffffc00fc7947 */
"""

#: nvdisasm --print-line-info of the same code, with a warp vote whose
#: divergent path (BRA.DIV) sits after the body and rejoins it
NVDISASM = """
\t.section\t.text._Z4loopPii,"ax",@progbits
        .global         _Z4loopPii
_Z4loopPii:
.text._Z4loopPii:
\t//## File "/src/k.cu", line 3
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MOV R0, RZ ;
.L_x_0:
\t//## File "/src/k.cu", line 5
        /*0020*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0030*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
\t//## File "/src/k.cu", line 4
        /*0040*/              @!P0 BRA `(.L_x_0) ;
\t//## File "/src/k.cu", line 7
        /*0050*/                   BRA.DIV UR4, `(.L_x_2) ;
        /*0060*/                   VOTE.ANY R2, PT, P0 ;
.L_x_3:
        /*0070*/                   EXIT ;
.L_x_2:
        /*0080*/                   MOV R3, 0xffffffff ;
        /*0090*/                   BRA `(.L_x_3) ;
.L_x_4:
        /*00a0*/                   BRA `(.L_x_4);
//--------------------- .nv.info --------------------------
"""

SOURCE = """\
__global__ void loop(int* out, int n) {
  int i = 0;
  // ct-loop: static: sixteen trips
  for (int t = 0; t < 16; ++t) {
    i += 1;
  }
  out[0] = __any_sync(0xffffffffu, i > n);
}
"""


def test_sass_parser_reads_both_dump_formats():
    (fn,) = sass.parse(CUOBJDUMP).values()
    assert fn.name == "_Z4loopPii" and fn.size == 7
    assert [(i.address, i.target) for i in fn.back_edges()] == [(0x40, 0x20), (0x60, 0x60)]
    assert [k for _, k in sass.classify(fn)] == ["loop", "pad"]
    assert sass.sizes(CUOBJDUMP) == {"_Z4loopPii": 7}
    (lined,) = sass.parse(NVDISASM).values()
    assert lined.labels[".L_x_2"] == 0x80 and lined.size == 11
    assert [(i.address, i.line) for i in lined.back_edges()] == [(0x40, 4), (0x90, 7), (0xa0, 7)]
    assert [k for _, k in sass.classify(lined)] == ["loop", "rejoin", "pad"]
    # the same instructions compare equal across the formats
    assert [i.normalized() for i in fn.instructions[:5]] == [
        i.normalized() for i in lined.instructions[:5]]


def test_gate_maps_tagged_loops_and_fails_an_untagged_one(tmp_path):
    (fn,) = sass.parse(NVDISASM).values()
    src = tmp_path / "k.cu"
    src.write_text(SOURCE)
    loops = sass_gate.source_loops(src)
    assert [(lp.first, lp.last, lp.bound) for lp in loops] == [(4, 6, "static")]
    fl = sass_gate.map_loops(fn, loops, ["k.cu"])
    assert fl.loops == [("k.cu:4", "static")] and not fl.undeclared
    assert (fl.rejoins, fl.pads) == (1, 1)
    assert sass_gate._loops_check({"loop": fl}).status == PASS
    # the seeded untagged loop
    src.write_text(SOURCE.replace("  // ct-loop: static: sixteen trips\n", "  //\n"))
    untagged = sass_gate.map_loops(fn, sass_gate.source_loops(src), ["k.cu"])
    assert untagged.undeclared and "no tagged loop" in untagged.undeclared[0]
    check = sass_gate._loops_check({"loop": untagged})
    assert check.status == FAIL and "undeclared" in check.detail
    assert sass_gate.tag_findings([src]) == ["k.cu:4: loop without a ct-loop tag"]
    # a loop in a file outside the kernel sources (a header's) fails too
    outside = sass_gate.map_loops(fn, loops, ["routing.cu"])
    assert "outside the kernel sources" in outside.undeclared[0]


def test_gate_waives_a_data_bounded_loop(tmp_path):
    (fn,) = sass.parse(NVDISASM).values()
    src = tmp_path / "k.cu"
    src.write_text(SOURCE.replace("static: sixteen trips", "max_chain: the walk"))
    fl = sass_gate.map_loops(fn, sass_gate.source_loops(src), ["k.cu"])
    check = sass_gate._loops_check({"chain": fl}, waiver="bounded by max_chain")
    assert check.status == WAIVED and check.waiver == "bounded by max_chain"


def test_gate_fails_a_data_bounded_loop_without_a_reason(tmp_path):
    """Only a caller that gives the reason (the chain gate) may waive a
    ``max_chain`` loop; the engine gate, which gives none, fails it."""
    (fn,) = sass.parse(NVDISASM).values()
    src = tmp_path / "k.cu"
    src.write_text(SOURCE.replace("static: sixteen trips", "max_chain: the walk"))
    fl = sass_gate.map_loops(fn, sass_gate.source_loops(src), ["k.cu"])
    check = sass_gate._loops_check({"route": fl})
    assert check.status == FAIL and "no waiver reason" in check.detail


def test_severity_check_fails_when_the_storm_launches_differ(monkeypatch):
    """The severity check compares what each path really did: a storm run
    whose route launched one more shape than the healthy run fails it."""
    real, runs = sass_gate._observe, []

    def seeded(*args):
        out = real(*args)
        runs.append(out)
        if len(runs) % 2 == 0:  # the storm's run
            hist, launches, shapes, syncs = out["route"]
            out["route"] = (hist, launches, shapes + [(1, 1)], syncs)
        return out

    monkeypatch.setattr(sass_gate, "_observe", seeded)
    check = sass_gate.severity_check("binomial", certify.contract_for("binomial"), "cpu")
    assert check.status == FAIL and "route: launches/shapes" in check.detail
    assert "placement" not in check.detail


def test_routing_loop_tags_match_the_source_loops():
    paths = [build.CSRC / name for name in build.SOURCES]
    assert sass_gate.tag_findings(paths) == []
    loops = [lp for p in paths for lp in sass_gate.source_loops(p)]
    code = "".join(sass_gate._blank_comments(p.read_text()) for p in paths)
    assert len(loops) == code.count("for (") + code.count("while (") == 31
    assert {lp.bound for lp in loops} <= set(sass_gate.BOUNDS)
    chain = [lp for lp in loops if lp.bound in sass_gate.WAIVED_BOUNDS]
    assert [(lp.file, lp.bound) for lp in chain] == [("routing.cu", "max_chain")]
    # Binomial::rest's loop (inlined into every binomial kernel) is ω-bounded
    (rest,) = [lp for lp in loops if lp.file == "routing.cuh"]
    assert rest.bound == "omega"


def test_gate_on_the_cpu_runs_severity_and_skips_the_sass_checks():
    gate = sass_gate.gate_engine("jump", "cpu")
    assert gate.ok and gate.op_count == 0
    assert _check(gate, "sass-severity-flat").status == PASS
    for inv in ("sass-loops-declared", "sass-op-budget"):
        res = _check(gate, inv)
        assert res.status == SKIPPED and "--device cpu" in res.detail


def test_missing_tool_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvdisasm not found"):
        build.cuda_tool("nvdisasm")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_certifies_registered_engine(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--engine", "jump", "--device", "cpu", "--skip-sass"]) == 0
    out = capsys.readouterr().out
    assert "verdict: CERTIFIED" in out and "ok (no findings)" in out


def test_cli_fails_on_seeded_violation_engine(capsys, monkeypatch):
    from repro_torch.analysis.__main__ import main
    from repro_torch.core import registry
    from repro_torch.kernels.fused import BINOMIAL, RoutingKernels

    def bad_route(keys, packed, table, state, omega=16):
        return _while_route(keys, omega)

    kernels = RoutingKernels("broken", 0, bad_route, BINOMIAL.ingest_plain,
                             BINOMIAL.lookup_dyn_plain, BINOMIAL.lookup_vec_plain, BINOMIAL.fold)
    broken = dataclasses.replace(registry.BULK_ENGINES["binomial"], name="broken",
                                 kernels=kernels)
    monkeypatch.setitem(registry.BULK_ENGINES, "broken", broken)
    assert main(["--engine", "broken", "--device", "cpu", "--skip-sass", "--skip-lint",
                 "--no-chain-baseline"]) == 1
    out = capsys.readouterr().out
    assert "verdict: FAILED" in out and "item read" in out


def test_cli_writes_structured_report(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "ct.json"
    assert main(["--engine", "jump", "--device", "cpu", "--skip-lint", "--no-chain-baseline",
                 "--report", str(out), "--json"]) == 0
    data = json.loads(out.read_text())
    assert data["ok"] is True
    assert "while-free" in data["engines"]["jump"]["route/plain"]
    assert data["sass"]["jump"]["checks"]["sass-loops-declared"]["status"] == SKIPPED
    assert json.loads(capsys.readouterr().out) == data


def test_cli_without_cuda_and_without_device_cpu_raises():
    from repro_torch.analysis.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--engine", "jump"])
