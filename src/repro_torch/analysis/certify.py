"""Layer 1 — the graph certifier of the port: machine-check the O(1)
contract of every registered device engine (DESIGN.md §11), the
counterpart of the JAX package's jaxpr certifier (``repro.analysis.certify``).

PyTorch runs eagerly, so there is no jaxpr to walk: the certifier RUNS each
target once under a ``TorchDispatchMode`` that records every aten op it
dispatches (name, output dtypes and devices, the devices of its inputs) and
a ``TorchFunctionMode`` that notes every way tensor data leaves for Python
(``Tensor.numpy``, ``.tolist``, ``__array__``).  On the card the
``RoutingKernels`` launches are ctypes calls the dispatch mode does not
see: the wrapper's own ops are recorded, and its launch counts say that
its kernel ran; layer 3 (``repro_torch.analysis.sass_gate``) reads the
kernels themselves.  Per target:

* ``while-free``       — no ``aten._local_scalar_dense`` (the op behind
  ``bool()``, ``int()``, ``float()`` and ``.item()`` of a tensor: the only
  way eager torch lets key data steer a Python loop) and no op whose output
  size follows the data (``nonzero``, ``masked_select``, ``unique``, ...).
  ``bincount`` passes only where its output is exactly its ``minlength``
  (the load pass's ``minlength=capacity`` with every replica id below
  capacity), and the detail says so.  Waivable via
  ``repro_torch.analysis.markers.constant_time_waiver`` for paper-faithful
  baselines; the waiver reason lands in the report.
* ``unroll-affine``    — the op count is exactly affine in the ω unroll
  bound: running at ω, ω+1, ω+2 must yield equal first differences, within
  an absolute op budget.  A ``/cuda`` target passes ω to its kernel as a
  launch argument, so its ops must be FLAT in ω (slope 0) and each call must
  launch exactly its kernels, once each.
* ``dtype-closed``     — every op output dtype stays in the engine's
  allowed set: int64 (the port's u32 carrier: u32 values travel as int64
  in [0, 2^32)), int32, float32 (jump's step) and bool.  Any float64 fails.
* ``callback-free``    — no tensor data reaches the host: no copy from a
  device to the CPU, no ``Tensor.numpy``/``.tolist``/``__array__``, and on
  the card no synchronising call (the target runs under
  ``torch.cuda.set_sync_debug_mode("error")``).  Item reads are the
  ``while-free`` invariant's alone: the recorder lets
  ``_local_scalar_dense`` synchronise, so a baseline that waives
  ``while-free`` fails nothing else, as in the JAX package.  The sync
  debug mode does not see an explicit ``torch.cuda.synchronize()``; the
  lint's ``host-sync`` rule catches that call in the hot functions.
* ``transfer-count``   — exactly the declared number of copies whose
  output lies on another device than their source (0 for every engine:
  fleet state is pinned at event time, the hot path never re-uploads).

Targets, per engine (the JAX package's, ``/jnp`` read ``/plain`` and
``/pallas`` read ``/cuda``): route, ingest and lookup_dyn as ``/plain``
(the plain torch versions on CPU tensors) and as ``/cuda`` (the kernel
wrappers on CUDA tensors), ``route/lifecycle``,
``placement/route_replicas`` (affine in r), ``serving/streaming`` and
``observability/load_pass`` on the run's device, and the chain baseline
``chain/memento_remap``, which passes only through its waiver.  With
``device="cpu"`` the ``/cuda`` targets are reported ``skipped`` with the
reason; on the card none is.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.markers import waivers_of
from repro_torch.analysis.report import (
    FAIL,
    PASS,
    SKIPPED,
    WAIVED,
    CheckResult,
    Report,
    TargetReport,
)

#: the five invariants, in report order
INVARIANTS = ("while-free", "unroll-affine", "dtype-closed", "callback-free", "transfer-count")

#: the op behind ``bool()`` / ``int()`` / ``float()`` / ``.item()`` of a tensor
ITEM_OP = "aten._local_scalar_dense.default"

#: ops whose output size follows the values of their input
DATA_SHAPED = {
    "aten.nonzero.default", "aten.masked_select.default", "aten.bincount.default",
    "aten._unique.default", "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default", "aten.repeat_interleave.Tensor",
}

#: ops that copy a tensor, possibly to another device
COPY_OPS = {
    "aten._to_copy.default", "aten.copy_.default", "aten.copy.default",
    "aten._copy_from.default", "aten._copy_from_and_resize.default",
}

#: ``Tensor`` methods by which tensor data reaches Python
HOST_ESCAPES = {"numpy", "tolist", "__array__"}

#: what torch says when ``set_sync_debug_mode("error")`` stops a call
SYNC_MESSAGE = "synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class EngineContract:
    """The declared invariants one engine is certified against.

    omega             the ω unroll bound the targets run at (shared with
                      ``RouterSpec.omega`` — the serving default)
    capacity          fleet slot-space bound of the operands
    batch             number of keys per call
    allowed_dtypes    closure set for ``dtype-closed``: int64 is the port's
                      u32 carrier (the JAX package's uint32), so it is in
                      the set and float64 is not
    device_transfers  declared count of cross-device copies (0 = the hot
                      path never re-uploads state)
    max_eqns          absolute op budget at ω (catches constant-term
                      blow-ups that affinity alone would pass)
    """

    omega: int = 16
    capacity: int = 64
    batch: int = 2048
    allowed_dtypes: frozenset = frozenset({"int64", "int32", "float32", "bool"})
    device_transfers: int = 0
    max_eqns: int = 8192


#: per-engine overrides of the default contract (empty = every engine is
#: held to the same strict default)
CONTRACTS: dict[str, EngineContract] = {}


def contract_for(engine: str) -> EngineContract:
    return CONTRACTS.get(engine, EngineContract())


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op."""

    name: str
    dtypes: tuple = ()      # output dtypes, e.g. ("int64",)
    devices: tuple = ()     # output devices, e.g. ("cuda:0",)
    in_devices: tuple = ()  # devices of the tensor inputs
    data_shaped: bool = False  # output size followed the data

    @property
    def transfer(self) -> bool:
        """A copy whose output lies on another device than its source."""
        return self.name in COPY_OPS and set(self.devices) != set(self.in_devices)

    @property
    def to_host(self) -> bool:
        return self.transfer and "cpu" in self.devices


@dataclasses.dataclass
class Recording:
    """What one call of a target did."""

    ops: list = dataclasses.field(default_factory=list)
    escapes: list = dataclasses.field(default_factory=list)  # Tensor methods to Python
    syncs: list = dataclasses.field(default_factory=list)    # synchronising calls (card)
    launches: dict = dataclasses.field(default_factory=dict)  # kernel launches, by kind
    held: int = 0  # bincounts held to their minlength

    def histogram(self) -> dict:
        return dict(collections.Counter(op.name for op in self.ops))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class _OpRecorder(TorchDispatchMode):
    def __init__(self, rec: Recording):
        super().__init__()
        self.rec = rec
        self.current = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        self.current = name
        if name == ITEM_OP and torch.cuda.is_available() and torch.cuda.get_sync_debug_mode():
            # an item read is while-free's finding; let it synchronise
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                out = func(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        else:
            out = func(*args, **kwargs)
        self.current = None
        outs = _tensors(out)
        shaped = name in DATA_SHAPED
        if name == "aten.bincount.default":
            minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            if outs and outs[0].numel() == minlength:
                shaped = False
                self.rec.held += 1
        self.rec.ops.append(OpRecord(
            name=name,
            dtypes=tuple(_dtype(t) for t in outs),
            devices=tuple(str(t.device) for t in outs),
            in_devices=tuple(sorted({str(t.device) for t in _tensors((args, kwargs))})),
            data_shaped=shaped,
        ))
        return out


class _EscapeRecorder(TorchFunctionMode):
    def __init__(self, rec: Recording):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_ESCAPES:
            self.rec.escapes.append(f"Tensor.{name}")
        return func(*args, **(kwargs or {}))


def record(fn: Callable[[], object], *, kernels: Iterable = (), sync_check: bool = False) -> Recording:
    """Run ``fn()`` once and return what it did.  ``kernels`` are the
    ``RoutingKernels`` whose launches to count; ``sync_check`` runs the call
    under ``torch.cuda.set_sync_debug_mode("error")``, so that a
    synchronising call stops it and is recorded (with the op it was in)."""
    rec = Recording()
    kernels = list(kernels)
    before = [dict(k.launches) for k in kernels]
    ops = _OpRecorder(rec)
    previous = torch.cuda.get_sync_debug_mode() if sync_check else 0
    try:
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        with _EscapeRecorder(rec), ops:
            fn()
    except RuntimeError as exc:
        if SYNC_MESSAGE not in str(exc):
            raise
        rec.syncs.append(f"{ops.current or 'a call outside any op'}: {exc}")
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(previous)
    for k, was in zip(kernels, before):
        for kind, n in k.launches.items():
            if n != was.get(kind, 0):
                rec.launches[kind] = rec.launches.get(kind, 0) + n - was.get(kind, 0)
    return rec


# ---------------------------------------------------------------------------
# per-target certification
# ---------------------------------------------------------------------------


def skipped_target(engine: str, target: str, reason: str) -> TargetReport:
    """A target that did not run, every invariant ``skipped`` with ``reason``."""
    return TargetReport(engine, target, [CheckResult(inv, SKIPPED, reason) for inv in INVARIANTS])


def certify_callable(
    engine: str,
    target: str,
    tracer: Callable[[int], Recording],
    *,
    contract: Optional[EngineContract] = None,
    waivers: Optional[dict] = None,
    check_affine: bool = True,
    launches: Optional[dict] = None,
) -> TargetReport:
    """Certify one recorded callable against the contract.

    ``tracer(omega)`` must return the ``Recording`` of one call of the
    target at that unroll bound (``certify_engine`` builds these per
    datapath; tests hand in fixtures the same way).  ``waivers`` maps
    invariant name -> allowlist reason (see
    ``repro_torch.analysis.markers``).  ``launches`` (card targets) is the
    kernel launches one call must make, ``{kind: count}``: the op count
    must then be flat in ω.
    """
    contract = contract or EngineContract()
    waivers = waivers or {}
    report = TargetReport(engine=engine, target=target)
    recs = [tracer(contract.omega)]
    if check_affine:
        recs += [tracer(contract.omega + extra) for extra in (1, 2)]
    base = recs[0]
    counts = [len(r.ops) for r in recs]

    # -- while-free ---------------------------------------------------------
    items = sum(op.name == ITEM_OP for op in base.ops)
    shaped = sorted({op.name for op in base.ops if op.data_shaped})
    held = (f"; {base.held} bincount held to its minlength (ids below capacity)"
            if base.held else "")
    found = f"{items} item read(s) (aten._local_scalar_dense)" + (
        f" and data-sized outputs {shaped}" if shaped else "")
    if not items and not shaped:
        report.checks.append(
            CheckResult("while-free", PASS, "no item reads and no data-sized outputs" + held)
        )
    elif "while-free" in waivers:
        report.checks.append(
            CheckResult(
                "while-free", WAIVED, f"{found}, explicitly allowlisted",
                waiver=waivers["while-free"],
            )
        )
    else:
        report.checks.append(
            CheckResult(
                "while-free",
                FAIL,
                f"{found} — control flow or shapes may follow key data (the "
                "storm-cliff bug class); keep the loop to a static bound or "
                "add an explicit constant_time_waiver",
            )
        )

    # -- unroll-affine ------------------------------------------------------
    if not check_affine:
        report.checks.append(
            CheckResult("unroll-affine", SKIPPED, "target is not ω-parameterised")
        )
    else:
        d1 = counts[1] - counts[0]
        d2 = counts[2] - counts[1]
        wrong = [r.launches for r in recs if launches is not None and r.launches != launches]
        if d1 != d2 or d1 < 0:
            report.checks.append(
                CheckResult(
                    "unroll-affine",
                    FAIL,
                    f"op counts {counts} at ω={contract.omega}..+2 are not "
                    f"affine (first differences {d1} vs {d2}) — unroll depth "
                    "is not exactly ω",
                )
            )
        elif counts[0] > contract.max_eqns:
            report.checks.append(
                CheckResult(
                    "unroll-affine",
                    FAIL,
                    f"{counts[0]} ops at ω={contract.omega} exceeds the "
                    f"{contract.max_eqns}-op budget",
                )
            )
        elif launches is not None and (d1 or wrong):
            report.checks.append(
                CheckResult(
                    "unroll-affine",
                    FAIL,
                    f"op counts {counts} at ω={contract.omega}..+2 and launches "
                    f"{[r.launches for r in recs]}: a kernel target must run "
                    f"flat in ω and launch exactly {launches} per call",
                )
            )
        elif launches is not None:
            report.checks.append(
                CheckResult(
                    "unroll-affine",
                    PASS,
                    f"{counts[0]} ops at ω={contract.omega}..+2, flat (the kernels "
                    f"take it as a launch argument); launches per call {launches}",
                )
            )
        else:
            report.checks.append(
                CheckResult(
                    "unroll-affine",
                    PASS,
                    f"{counts[0]} ops at ω={contract.omega}, exactly "
                    f"+{d1}/iteration",
                )
            )

    # -- dtype-closed -------------------------------------------------------
    bad = sorted(
        {
            f"{op.name}->{d}"
            for op in base.ops
            for d in op.dtypes
            if d not in contract.allowed_dtypes
        }
    )
    if bad:
        report.checks.append(
            CheckResult(
                "dtype-closed",
                FAIL,
                f"dtypes outside {sorted(contract.allowed_dtypes)}: "
                + ", ".join(bad[:8]),
            )
        )
    else:
        report.checks.append(
            CheckResult(
                "dtype-closed",
                PASS,
                f"all outputs in {sorted(contract.allowed_dtypes)} "
                "(int64 carries u32)",
            )
        )

    # -- callback-free ------------------------------------------------------
    host = sorted({f"{op.name} {op.in_devices}->{op.devices}" for op in base.ops if op.to_host})
    escapes = sorted(set(base.escapes))
    if host or escapes or base.syncs:
        report.checks.append(
            CheckResult(
                "callback-free",
                FAIL,
                f"host copies {host}, host escapes {escapes}, synchronising "
                f"calls {base.syncs}",
            )
        )
    else:
        report.checks.append(
            CheckResult("callback-free", PASS, "no host copies, escapes or synchronising calls")
        )

    # -- transfer-count -----------------------------------------------------
    transfers = sum(op.transfer for op in base.ops)
    if transfers != contract.device_transfers:
        report.checks.append(
            CheckResult(
                "transfer-count",
                FAIL,
                f"{transfers} cross-device copies, contract declares "
                f"{contract.device_transfers}",
            )
        )
    else:
        report.checks.append(
            CheckResult(
                "transfer-count",
                PASS,
                f"exactly {contract.device_transfers} device transfers",
            )
        )
    return report


# ---------------------------------------------------------------------------
# engine target construction
# ---------------------------------------------------------------------------


def fleet_state(capacity: int, removed=(), device="cpu"):
    """A packed fleet of ``capacity`` slots with ``removed`` failed, on
    ``device``: the alive slots first in the table, then the removed ones
    (what ``ReplacementTable`` holds after those failures)."""
    from repro_torch.core.bulk import FleetState
    from repro_torch.core.memento_torch import pack_removed_mask

    removed = list(removed)
    alive = [s for s in range(capacity) if s not in set(removed)]
    table = np.array(alive + removed, np.int32)
    state = np.array([capacity, len(alive)], np.uint32)
    return FleetState(pack_removed_mask(removed, capacity), table, state, capacity).to(device)


def keys_for(contract: EngineContract, device="cpu", seed: int = 0) -> torch.Tensor:
    """The contract's batch of u32 keys (int32 bit patterns), from a seed."""
    x = np.random.default_rng(seed).integers(0, 2**32, size=contract.batch, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


@dataclasses.dataclass(frozen=True)
class Target:
    """One datapath to certify: ``tracer(omega)`` records one call;
    ``launches`` is what a card call must launch; ``skip`` says why a target
    did not run (then ``tracer`` is None)."""

    label: str
    tracer: Optional[Callable[[int], Recording]]
    waivers: dict
    launches: Optional[dict] = None
    skip: str = ""


CPU_SKIP = ("needs a CUDA device: --device cpu runs the plain versions only, "
            "the kernels launch on the card")


def engine_targets(engine_name: str, contract: EngineContract, device="cpu") -> list[Target]:
    """The route / ingest / lookup_dyn datapaths of one engine: the plain
    versions (``/plain``, on the CPU always) and the kernel wrappers on CUDA
    tensors (``/cuda``; skipped when ``device`` is the CPU)."""
    from repro_torch.core.registry import make_bulk

    k = make_bulk(engine_name).kernels
    fleet = fleet_state(contract.capacity)
    keys = keys_for(contract)
    hi = keys_for(contract, seed=1)
    n = torch.tensor([min(8, contract.capacity)], dtype=torch.int32)

    def tracer(fn, *operands, dev="cpu"):
        ops = [t.to(dev) for t in operands]
        return lambda om: record(lambda: fn(*ops, om), kernels=[k],
                                 sync_check=dev != "cpu")

    f = (fleet.packed, fleet.table, fleet.state)
    plans = [
        ("route", k.route, k.route_plain, (keys, *f)),
        ("ingest", k.ingest, k.ingest_plain, (keys, hi, *f)),
        ("lookup_dyn", k.lookup_dyn, k.lookup_dyn_plain, (keys, n)),
    ]
    targets = [Target(f"{kind}/plain", tracer(fn, *ops), waivers_of(plain))
               for kind, fn, plain, ops in plans]
    for kind, fn, _plain, ops in plans:
        if _on_card(device):
            targets.append(Target(f"{kind}/cuda", tracer(fn, *ops, dev=device), waivers_of(fn),
                                  launches={kind: 1}))
        else:
            targets.append(Target(f"{kind}/cuda", None, {}, skip=CPU_SKIP))
    return targets


def _certify(engine: str, t: Target, contract: EngineContract, **kw) -> TargetReport:
    if t.tracer is None:
        return skipped_target(engine, t.label, t.skip)
    return certify_callable(engine, t.label, t.tracer, contract=contract, waivers=t.waivers,
                            launches=t.launches, **kw)


def certify_engine(
    engine_name: str, contract: Optional[EngineContract] = None, device="cpu"
) -> list[TargetReport]:
    """Certify every datapath of one registered ``BULK_ENGINES`` entry."""
    contract = contract or contract_for(engine_name)
    return [_certify(engine_name, t, contract)
            for t in engine_targets(engine_name, contract, device)]


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _storm_router(engine_name: str, contract: EngineContract, om: int, device):
    """A ``LifecycleManager`` over a ``BatchRouter`` of 8 replicas after
    the storm the JAX package's certifier applies (tombstones present, one
    coalesced device refresh behind)."""
    from repro_torch.serving.batch_router import BatchRouter
    from repro_torch.serving.lifecycle import LifecycleManager

    router = BatchRouter(8, engine=engine_name, capacity=contract.capacity, omega=om,
                         device=device)
    mgr = LifecycleManager(router)
    mgr.apply([("fail", 1), ("fail", 3), ("recover", 1), ("fail", 5)])
    return mgr


def lifecycle_target(engine_name: str, contract: EngineContract, device="cpu") -> Target:
    """The route entry EXACTLY as the serving tier dispatches it: a
    ``LifecycleManager``-wrapped ``BatchRouter`` in a storm state.  The
    lifecycle layer is host-side control plane by design; this target
    proves it adds nothing to the device hot path."""
    from repro_torch.core.registry import make_bulk

    k = make_bulk(engine_name).kernels
    keys = keys_for(contract, device)

    def tracer(om):
        mgr = _storm_router(engine_name, contract, om, device)
        return record(lambda: mgr.router.route_keys(keys), kernels=[k],
                      sync_check=_on_card(device))

    return Target("route/lifecycle", tracer, {},
                  launches={"route": 1} if _on_card(device) else None)


def streaming_target(engine_name: str, contract: EngineContract, device="cpu") -> Target:
    """The streaming tier's dispatch EXACTLY as a closed micro-batch runs
    it (DESIGN.md §14): the full streaming stack (manager + placement store
    + repairer + front end) driven through real micro-batches into a storm
    state with a non-empty repair backlog, then one more closed batch's
    route recorded — the streaming apparatus adds nothing to the device hot
    path."""
    from repro_torch.core.registry import make_bulk
    from repro_torch.placement.store import StorePlacement
    from repro_torch.serving.lifecycle import PlacementRepairer
    from repro_torch.serving.streaming import (
        StreamConfig,
        StreamingFrontEnd,
        StreamRequest,
        VirtualClockUs,
    )

    k = make_bulk(engine_name).kernels
    keys = keys_for(contract, device)

    def tracer(om):
        from repro_torch.serving.batch_router import BatchRouter
        from repro_torch.serving.lifecycle import LifecycleManager

        router = BatchRouter(8, engine=engine_name, capacity=contract.capacity, omega=om,
                             device=device)
        mgr = LifecycleManager(router)
        store = StorePlacement(router, r=3)
        store.register((np.arange(64, dtype=np.uint64) * 2654435761).astype(np.uint32))
        PlacementRepairer(store, mgr, budget_per_tick=4)
        clock = VirtualClockUs()
        fe = StreamingFrontEnd(
            mgr, store=store, config=StreamConfig(max_batch=8, service_bound_us=10_000),
            clock=clock,
        )
        mgr.apply([("fail", 1), ("fail", 3), ("recover", 1), ("fail", 5)])
        for i in range(8):
            fe.submit(StreamRequest(key=i * 40_503, deadline_us=clock.now_us() + 50_000))
        clock.advance_us(2_000)
        fe.pump()
        fe.drain()
        return record(lambda: mgr.router.route_keys(keys), kernels=[k],
                      sync_check=_on_card(device))

    return Target("serving/streaming", tracer, {},
                  launches={"route": 1} if _on_card(device) else None)


#: the placement pass certifies affinity in the replication factor R, not ω
#: (ω is a fixed inner parameter of the family route): ``omega`` here is the
#: BASE R the tracer varies — R, R+1, R+2
PLACEMENT_CONTRACT = EngineContract(omega=3)

#: fixed re-salt probe bound for the placement target — FIXED while R
#: varies, so each additional replica column adds an identical op count
PLACEMENT_TRACE_MAX_RESALT = 4


def placement_target(engine_name: str, contract: EngineContract, device="cpu") -> Target:
    """The R-way replicated placement pass (DESIGN.md §13),
    ``ops.route_replicas_bulk``: the family route over all R salted key
    families plus the bounded distinct-resolution probes — plain ops on the
    CPU, affine in R; on the card one launch (``place``), flat in R."""
    from repro_torch.core.bulk import PlacementSpec, RouterSpec
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import ops

    k = make_bulk(engine_name).kernels
    keys = keys_for(contract, device)
    fleet = fleet_state(contract.capacity, device=device)

    def tracer(r):
        pspec = PlacementSpec(RouterSpec(engine_name, contract.capacity, 16), r=r,
                              max_resalt=PLACEMENT_TRACE_MAX_RESALT)
        return record(lambda: ops.route_replicas_bulk(keys, fleet, pspec), kernels=[k],
                      sync_check=_on_card(device))

    return Target("placement/route_replicas", tracer, {},
                  launches={"place": 1} if _on_card(device) else None)


def load_pass_target(engine_name: str, contract: EngineContract, device="cpu") -> Target:
    """The observability-instrumented route (DESIGN.md §15),
    ``ops.route_load_bulk`` at the monitor's default bulk-batch sampling
    (``LoadConfig().sample_shift``): the route plus one per-shard count — a
    ``bincount`` held to ``minlength=capacity`` in the plain version, the
    same launch on the card."""
    from repro_torch.core.bulk import RouterSpec
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import ops
    from repro_torch.observability.load import LoadConfig

    k = make_bulk(engine_name).kernels
    keys = keys_for(contract, device)
    fleet = fleet_state(contract.capacity, device=device)
    counts = torch.zeros(contract.capacity, dtype=torch.int32, device=device)
    shift = LoadConfig().sample_shift

    def tracer(om):
        spec = RouterSpec(engine_name, contract.capacity, om)
        return record(lambda: ops.route_load_bulk(keys, fleet, counts, spec, sample_shift=shift),
                      kernels=[k], sync_check=_on_card(device))

    return Target("observability/load_pass", tracer, {},
                  launches={"route_load": 1} if _on_card(device) else None)


def certify_lifecycle_route(engine_name: str, contract=None, device="cpu") -> TargetReport:
    contract = contract or contract_for(engine_name)
    return _certify(engine_name, lifecycle_target(engine_name, contract, device), contract)


def certify_streaming_route(engine_name: str, contract=None, device="cpu") -> TargetReport:
    contract = contract or contract_for(engine_name)
    return _certify(engine_name, streaming_target(engine_name, contract, device), contract)


def certify_placement_route(engine_name: str, contract=None, device="cpu") -> TargetReport:
    contract = contract or PLACEMENT_CONTRACT
    return _certify(engine_name, placement_target(engine_name, contract, device), contract)


def certify_load_pass(engine_name: str, contract=None, device="cpu") -> TargetReport:
    contract = contract or contract_for(engine_name)
    return _certify(engine_name, load_pass_target(engine_name, contract, device), contract)


def certify_chain_baseline(contract: Optional[EngineContract] = None, device="cpu") -> TargetReport:
    """Certify the paper-faithful chain-mode remap — the one datapath that
    legitimately walks a data-dependent loop, passing only through its
    explicit ``constant_time_waiver`` (remove the marker and the gate goes
    red).  Its walk reads ``bool(active.any())`` each round: item reads,
    which on the card synchronise, and are ``while-free``'s finding only."""
    from repro_torch.core.memento_torch import memento_remap

    contract = contract or EngineContract()
    keys = keys_for(contract, device)
    buckets = (keys.to(torch.int64) & 7).to(torch.int32)  # base buckets in [0, 8)
    mask = torch.zeros(contract.capacity, dtype=torch.bool, device=device)
    mask[[1, 3, 5]] = True
    n_total = torch.tensor(8, dtype=torch.int32, device=device)
    first = torch.tensor(0, dtype=torch.int32, device=device)

    def tracer(_om):
        return record(lambda: memento_remap(keys, buckets, mask, n_total, first),
                      sync_check=_on_card(device))

    return certify_callable(
        "binomial",
        "chain/memento_remap",
        tracer,
        contract=contract,
        waivers=waivers_of(memento_remap),
        check_affine=False,  # the chain is while-bounded, not ω-unrolled
    )


def certify_all(
    engines: Optional[Iterable[str]] = None, *, include_chain_baseline: bool = True,
    device="cpu",
) -> Report:
    """Layer-1 certification of every (or the named) registered engine on
    ``device`` (``"cpu"``: the plain versions, ``/cuda`` targets skipped;
    ``"cuda"``: every target, the composite ones through the kernels)."""
    from repro_torch.core.registry import BULK_ENGINES

    names = list(engines) if engines is not None else sorted(BULK_ENGINES)
    report = Report()
    for name in names:
        report.targets.extend(certify_engine(name, device=device))
        report.targets.append(certify_lifecycle_route(name, device=device))
        report.targets.append(certify_placement_route(name, device=device))
        report.targets.append(certify_streaming_route(name, device=device))
        report.targets.append(certify_load_pass(name, device=device))
    if include_chain_baseline:
        report.targets.append(certify_chain_baseline(device=device))
    return report
