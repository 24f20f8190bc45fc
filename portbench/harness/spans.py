"""The port's own spans in a traced run: the stages that ``BatchRouter`` and
``StorePlacement`` record into a ``SpanTrace`` attached as the router's
``tracer`` (``repro_torch.observability.trace``), read where the work
happens.

The window's program is gone once the reference has checked it, so the
readers of these metrics drive a stretch of their own, once a run, on a
program built, started and warmed up as the window's was, over the same
key pool and the same schedule of fleet events.  It has two phases, each
with a fresh tracer:

* spans alone: the tracer's running totals by stage name (count and ns),
  which the per-layer metrics read as means, with no profiler to slow the
  host down.  Where the window applied bursts of fleet events, the phase
  lasts as long as the window did, so that its means of the bursts' and the
  replans' stages cover as many as the window held (about 40 bursts in
  ``router-1k.storm``, 20 bursts and replans in ``store-r3.degraded``); a
  cell without bursts runs it for ``profile_s``, which holds thousands of
  calls;
* spans under the profiler, for ``profile_s``: the spans mapped onto the
  profiler's clock by
  two anchors (``time.perf_counter_ns`` read around the start and the end
  of one ``record_function`` range, whose two ends the profiler stamps on
  its own clock), so that each idle gap of the card is named by the stage
  the host was in (the stage whose own time, its children's left out,
  covers most of the gap; ``burst``, ``replan`` or ``issue`` from the
  loop's own ranges where no stage overlaps it), the share of the stretch
  in which the card is idle while the host is inside a stage is counted,
  and every launch of a port kernel is checked to lie inside the stage
  that made it.

A port whose router has no ``tracer`` records no spans: ``of`` returns None
and no phase runs, so every reader here returns None.  A stretch that fails
(a batch that raises, or a fault of this module) ends the run: the metrics
it feeds never go missing in silence.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import sys
import time
from pathlib import Path

import torch

from portbench.harness import trace as tracing
from portbench.harness import traffic, window

ANCHOR = "portbench.spans"
#: the host calls the profiler records for a kernel launch
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"})
#: how far (µs) a launch may lie outside its stage on the mapped clock
SLACK_US = 5.0
#: the runtime call of ``torch.cuda.synchronize``, and how many bracket
#: each end of the profiled phase
SYNC = "cudaDeviceSynchronize"
ANCHORS = 5
#: ring entries a phase may fill before the oldest spans are recycled: a
#: window's length of the storm cell records about 400,000
CAPACITY = 1 << 20


@dataclasses.dataclass
class ProgramSpans:
    totals: dict  #: ``{stage: (count, ns)}`` of the spans-alone phase
    call_host_us: float | None  #: the loop's own mean call span then (tracer on)
    recorded: int  #: spans recorded in both phases
    dropped: int  #: of them, recycled out of the ring before they were read
    launches: int  #: port kernel launches on the profiled phase's timeline
    unaligned: int  #: of them, outside the stage that made them
    idle_in_program_pct: float | None  #: None without a device timeline
    #: ``[[stage, seconds, seconds of them the collector ran]]``, the
    #: longest 10 idle gaps
    idle_gaps: list

    def mean(self, stage: str, scale: float):
        """Mean duration of ``stage`` in the spans-alone phase, in ns x
        ``scale``; None where the port recorded none."""
        count, ns = self.totals.get(stage, (0, 0))
        return ns / count * scale if count else None


def of(run) -> ProgramSpans | None:
    """The run's program spans, measured at the first call and kept on the
    run."""
    if "_program_spans" not in vars(run):
        run._program_spans = _measure(run)
    return run._program_spans


def launch_stages() -> frozenset:
    """The stages that launch the port's kernels (a port that records
    spans defines their names)."""
    from repro_torch.observability import trace as port

    return frozenset({port.SPAN_ROUTE_LAUNCH, port.SPAN_PLACE_LAUNCH, port.SPAN_PLAN_DIFF})


def _measure(run) -> ProgramSpans | None:
    workload, device = run.workload, run.device
    program = run.bench.loop(workload["loop"]).Program(run.config, workload, device)
    router = getattr(program, "router", None)
    if not hasattr(router, "tracer"):
        return None
    from repro_torch.observability.trace import SpanTrace

    schedule = traffic.Schedule(run.seed, workload, run.config["replicas"])
    history = window.History()
    start = schedule.start()
    program.apply(start)
    history.bursts.append(start)
    history.states.append(program.state())
    program.warm_up(run.pool)
    on_card = device.type == "cuda"
    timer = window.CudaTimer(workload["in_flight"]) if on_card else window.HostTimer()
    keep = traffic.Reservoir(run.seed, 0)
    loop = window.Loop(program, run.pool, schedule, history, keep, keep, timer,
                       workload["in_flight"])
    seconds = float(workload["profile_s"])
    alone_s = run.window.seconds if run.window.burst_s else seconds

    # what each phase starts with lives to its end, so the collector need
    # not walk it (as the window's set-up is frozen); the stretch unfreezes
    # all of it once done, so that nothing it made outlives it
    router.tracer = alone = SpanTrace(CAPACITY)
    gc.freeze()
    try:
        w = loop.run(alone_s, spans=True)
        router.tracer = profiled = SpanTrace(CAPACITY)
        gc.freeze()
        t = time.perf_counter()
        events, anchors, pauses, traced = _profiled(loop, seconds, on_card)
    finally:
        router.tracer = None
        gc.unfreeze()
    if w.failed or traced.failed:
        raise RuntimeError(f"{w.failed + traced.failed} batches of the program-span stretch "
                           f"failed")
    kernels = tracing.port_kernels(Path(sys.modules["repro_torch"].__file__).resolve().parent)
    found = reduce(events, anchors, profiled.spans(), kernels, pauses)
    spans = ProgramSpans(alone.totals(), run.mean(w.call_s, 1e6), alone.total + profiled.total,
                         alone.dropped + profiled.dropped, *found)
    print(f"portbench: program spans: {w.batches} batches and {len(w.burst_s)} bursts "
          f"({len(run.window.burst_s)} in the window) in {w.seconds:.1f} s alone, then "
          f"{traced.batches} batches profiled, 0 failed, {spans.recorded} spans, dropped "
          f"{spans.dropped}; profiled phase and its reduction {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    print("portbench: program span stages (count, mean us): " + ", ".join(
        f"{n} {c} {ns / c / 1e3:.2f}" for n, (c, ns) in sorted(spans.totals.items()))
        + f"; the loop's call span {spans.call_host_us} us", file=sys.stderr)
    print(f"spans unaligned: {spans.unaligned} of {spans.launches}", file=sys.stderr)
    print(f"portbench: idle gaps by program span: {spans.idle_gaps}", file=sys.stderr)
    return spans


def _profiled(loop, seconds: float, on_card: bool):
    """The loop for ``seconds`` under the profiler -> ``(events, anchors,
    pauses, Window)``: the timeline as ``(name, on_device, start_us, end_us,
    correlation)`` from the profiler's start, ``((host ns, profiler µs),
    (host ns, profiler µs))`` at the stretch's two ends, and the host ns
    ``(start, end)`` of each pass of Python's garbage collector.

    On the card the anchors are ``ANCHORS + 1`` ``torch.cuda.synchronize``
    calls on an idle card at each end, each bracketed by two host clock
    readings (``_anchor``): the profiler stamps their runtime calls on the
    clock of the launches and the kernels, which is not the clock of its
    host ranges (the two drift apart by up to tens of ppm).  On the CPU the
    anchors are the two ends of one host range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def bracket():
        t0 = time.perf_counter_ns()
        if on_card:
            torch.cuda.synchronize()
        return t0, time.perf_counter_ns()

    pauses = []

    def collector(phase, info):
        if phase == "start":
            pauses.append([time.perf_counter_ns(), None])
        elif pauses:
            pauses[-1][1] = time.perf_counter_ns()

    with record_function(ANCHOR + ".warm"):  # the range's ops resolved before the anchors
        bracket()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    gc.callbacks.append(collector)
    try:
        with profile(activities=activities) as prof:
            head = [bracket() for _ in range(ANCHORS)]
            anchor = record_function(ANCHOR)
            anchor.__enter__()
            head.append(bracket())
            try:
                w = loop.run(seconds, spans=True, log=True)
                if on_card:
                    torch.cuda.synchronize()
            finally:
                tail = [bracket()]
                anchor.__exit__(None, None, None)
            tail += [bracket() for _ in range(ANCHORS)]
    finally:
        gc.callbacks.remove(collector)
    pauses = [(a, b) for a, b in pauses if b is not None]
    result = prof.profiler.kineto_results
    origin = result.trace_start_ns()
    events = [(e.name(), e.device_type() == DeviceType.CUDA, (e.start_ns() - origin) / 1e3,
               (e.end_ns() - origin) / 1e3, e.correlation_id()) for e in result.events()]
    ranges = [(a, b) for n, dev, a, b, _ in events if n == ANCHOR and not dev]
    if len(ranges) != 1:
        raise RuntimeError(f"the trace holds {len(ranges)} {ANCHOR} ranges, not one")
    if not on_card:
        return events, ((head[-1][1], ranges[0][0]), (tail[0][0], ranges[0][1])), pauses, w
    syncs = sorted((a, b) for n, dev, a, b, _ in events if not dev and n == SYNC)
    return events, (_anchor(head, syncs, head[-1][1]), _anchor(tail, syncs, tail[0][0])), pauses, w


def _anchor(brackets, calls, host: int) -> tuple:
    """``(host, profiler µs)``: where the host reading ``host`` (ns) falls
    on the profiler's clock.  Each call lies inside its bracket, which
    bounds the offset between the two clocks from both sides; the run of
    ``calls`` whose bounds leave an offset (the profiler and the loop
    synchronise too, so the calls are found by where they lie, not by their
    count) gives it, at the middle of the narrowest range left.  The
    stretch runs from the head anchor's last bracket to the tail's first,
    so the brackets themselves lie outside it."""
    best = None
    for k in range(len(calls) - len(brackets) + 1):
        run = list(zip(brackets, calls[k:k + len(brackets)]))
        lo = max(b - h1 / 1e3 for (_, h1), (_, b) in run)
        hi = min(a - h0 / 1e3 for (h0, _), (a, _) in run)
        if lo <= hi and (best is None or hi - lo < best[1] - best[0]):
            best = lo, hi
    if best is None:
        raise RuntimeError(f"no run of {len(calls)} {SYNC} calls in the trace lies inside the "
                           f"{len(brackets)} anchors' brackets")
    return host, host / 1e3 + (best[0] + best[1]) / 2


def clock_map(anchors):
    """``perf_counter_ns`` -> the profiler's µs, linear through the two
    anchors."""
    (h0, p0), (h1, p1) = anchors
    scale = (p1 - p0) / (h1 - h0)
    return lambda t: p0 + (t - h0) * scale


def reduce(events, anchors, spans, kernels, pauses=()) -> tuple:
    """``events``: the profiled phase's timeline (``_profiled``); ``spans``:
    the tracer's ``NestedSpan``s; ``kernels``: the port's kernel names;
    ``pauses``: the collector's passes on the host clock -> ``(launches,
    unaligned, idle_in_program_pct, idle_gaps)``."""
    to_us = clock_map(anchors)
    w0, w1 = anchors[0][1], anchors[1][1]
    mapped = [(s.name, to_us(s.t_start_ns), to_us(s.t_end_ns), s.span_id, s.parent_id)
              for s in spans]
    device = [(a, b) for n, dev, a, b, _ in events
              if dev and not n.startswith("portbench.") and b > w0 and a < w1]
    busy = tracing._union((max(a, w0), min(b, w1)) for a, b in device)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    roots = tracing._union((a, b) for _, a, b, _, parent in mapped if not parent)
    pct = 100.0 * _overlap(idle, roots) / (w1 - w0) if busy else None
    collected = [(to_us(a), to_us(b)) for a, b in pauses]

    host = [(n.split(".")[1], a, b) for n, dev, a, b, _ in events
            if not dev and n in tracing.HOST_RANGES]
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    named = [[_name_gap(a, b, mapped, roots, host), (b - a) / 1e6,
              _overlap([(a, b)], collected) / 1e6] for a, b in gaps]

    ours = {c for n, dev, _, _, c in events if dev and tracing.kernel_name(n) in kernels}
    launches = [(a, b) for n, dev, a, b, c in events
                if not dev and n in LAUNCH_CALLS and c in ours and w0 <= a <= w1]
    launching = launch_stages()
    stages = sorted((a, b) for n, a, b, _, _ in mapped if n in launching)
    starts = [a for a, _ in stages]
    unaligned = 0
    for a, b in launches:
        i = bisect.bisect_right(starts, a + SLACK_US) - 1
        if i < 0 or b > stages[i][1] + SLACK_US:
            unaligned += 1
    return len(launches), unaligned, pct, named


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two sorted disjoint lists of
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _name_gap(a: float, b: float, mapped, roots, host) -> str:
    """Where the host was inside the port for at least half of ``[a, b]``,
    the stage whose own time (its children's left out) covers most of it;
    else the loop's range that does (``burst``, ``replan``); else
    ``issue``."""
    own: dict = {}
    if 2 * _overlap([(a, b)], roots) < b - a:
        mapped = ()
    for name, sa, sb, sid, parent in mapped:
        o = min(b, sb) - max(a, sa)
        if o > 0:
            own[sid] = [name, own.get(sid, [name, 0.0])[1] + o]
            if parent:
                own.setdefault(parent, [None, 0.0])[1] -= o
    by_name: dict = {}
    for name, o in own.values():
        if name is not None and o > 0:
            by_name[name] = by_name.get(name, 0.0) + o
    if by_name:
        return max(by_name, key=by_name.get)
    overlap: dict = {}
    for n, ra, rb in host:
        o = min(b, rb) - max(a, ra)
        if o > 0:
            overlap[n] = overlap.get(n, 0.0) + o
    return max(overlap, key=overlap.get) if overlap else "issue"
