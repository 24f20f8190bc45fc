"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the check against the reference, and the result.

``run`` is what ``portbench/run.py`` calls once it has found a card.  The
tests call it with ``device="cpu"`` at small sizes (the program's plain
versions, the host's clock), and may put a control or a broken program in
the program's place through ``make_program``.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import torch

from portbench.harness import trace as tracing
from portbench.harness import traffic, window
from portbench.harness.judge import Check
from portbench.harness.registry import Bench

#: top-level modules a run may not hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """Everything a metric's reader and a loop's judge may read."""

    bench: Bench
    cell: str
    seed: int
    device: torch.device
    config: dict
    workload: dict
    call: str
    setup_s: float
    window: window.Window
    history: window.History
    pool: torch.Tensor
    samples: list
    plans: list
    profile: tracing.Profile | None = None

    @staticmethod
    def mean(values, scale: float = 1.0):
        return statistics.fmean(values) * scale if len(values) else None

    def roofline_share(self, call: str):
        """% of the HBM peak that the call's own bytes would take over the
        device time of its kernels in the traced stretch."""
        p = self.profile
        if self.call != call or p is None or not p.kernel_s or not p.counts.get("call"):
            return None
        seconds = p.kernel_s["call"] / p.counts["call"]
        if seconds <= 0:
            return None
        nbytes = self.bench.roofline(call).bytes_per_item(self.config) * self.workload["batch_keys"]
        return 100.0 * nbytes / self.bench.peaks()["hbm_bytes_per_s"] / seconds


def _stats(values, to_ms: float = 1e3) -> str:
    if not len(values):
        return "none"
    ms = sorted(to_ms * x for x in values)
    return f"{len(ms)}: min {ms[0]:.4f} median {ms[len(ms) // 2]:.4f} max {ms[-1]:.4f} ms"


def banned_modules() -> list:
    """The banned top-level modules this process holds, by whole names."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def run(root, cell: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device=None, make_program=None, overrides: dict | None = None) -> tuple:
    """-> ``(result, checks)``.  ``overrides`` replaces traffic parameters
    (the tests' small sizes)."""
    bench = Bench(root)
    workload = {**bench.workload(cell), **(overrides or {})}
    config = bench.config(workload["config"])
    loop_mod = bench.loop(workload["loop"])
    device = torch.device("cuda" if device is None else device)
    on_card = device.type == "cuda"

    pool = traffic.key_pool(seed, workload, device)
    schedule = traffic.Schedule(seed, workload, config["replicas"])
    program = (make_program or loop_mod.Program)(config, workload, device)
    history = window.History()
    start = schedule.start()
    program.apply(start)
    history.bursts.append(start)
    history.states.append(program.state())
    program.warm_up(pool)
    samples = traffic.Reservoir(seed, workload["compare_batches"])
    plans = traffic.Reservoir(seed, workload.get("compare_plans", 0), stream=traffic.SAMPLES + 1)
    timer = window.CudaTimer(workload["in_flight"]) if on_card else window.HostTimer()
    loop = window.Loop(program, pool, schedule, history, samples, plans, timer,
                       workload["in_flight"])
    if on_card:
        torch.cuda.synchronize(device)
    # what set-up made lives to the end: the collector need not walk it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    measured = loop.run(seconds, spans=trace)
    traced = profile = None
    if trace:
        t = time.perf_counter()
        traced, profile = tracing.profiled(loop, float(workload["profile_s"]))
        print(f"portbench: traced stretch and its reduction {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    # the program's state goes before the reference runs
    del loop, program, pool, timer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record = Run(bench, cell, seed, device, config, workload, loop_mod.CALL, setup_s, measured,
                 history, traffic.key_pool(seed, workload, device), samples.items, plans.items,
                 profile)
    print(f"portbench: window {measured.batches} batches, latency {_stats(measured.latencies_ms, 1)}; "
          f"bursts {_stats(measured.burst_s)}; replans {_stats(measured.replan_s)}", file=sys.stderr)
    t = time.perf_counter()
    checks = loop_mod.judge(record)
    if profile is not None:
        # a roofline attributes the port's kernels to the calls by the
        # launch counters: a count that disagrees with the timeline is a fault
        checks.append(Check("traced_kernels_unmatched", profile.unmatched, 0))
    print(f"portbench: set-up {setup_s:.1f} s, window {measured.seconds:.1f} s, reference "
          f"check {time.perf_counter() - t:.1f} s", file=sys.stderr)
    failed = measured.failed + (traced.failed if traced else 0)

    metrics = {}
    for m in bench.metrics(cell, trace):
        value = bench.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if profile is not None:
        dev.update(busy_s=profile.busy_s, window_s=profile.window_s)
    result = {
        "correct": failed == 0 and all(c.ok for c in checks),
        "attempted": measured.batches + measured.failed + (traced.batches + traced.failed
                                                           if traced else 0),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if profile is not None:
        result["breakdown"] = {"device_ops": profile.device_ops, "idle_gaps": profile.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "bound": "min" if c.at_least else "max"} for c in checks}
    return result, checks
