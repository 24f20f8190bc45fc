"""The traced stretch: the loop run on under ``torch.profiler`` after the
measured window, and what the harness reads from the device's timeline.

* busy: the union of every kernel, copy and fill on the card, inside the
  stretch; idle is the rest;
* device operations by name, and the longest idle gaps, each named by
  what the host was doing then (a burst, a replan, or issuing batches);
* the port's kernels of each call: the card runs one stream's kernels in
  issue order, so the i-th of the port's kernels on the timeline is the
  i-th launch the host logged from the port's launch counters, and the
  launches of each call and replan are counted around it.  The port's
  kernels are the functions its own sources declare (``port_kernels``),
  in CUDA C++ or Triton, the two ways the port may write one, so a kernel
  added or renamed there is found without a change here.
  Where the timeline and the counters disagree, nothing is attributed and
  the run reports the difference as a failed check.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import torch

WINDOW = "portbench.window"
HOST_RANGES = ("portbench.burst", "portbench.replan")
_CUDA_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON_KERNEL = re.compile(r"@triton\.jit\b[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def port_kernels(package: Path) -> frozenset:
    """Names of the hand-written kernels under ``package``: every
    ``__global__`` function of its CUDA sources and every ``@triton.jit``
    function of its Python modules."""
    names = set()
    for path in package.rglob("*"):
        if path.suffix in (".cu", ".cuh"):
            names.update(_CUDA_KERNEL.findall(path.read_text()))
        elif path.suffix == ".py":
            names.update(_TRITON_KERNEL.findall(path.read_text()))
    return frozenset(names)


def kernel_name(name: str) -> str:
    """A timeline's kernel name without its return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split()[-1].split("::")[-1] if name.split() else name


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    device_ops: list  #: [[name, seconds]] by total time, at most 10
    idle_gaps: list  #: [[what the host did, seconds]], the longest 10
    #: device seconds of the port's kernels of each kind of logged work
    #: (``{"call": s, "replan": s}``) and the count of each; None where the
    #: timeline's kernels and the logged launches disagree
    kernel_s: dict | None
    counts: dict
    #: port kernels on the timeline less the launches logged, or the reverse
    unmatched: int


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _short(name: str) -> str:
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def reduce(events, log: list, kernels: frozenset) -> Profile:
    """``events``: ``(name, on_device, start_us, end_us)`` of the profiler's
    timeline; ``log``: the ``(kind, launches)`` the loop logged;
    ``kernels``: the port's kernel names (``port_kernels``)."""
    host = [(n, a, b) for n, dev, a, b in events if not dev]
    windows = [(a, b) for n, a, b in host if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} ranges, not one")
    w0, w1 = windows[0]
    device = [(n, max(a, w0), min(b, w1)) for n, dev, a, b in events
              if dev and not n.startswith("portbench.") and b > w0 and a < w1]
    busy = _union((a, b) for _, a, b in device)
    busy_us = sum(b - a for a, b in busy)

    by_name: dict = {}
    for n, a, b in device:
        by_name[_short(n)] = by_name.get(_short(n), 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    ranges = [(n.split(".")[1], a, b) for n, a, b in host if n in HOST_RANGES]
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        overlap = {}
        for n, ra, rb in ranges:
            o = min(b, rb) - max(a, ra)
            if o > 0:
                overlap[n] = overlap.get(n, 0.0) + o
        what = max(overlap, key=overlap.get) if overlap else "issue"
        gaps.append([what, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])

    ours = sorted((a, b) for n, a, b in device if kernel_name(n) in kernels)
    counts: dict = {}
    for kind, _ in log:
        counts[kind] = counts.get(kind, 0) + 1
    unmatched = abs(len(ours) - sum(n for _, n in log))
    kernel_s = None
    if not unmatched:
        kernel_s, i = {kind: 0.0 for kind in counts}, 0
        for kind, n in log:
            kernel_s[kind] += sum(b - a for a, b in ours[i:i + n]) / 1e6
            i += n
    return Profile((w1 - w0) / 1e6, busy_us / 1e6, [[n, s] for n, s in ops], gaps[:10],
                   kernel_s, counts, unmatched)


def profiled(loop, seconds: float):
    """Run ``loop`` for ``seconds`` under the profiler -> ``(Window,
    Profile)``."""
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    kernels = port_kernels(Path(repro_torch.__file__).resolve().parent)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            window = loop.run(seconds, spans=True, log=True)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    events = [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    return window, reduce(events, window.log, kernels)
