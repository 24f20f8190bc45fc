"""The closed loop: ``in_flight`` batches outstanding, the next issued as
soon as the oldest is seen complete; the bursts of fleet events on their
cadence between two issues.

A batch's latency runs from the moment it is issued to the moment the card
finishes it, both read on the card's clock: a marker event recorded on an
idle side stream when the host issues the batch, and an event recorded on
the work stream behind the batch.  The host's clock reads a whole window
only, never one batch.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
import traceback
from array import array
from contextlib import nullcontext

import torch


@dataclasses.dataclass
class Window:
    """What one stretch of the loop did."""

    seconds: float = 0.0  #: host clock, first issue to last completion
    batches: int = 0
    items: int = 0
    failed: int = 0
    latencies_ms: array = dataclasses.field(default_factory=lambda: array("d"))
    #: spans (traced runs): host seconds of each batch call, and the
    #: launches the calls made
    call_s: array = dataclasses.field(default_factory=lambda: array("d"))
    call_launches: int = 0
    burst_s: list = dataclasses.field(default_factory=list)
    replan_s: list = dataclasses.field(default_factory=list)
    #: (kind, launches) of every call and replan, in issue order (traced)
    log: list | None = None


class CudaTimer:
    """Issue and completion marks on the card's clock."""

    def __init__(self, depth: int):
        self.side = torch.cuda.Stream()
        self.free = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                     for _ in range(depth + 1)]

    def issue(self):
        pair = self.free.pop()
        pair[0].record(self.side)
        return pair

    def done(self, pair) -> None:
        pair[1].record()

    def drop(self, pair) -> None:
        self.free.append(pair)

    def latency_ms(self, pair) -> float:
        pair[1].synchronize()
        pair[0].synchronize()
        self.free.append(pair)
        return pair[0].elapsed_time(pair[1])


class HostTimer:
    """The CPU's stand-in (tests only: the CPU runs each call to its end)."""

    def issue(self):
        return time.perf_counter()

    def done(self, mark) -> None:
        pass

    def drop(self, mark) -> None:
        pass

    def latency_ms(self, mark) -> float:
        return (time.perf_counter() - mark) * 1e3


class Loop:
    """Drives ``program`` over the batches of ``pool``; ``schedule`` gives the bursts and
    ``history`` records every burst applied and the program's fleet state
    after it, so that epoch ``e`` (the count of bursts applied before a
    batch was issued) names the state the batch was routed under."""

    def __init__(self, program, pool, schedule, history, samples, plans, timer, in_flight: int):
        self.program = program
        self.batches = list(pool)  # one view a batch, made once
        self.schedule = schedule
        self.history = history
        self.samples = samples
        self.plans = plans
        self.timer = timer
        self.in_flight = in_flight
        self.issued = 0

    def apply(self, events, window: Window, ranges: bool) -> None:
        """One burst through the program's lifecycle, then its replan, if
        the loop has one."""
        rf = _range if ranges else _no_range
        t = time.perf_counter()
        with rf("portbench.burst"):
            token = self.program.apply(events)
        window.burst_s.append(time.perf_counter() - t)
        self.history.bursts.append(events)
        self.history.states.append(self.program.state())
        after = getattr(self.program, "after_burst", None)
        if after is None:
            return
        l0 = self.program.launches()
        t = time.perf_counter()
        with rf("portbench.replan"):
            plan = after(token)
        window.replan_s.append(time.perf_counter() - t)
        if window.log is not None:
            window.log.append(("replan", self.program.launches() - l0))
        self.plans.offer((len(self.history.bursts) - 1, plan))

    def run(self, seconds: float, *, spans: bool = False, log: bool = False) -> Window:
        w = Window(log=[] if log else None)
        inflight = collections.deque()
        every = self.schedule.every_s
        t0 = time.perf_counter()
        end, due = t0 + seconds, (t0 + every if every else float("inf"))
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if now >= due:
                self.apply(self.schedule.burst(), w, ranges=log)
                due += every
                continue
            if len(inflight) >= self.in_flight:
                w.latencies_ms.append(self.timer.latency_ms(inflight.popleft()))
            self._issue(w, inflight, spans)
        while inflight:
            w.latencies_ms.append(self.timer.latency_ms(inflight.popleft()))
        w.seconds = time.perf_counter() - t0
        return w

    def _issue(self, w: Window, inflight, spans: bool) -> None:
        index = self.issued % len(self.batches)
        keys = self.batches[index]
        epoch = len(self.history.bursts) - 1
        mark = self.timer.issue()
        if spans:
            l0 = self.program.launches()
            t = time.perf_counter()
        try:
            out = self.program.call(keys)
        except Exception:  # a failed call is counted, and its cause shown once
            if not w.failed:
                traceback.print_exc(file=sys.stderr)
            w.failed += 1
            self.timer.drop(mark)
            return
        if spans:
            w.call_s.append(time.perf_counter() - t)
            launched = self.program.launches() - l0
            w.call_launches += launched
            if w.log is not None:
                w.log.append(("call", launched))
        self.timer.done(mark)
        inflight.append(mark)
        self.samples.offer((epoch, index, out))
        self.issued += 1
        w.batches += 1
        w.items += keys.numel()


@dataclasses.dataclass
class History:
    bursts: list = dataclasses.field(default_factory=list)
    states: list = dataclasses.field(default_factory=list)


def _range(name: str):
    return torch.profiler.record_function(name)


def _no_range(name: str):
    return nullcontext()
