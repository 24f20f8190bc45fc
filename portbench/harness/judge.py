"""What decides ``correct``: numbers, each held to its limit.  The loops
compute them from the plain reference; this module holds what they share.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: keys the reference takes at a time, so that its int64 temporaries fit
#: beside what the run keeps
BLOCK = 1 << 21


@dataclasses.dataclass
class Check:
    """``value`` must be at most ``limit`` (or, with ``at_least``, at
    least it)."""

    name: str
    value: int | float
    limit: int | float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        return self.value >= self.limit if self.at_least else self.value <= self.limit

    def line(self) -> str:
        return f"{self.name} {self.value} {'>=' if self.at_least else '<='} {self.limit}"


def state_diffs(program_states, reference_states, capacity: int) -> Check:
    """Epochs at which the program's fleet state on the device (removed-slot
    words, table, ``[n_total, n_alive]``) differs from the state the
    reference rebuilt from the same events."""
    if len(program_states) != len(reference_states):
        return Check("fleet_state_diffs", abs(len(program_states) - len(reference_states)) or 1, 0)
    bad = 0
    for got, want in zip(program_states, reference_states):
        parts = [np.asarray(p.cpu()).reshape(-1).view(np.int32) for p in got]
        bad += any(g.shape != w.shape or not np.array_equal(g, w)
                   for g, w in zip(parts, want.packed(capacity)))
    return Check("fleet_state_diffs", bad, 0)


def blocks(n: int):
    for lo in range(0, n, BLOCK):
        yield lo, min(n, lo + BLOCK)
