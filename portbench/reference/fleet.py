"""The fleet's removed set and replacement table, rebuilt from the event
sequence alone.

The table is a permutation of the slot space whose prefix holds exactly
the alive slots.  A failure swaps its slot to the end of the alive prefix
and shrinks the prefix; a recovery swaps it to the first position past the
prefix and grows it.  The benchmark's traffic fails and recovers slots
other than the last one only, so the slot space keeps its size (a removal
of the last slot is a scale-down, a different event).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FAIL = "fail"
RECOVER = "recover"


@dataclasses.dataclass
class Tensors:
    """One fleet state as the reference reads it, on one device."""

    removed: torch.Tensor  #: (n_total,) bool
    slots: torch.Tensor  #: (n_total,) int64, the alive prefix first
    n_total: int
    n_alive: int


class Fleet:
    """Slots ``0 .. n - 1``; ``apply`` takes ``(kind, slot)`` events."""

    def __init__(self, n: int):
        self.slots = list(range(n))
        self.pos = list(range(n))
        self.n_alive = n
        self.removed: set[int] = set()

    @property
    def n_total(self) -> int:
        return len(self.slots)

    def _swap(self, i: int, j: int) -> None:
        si, sj = self.slots[i], self.slots[j]
        self.slots[i], self.slots[j] = sj, si
        self.pos[si], self.pos[sj] = j, i

    def apply(self, kind: str, slot: int) -> None:
        if not 0 <= slot < self.n_total - 1:
            raise ValueError(f"slot {slot}: the traffic fails and recovers slots below the last")
        if kind == FAIL:
            if slot in self.removed:
                raise ValueError(f"slot {slot} is already failed")
            self._swap(self.pos[slot], self.n_alive - 1)
            self.n_alive -= 1
            self.removed.add(slot)
        elif kind == RECOVER:
            if slot not in self.removed:
                raise ValueError(f"slot {slot} is not failed")
            self._swap(self.pos[slot], self.n_alive)
            self.n_alive += 1
            self.removed.discard(slot)
        else:
            raise ValueError(f"unknown event {kind!r}")

    def alive_slots(self) -> list[int]:
        return sorted(set(range(self.n_total)) - self.removed)

    def tensors(self, device) -> Tensors:
        removed = torch.zeros(self.n_total, dtype=torch.bool)
        removed[sorted(self.removed)] = True
        return Tensors(removed.to(device), torch.tensor(self.slots, dtype=torch.int64, device=device),
                       self.n_total, self.n_alive)

    def packed(self, capacity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The state in the routing tier's stated layout: removed-slot bit
        words ``(capacity / 32,)``, the table ``(capacity,)`` (zeros past
        the slot space) and ``[n_total, n_alive]``, each as int32."""
        words = np.zeros(max(1, -(-capacity // 32)), dtype=np.uint32)
        for b in self.removed:
            words[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        table = np.zeros(capacity, dtype=np.int32)
        table[: self.n_total] = self.slots
        state = np.array([self.n_total, self.n_alive], dtype=np.int32)
        return words.view(np.int32), table, state


def replay(n: int, bursts) -> list[Fleet]:
    """The fleet after each burst of ``bursts`` (a list of event lists), in
    order: element ``e`` is the state epoch ``e`` routes under."""
    fleet, states = Fleet(n), []
    for burst in bursts:
        for kind, slot in burst:
            fleet.apply(kind, slot)
        snap = Fleet.__new__(Fleet)
        snap.slots, snap.pos = list(fleet.slots), list(fleet.pos)
        snap.n_alive, snap.removed = fleet.n_alive, set(fleet.removed)
        states.append(snap)
    return states
