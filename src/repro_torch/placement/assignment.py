"""Key -> node assignment tables and movement accounting — the counterpart
of ``repro.placement.assignment`` (host-side, numpy).

The control-plane face of the paper: given a set of logical keys (data
shards, experts, checkpoint shards, sessions) and a cluster size, produce the
assignment and — on resize — the minimal movement plan, with stats checked
against the paper's guarantees (movement fraction ~ delta/n).

``MovementPlan`` is the ONE movement-accounting type: a thin view over a
before/after placement diff (``from_diff`` — host arrays here, the device
migration diff in ``repro_torch.placement.store``), with the eager ``Move``
list materialised lazily on demand.  (The reference's deprecated eager
constructor ``MovementPlan(moves, total_keys)`` is not carried over.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.registry import make


@dataclass(frozen=True)
class Move:
    key: int
    src: int
    dst: int


class MovementPlan:
    """Movement accounting over a before/after placement diff.

    Build with ``MovementPlan.from_diff(keys, before, after)`` — arrays in,
    vectorised stats out; ``moves`` materialises the eager ``Move`` list
    only when asked.  ``moved`` defaults to positional inequality (the
    1-way assignment semantics); the R-way device diff passes its
    membership-based transfer mask instead, so both tiers share one
    accounting type.
    """

    def __init__(self, *, keys, before, after, moved=None):
        self._keys = np.asarray(keys)
        self._before = np.asarray(before)
        self._after = np.asarray(after)
        if moved is None:
            moved = self._before != self._after
        self._moved = np.asarray(moved, bool)
        self._moves: list[Move] | None = None
        self.total_keys = int(self._keys.size)

    @classmethod
    def from_diff(cls, keys, before, after, moved=None) -> "MovementPlan":
        """Per-key placements before/after (any array-likes of equal
        length), optional explicit transfer mask."""
        return cls(keys=keys, before=before, after=after, moved=moved)

    # -- accounting ----------------------------------------------------------
    @property
    def moved_count(self) -> int:
        return int(self._moved.sum())

    @property
    def moves(self) -> list[Move]:
        if self._moves is None:
            idx = np.nonzero(self._moved)[0]
            self._moves = [
                Move(int(self._keys[i]), int(self._before[i]), int(self._after[i]))
                for i in idx
            ]
        return self._moves

    @property
    def moved_fraction(self) -> float:
        return self.moved_count / max(self.total_keys, 1)

    def destinations(self) -> set[int]:
        return set(np.unique(self._after[self._moved]).tolist())

    def sources(self) -> set[int]:
        return set(np.unique(self._before[self._moved]).tolist())


class Assignment:
    """Consistent assignment of a fixed key universe onto n nodes."""

    def __init__(self, keys: Sequence[int], n: int, engine: str = "binomial"):
        self.keys = list(keys)
        self.engine_name = engine
        self.engine = make(engine, n)

    @property
    def n(self) -> int:
        return self.engine.size

    def table(self) -> dict[int, int]:
        return {k: self.engine.get_bucket(k) for k in self.keys}

    def by_node(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {b: [] for b in range(self.n)}
        for k in self.keys:
            out[self.engine.get_bucket(k)].append(k)
        return out

    def resize(self, new_n: int) -> MovementPlan:
        """Scale to new_n (LIFO adds/removes), returning the movement plan."""
        before = self.table()
        while self.engine.size < new_n:
            self.engine.add_bucket()
        while self.engine.size > new_n:
            self.engine.remove_bucket()
        after = self.table()
        return MovementPlan.from_diff(
            np.asarray(self.keys, dtype=np.uint64),
            np.fromiter((before[k] for k in self.keys), np.int64, count=len(self.keys)),
            np.fromiter((after[k] for k in self.keys), np.int64, count=len(self.keys)),
        )

    def load(self) -> list[int]:
        return [len(v) for v in self.by_node().values()]
