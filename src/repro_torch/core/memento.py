"""Memento-style wrapper: arbitrary (non-LIFO) node removal on top of any
LIFO consistent-hash engine.

The BinomialHash paper (§1, §7) notes that all constant-time LIFO algorithms
"can be extended to handle arbitrary node removals and random failures by
leveraging the procedure described in MementoHash".  This module implements
that composition with a MementoHash-style replacement table (DESIGN.md §7):

* the base engine addresses the full slot space ``[0, n_total)``;
* the removed/failed slots are recorded in an O(#removed) set, and the
  ``ReplacementTable`` keeps a permutation of the slot space whose prefix is
  exactly the alive slots, updated O(1) per fleet event;
* a lookup that lands on a removed slot is diverted through the table in AT
  MOST TWO u32-hash redirects, so storm-time lookup cost is a hard constant.

This is the semantics of the serving datapath
(``repro_torch.serving.batch_router.BatchRouter``): the device kernels
implement the same math on an uploaded copy of the table, and this module
is their scalar oracle.  Pair it with a u32 base engine (``binomial32``,
``jump32``) so the whole lookup+divert path shares one word size.  (The
JAX package also keeps the paper-faithful rejection-chain resolution; the
port has no caller for it.)
"""
from __future__ import annotations

from repro_torch.core import bits


class ReplacementTable:
    """Permutation of the slot space ``[0, n_total)`` with an alive prefix.

    Invariants (maintained O(1) per event by swap):
    * ``slots`` is a permutation of ``[0, n_total)``; ``pos`` is its inverse;
    * ``slots[0:n_alive]`` are exactly the alive slots;
    * ``slots[n_alive:]`` are exactly the removed slots.

    Lookup for a key whose base bucket ``b`` is removed (``resolve``):

    1. ``q = mulhi32(hash_pair(key, b), n_total)`` — the Lemire
       reduction maps the u32 hash uniformly onto the position space
       (a multiply-high and no integer divide).  If
       ``q < n_alive`` the redirect lands alive and we are done
       (probability ``n_alive / n_total``).
    2. otherwise ONE more redirect, ``q = mulhi32(mix32(h ^ q*GOLDEN32),
       n_alive)`` — uniform over the alive prefix, alive by construction.
       It chains off the first hash ``h`` and is seeded by the *position*
       q, so no extra mixing of the key is spent on the deep round: one
       fmix32 over the already-avalanched ``h`` suffices.

    One ``slots`` gather, two u32 hashes, zero data-dependent iteration:
    the device kernels implement the identical math on an uploaded copy of
    ``slots`` (see ``repro_torch.core.memento_torch``), so storm-time cost matches
    steady-time cost.  Redirect 1's range is ``n_total`` — a *scalar*
    frozen across fail/recover events (only scale events change it) — so a
    failure or recovery re-aims only the redirected keys whose picked
    position was one of the (at most two) positions the event swapped,
    plus the second-order deep rounds: approximately minimal disruption,
    like the rejection chain, without its data-dependent walk and without
    a per-lane ``pos`` gather on the hot path.
    """

    def __init__(self, n: int):
        self.slots = list(range(n))
        self.pos = list(range(n))
        self.n_alive = n

    @property
    def n_total(self) -> int:
        return len(self.slots)

    def _swap(self, i: int, j: int) -> None:
        si, sj = self.slots[i], self.slots[j]
        self.slots[i], self.slots[j] = sj, si
        self.pos[si], self.pos[sj] = j, i

    def fail(self, b: int) -> None:
        """Alive slot b fails: swap it to the alive/removed boundary."""
        if self.pos[b] >= self.n_alive:
            raise ValueError(f"slot {b} is not alive")
        self._swap(self.pos[b], self.n_alive - 1)
        self.n_alive -= 1

    def recover(self, b: int) -> None:
        """Removed slot b recovers: swap it back into the alive prefix."""
        if self.pos[b] < self.n_alive:
            raise ValueError(f"slot {b} is not removed")
        self._swap(self.pos[b], self.n_alive)
        self.n_alive += 1

    def append(self) -> int:
        """LIFO scale-up: new slot id ``n_total`` joins the alive prefix."""
        t = len(self.slots)
        self.slots.append(t)
        self.pos.append(t)
        self._swap(t, self.n_alive)
        self.n_alive += 1
        return t

    def pop_last(self) -> int:
        """LIFO scale-down: slot id ``n_total - 1`` (alive or a tombstone)
        leaves the slot space entirely."""
        t = len(self.slots) - 1
        if self.pos[t] < self.n_alive:  # alive: retire via the boundary
            self._swap(self.pos[t], self.n_alive - 1)
            self.n_alive -= 1
        self._swap(self.pos[t], t)  # park at the last position, then drop
        self.slots.pop()
        self.pos.pop()
        return t

    def resolve(self, key: int, b: int) -> int:
        """Divert ``key`` off removed slot ``b`` — at most two redirects.

        ``key`` is masked to u32; the hashes are the same murmur3 fmix32
        pair/iter mixers as the device kernels (bit-exact by construction).
        """
        key &= bits.MASK32
        h = bits.hash_pair32(key, b)
        q = bits.mulhi32(h, self.n_total)
        if q >= self.n_alive:
            # chain the second hash off the first — h is already avalanched,
            # so one fmix32 over h xor the golden-scaled position suffices
            q = bits.mulhi32(
                bits.mix32((h ^ ((q * bits.GOLDEN32) & bits.MASK32)) & bits.MASK32),
                self.n_alive,
            )
        return self.slots[q]


class MementoWrapper:
    name = "memento"
    exact = False  # reconstruction of the published description

    def __init__(self, base_factory, n: int):
        """``base_factory(n) -> engine`` builds the underlying LIFO engine.

        The LAST alive bucket may fail too (the slot space never shrinks
        below one slot — the removal is tombstoned, so recovery works): an
        all-failed fleet is a queryable *state* (``size == 0``; lookups
        raise), not a forbidden transition.  The serving tier answers
        routes on it with a typed ``FleetUnavailableError`` rather than
        refusing the failure event itself, which no real outage asks
        permission for.
        """
        self._base_factory = base_factory
        self.base = base_factory(n)
        self.removed: set[int] = set()
        self.table = ReplacementTable(n)

    # -- size/state ---------------------------------------------------------
    @property
    def n_total(self) -> int:
        return self.base.size

    @property
    def size(self) -> int:
        return self.base.size - len(self.removed)

    def alive(self) -> list[int]:
        return [b for b in range(self.n_total) if b not in self.removed]

    # -- membership ---------------------------------------------------------
    def add_bucket(self) -> int:
        """LIFO append of a brand-new slot (scale-up)."""
        out = self.base.add_bucket()
        self.table.append()
        return out

    def remove_bucket(self, b: int | None = None) -> int:
        """Remove an arbitrary bucket (failure) or the last one (LIFO)."""
        if self.size <= 1:
            if self.size == 0:
                raise ValueError("no alive buckets left to remove")
            # the last alive bucket fails: tombstone it (even when it is the
            # last slot id — a LIFO shrink here would empty the slot space,
            # and the fixed-capacity device operands need n_total >= 1)
            last = self.n_total - 1 if b is None else b
            if last in self.removed or not (0 <= last < self.n_total):
                raise ValueError(f"bucket {last} is not alive")
            self.removed.add(last)
            self.table.fail(last)
            return last
        if b is None or b == self.n_total - 1:
            # true LIFO removal — shrink the base engine; also garbage-collect
            # any tombstones that fall off the end.
            out = self.base.remove_bucket()
            self.removed.discard(out)
            self.table.pop_last()
            while self.n_total - 1 in self.removed and self.n_total > 1:
                self.removed.discard(self.n_total - 1)
                self.base.remove_bucket()
                self.table.pop_last()
            return out
        if b in self.removed or not (0 <= b < self.n_total):
            raise ValueError(f"bucket {b} is not alive")
        self.removed.add(b)
        self.table.fail(b)
        return b

    def restore_bucket(self, b: int) -> None:
        """A failed node recovered."""
        if b not in self.removed:
            raise ValueError(f"bucket {b} is not removed")
        self.removed.discard(b)
        self.table.recover(b)

    # -- lookup -------------------------------------------------------------
    def get_bucket(self, key: int) -> int:
        if not self.size:
            # every bucket is a tombstone: there
            # is no alive target — the serving layer turns this into a
            # typed FleetUnavailableError before any lookup gets here
            raise ValueError("no alive buckets")
        b = self.base.get_bucket(key)
        if b not in self.removed:
            return b
        return self.table.resolve(key, b)
