"""Epoch-stamped membership journal: append-only fleet-event log + replay —
the counterpart of ``repro.serving.lifecycle.journal`` (pure Python; its
JSON text is byte-identical to the reference's).

The replacement-table control plane (``FailureDomain`` over
``MementoWrapper``/``ReplacementTable``) is a deterministic state machine:
its state is a pure function of the initial fleet size and the ordered
fail/recover/scale event stream.  This module makes that explicit:

* ``MembershipJournal`` — the append-only log.  Every fleet event gets a
  strictly increasing **epoch** (1-based; epoch 0 is the genesis fleet).
  The journal serialises to JSON lines, so "crash" means: keep the text,
  lose every live object.
* ``replay(journal, factory)`` — rebuild the domain by re-applying the
  event stream from genesis.  Bit-exact: the rebuilt
  ``ReplacementTable.slots/pos/n_alive``, the removed set and the packed
  device operands (``FleetState.pack``) all equal the live ones, for
  arbitrary event streams (tested against the reference).
* ``JournalSnapshot`` / ``restore(snapshot, factory)`` — O(n) state capture
  so recovery does not have to replay from genesis: restore the snapshot,
  then replay only ``journal.events(since=snapshot.epoch)``.  Crash at ANY
  event index i: ``restore(snap_i) + replay(tail_i)`` == full replay ==
  live state (the crash-equivalence property).

Scale-up events record the slot id the control plane assigned so replay can
*verify* determinism instead of assuming it; scale-down records the retired
id the same way.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Iterable

#: the four membership transitions the control plane knows
EVENT_KINDS = ("fail", "recover", "scale_up", "scale_down")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One journaled fleet event.

    ``slot`` is the failed/recovered replica for fail/recover, the assigned
    id for scale_up and the retired id for scale_down (recorded, and checked
    on replay — LIFO determinism is an invariant, not an assumption).
    """

    epoch: int
    kind: str
    slot: int

    def to_json(self) -> str:
        return json.dumps(
            {"epoch": self.epoch, "kind": self.kind, "slot": self.slot},
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, line: str) -> "MembershipEvent":
        d = json.loads(line)
        return cls(epoch=int(d["epoch"]), kind=str(d["kind"]), slot=int(d["slot"]))


@dataclasses.dataclass(frozen=True)
class JournalSnapshot:
    """Deep capture of the control-plane state at one epoch.

    Everything ``restore`` needs to rebuild a ``FailureDomain`` without
    replaying from genesis: the slot-space size, the replacement-table
    permutation + inverse + alive count, and the removed set.
    """

    epoch: int
    n_total: int
    n_alive: int
    slots: tuple[int, ...]
    pos: tuple[int, ...]
    removed: tuple[int, ...]

    @classmethod
    def capture(cls, epoch: int, domain) -> "JournalSnapshot":
        rt = domain.replacement_table
        return cls(
            epoch=epoch,
            n_total=domain.total_count,
            n_alive=rt.n_alive,
            slots=tuple(rt.slots),
            pos=tuple(rt.pos),
            removed=tuple(sorted(domain.removed)),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "JournalSnapshot":
        d = json.loads(line)
        return cls(
            epoch=int(d["epoch"]),
            n_total=int(d["n_total"]),
            n_alive=int(d["n_alive"]),
            slots=tuple(int(s) for s in d["slots"]),
            pos=tuple(int(p) for p in d["pos"]),
            removed=tuple(int(r) for r in d["removed"]),
        )


class MembershipJournal:
    """Append-only epoch-stamped log of membership events."""

    def __init__(self, n_initial: int):
        if n_initial < 1:
            raise ValueError(f"n_initial must be >= 1, got {n_initial}")
        self.n_initial = n_initial
        self._events: list[MembershipEvent] = []

    @property
    def epoch(self) -> int:
        """Current epoch = number of recorded events (genesis is epoch 0)."""
        return len(self._events)

    def record(self, kind: str, slot: int) -> MembershipEvent:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; expected one of {EVENT_KINDS}")
        ev = MembershipEvent(epoch=self.epoch + 1, kind=kind, slot=int(slot))
        self._events.append(ev)
        return ev

    def events(self, since: int = 0) -> tuple[MembershipEvent, ...]:
        """Events with ``epoch > since``, in order."""
        if since < 0:
            raise ValueError(f"since must be >= 0, got {since}")
        return tuple(self._events[since:])

    # -- persistence ---------------------------------------------------------
    def to_jsonl(self) -> str:
        """Header line (genesis size) + one JSON line per event."""
        head = json.dumps({"n_initial": self.n_initial}, sort_keys=True)
        return "\n".join([head] + [e.to_json() for e in self._events])

    @classmethod
    def from_jsonl(cls, text: str) -> "MembershipJournal":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty journal text")
        head = json.loads(lines[0])
        journal = cls(int(head["n_initial"]))
        for i, line in enumerate(lines[1:], start=1):
            ev = MembershipEvent.from_json(line)
            if ev.epoch != i:
                raise ValueError(
                    f"journal corrupt: event #{i} carries epoch {ev.epoch}"
                )
            journal._events.append(ev)
        return journal


def apply_event(domain, ev: MembershipEvent) -> None:
    """Apply one journaled event to a domain, checking determinism."""
    if ev.kind == "fail":
        domain.fail(ev.slot)
    elif ev.kind == "recover":
        domain.recover(ev.slot)
    elif ev.kind == "scale_up":
        got = domain.scale_up()
        if got != ev.slot:
            raise ValueError(
                f"replay divergence at epoch {ev.epoch}: scale_up assigned "
                f"slot {got}, journal recorded {ev.slot}"
            )
    elif ev.kind == "scale_down":
        got = domain.scale_down()
        if got != ev.slot:
            raise ValueError(
                f"replay divergence at epoch {ev.epoch}: scale_down retired "
                f"slot {got}, journal recorded {ev.slot}"
            )
    else:  # pragma: no cover - record() validates kinds
        raise ValueError(f"unknown event kind {ev.kind!r}")


def replay(
    journal: MembershipJournal,
    domain_factory: Callable[[int], object],
    upto: int | None = None,
):
    """Rebuild a domain from genesis by re-applying events ``1..upto``.

    ``domain_factory(n)`` must build the domain exactly as the live control
    plane was built (same engine and omega) — the ``LifecycleManager``
    supplies its router's own factory.
    """
    domain = domain_factory(journal.n_initial)
    for ev in journal.events():
        if upto is not None and ev.epoch > upto:
            break
        apply_event(domain, ev)
    return domain


def restore(
    snapshot: JournalSnapshot,
    domain_factory: Callable[[int], object],
    events: Iterable[MembershipEvent] = (),
):
    """Rebuild a domain from a snapshot, then replay the event tail.

    The snapshot's permutation/inverse/alive-count and removed set are
    installed verbatim (they ARE the state — no re-derivation), so
    ``restore(snap_i, tail_i)`` is bit-exact with a genesis replay however
    the stream is split.
    """
    domain = domain_factory(snapshot.n_total)
    eng = domain._eng
    eng.removed = set(snapshot.removed)
    eng.table.slots = list(snapshot.slots)
    eng.table.pos = list(snapshot.pos)
    eng.table.n_alive = snapshot.n_alive
    for ev in events:
        apply_event(domain, ev)
    return domain
