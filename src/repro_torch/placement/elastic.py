"""Failure domain: arbitrary-failure placement on the Memento-style wrapper
(host-side control plane, pure Python ints)."""
from __future__ import annotations

from repro_torch.core.memento import MementoWrapper
from repro_torch.core.registry import make


class FailureDomain:
    """Arbitrary-failure placement built on the Memento-style wrapper.

    Lookups always return an alive node; failures and recoveries move only
    the affected keys.  Failures resolve through the constant-time
    replacement table (DESIGN.md §7), the semantics the device implements;
    with a u32 engine (``binomial32``, ``jump32``) the whole lookup+divert
    path is u32 — the word size of the batched device datapath
    (``repro_torch.serving.batch_router``), which mirrors this domain's
    state on the device bit-exactly.
    """

    def __init__(
        self,
        n: int,
        engine: str = "binomial",
        omega: int | None = None,
    ):
        def factory(m: int):
            eng = make(engine, m)
            if omega is not None:
                if not hasattr(eng, "omega"):
                    raise ValueError(f"engine '{engine}' does not take omega")
                eng.omega = omega
            return eng

        self._eng = MementoWrapper(factory, n)

    @property
    def alive_count(self) -> int:
        return self._eng.size

    @property
    def total_count(self) -> int:
        """Total slot space of the base engine (alive + removed)."""
        return self._eng.n_total

    @property
    def removed(self) -> frozenset[int]:
        return frozenset(self._eng.removed)

    @property
    def replacement_table(self):
        """The ``ReplacementTable`` — the host truth the device copies are
        uploaded from."""
        return self._eng.table

    def locate(self, key: int) -> int:
        return self._eng.get_bucket(key)

    def fail(self, node: int) -> None:
        self._eng.remove_bucket(node)

    def recover(self, node: int) -> None:
        self._eng.restore_bucket(node)

    def scale_up(self) -> int:
        return self._eng.add_bucket()

    def scale_down(self) -> int:
        return self._eng.remove_bucket()
