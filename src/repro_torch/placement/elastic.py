"""Elastic-scaling planners and the failure domain (host-side control
plane, pure Python ints) — the counterpart of ``repro.placement.elastic``.

* expert-parallel groups — expert -> device placement when the EP group
  grows or shrinks (``plan_expert_migration``);
* data hosts — file-shard -> host placement (``plan_shard_reassignment``);
* failure handling — arbitrary node loss via the Memento wrapper
  (``FailureDomain``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.memento import MementoWrapper
from repro_torch.core.registry import make
from repro_torch.placement.assignment import Assignment, MovementPlan


@dataclass
class ExpertMigration:
    """Expert -> device migration plan between EP group sizes."""

    plan: MovementPlan
    old_devices: int
    new_devices: int
    num_experts: int

    @property
    def bytes_moved(self) -> int:  # filled by caller with per-expert bytes
        return len(self.plan.moves)


def plan_expert_migration(
    num_experts: int, old_devices: int, new_devices: int, engine: str = "binomial"
) -> ExpertMigration:
    """Place experts on devices consistently; return the minimal migration.

    Monotonicity guarantees that on scale-up only experts moving TO new
    devices migrate, and on scale-down only experts FROM removed devices.
    """
    a = Assignment(list(range(num_experts)), old_devices, engine)
    plan = a.resize(new_devices)
    return ExpertMigration(plan, old_devices, new_devices, num_experts)


def plan_shard_reassignment(
    num_shards: int, old_hosts: int, new_hosts: int, engine: str = "binomial"
) -> MovementPlan:
    """Data file-shard -> host reassignment on pipeline rescale."""
    a = Assignment(list(range(num_shards)), old_hosts, engine)
    return a.resize(new_hosts)


class FailureDomain:
    """Arbitrary-failure placement built on the Memento-style wrapper.

    Lookups always return an alive node; failures and recoveries move only
    the affected keys.

    ``chain_bits=32`` (with a u32 engine such as ``binomial32``) makes the
    whole lookup+remap path u32 — the word size of the device chain remap
    (``repro_torch.core.memento_torch.memento_remap``).

    ``resolve="table"`` switches failure resolution from the rejection
    chain to the constant-time replacement table (DESIGN.md §7) — the
    semantics the batched device datapath
    (``repro_torch.serving.batch_router``) implements and mirrors
    bit-exactly.
    """

    def __init__(
        self,
        n: int,
        engine: str = "binomial",
        chain_bits: int = 64,
        omega: int | None = None,
        max_chain: int = 4096,
        resolve: str = "chain",
        allow_empty: bool = False,
    ):
        def factory(m: int):
            eng = make(engine, m)
            if omega is not None:
                if not hasattr(eng, "omega"):
                    raise ValueError(f"engine '{engine}' does not take omega")
                eng.omega = omega
            return eng

        self._eng = MementoWrapper(
            factory,
            n,
            max_chain=max_chain,
            chain_bits=chain_bits,
            resolve=resolve,
            allow_empty=allow_empty,
        )

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

    def first_alive(self) -> int:
        return self._eng.first_alive()

    @property
    def resolve(self) -> str:
        """``"chain"`` or ``"table"``: how a removed slot is resolved."""
        return self._eng.resolve

    @property
    def chain_bits(self) -> int:
        """Word size of the rejection chain (32 or 64)."""
        return self._eng.chain_bits

    @property
    def max_chain(self) -> int:
        """Rejection steps before a key falls back to ``first_alive``."""
        return self._eng.max_chain

    @property
    def replacement_table(self):
        """The ``ReplacementTable`` (``resolve="table"`` domains only) —
        the host truth the device copies are uploaded from."""
        if self._eng.table is None:
            raise ValueError("domain was not constructed with resolve='table'")
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
