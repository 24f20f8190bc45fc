"""Name -> engine registries for the consistent-hash suite.

* ``ENGINES`` — the scalar engines (the paper's Fig. 5 comparison set plus
  the device-word flavours ``binomial32`` and ``jump32``, the oracles the
  device datapath is held against): ``make(name, n)`` builds one.
* ``BULK_ENGINES`` — the device engines: each ``BulkEngine`` pairs a scalar
  oracle with its routing kernels.  ``BatchRouter`` and
  ``repro_torch.kernels.ops`` resolve entries per call.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.baselines import (
    AnchorHashLIFO,
    DxHashLIFO,
    FlipHashRecon,
    JumpBackHashRecon,
    JumpHash,
    ModuloHash,
    PowerCHRecon,
    RendezvousHash,
    RingHash,
)
from repro_torch.core.binomial import BinomialHash, BinomialHash32
from repro_torch.core.bulk import BulkEngine
from repro_torch.core.jump import JumpHash32
from repro_torch.kernels.fused import BINOMIAL, JUMP

ENGINES: dict[str, Callable[[int], object]] = {
    "binomial": lambda n: BinomialHash(n),
    "binomial32": lambda n: BinomialHash32(n),
    "jump": lambda n: JumpHash(n),
    "jump32": lambda n: JumpHash32(n),
    "fliphash-recon": lambda n: FlipHashRecon(n),
    "powerch-recon": lambda n: PowerCHRecon(n),
    "jumpback-recon": lambda n: JumpBackHashRecon(n),
    "anchor-lifo": lambda n: AnchorHashLIFO(n),
    "dx-lifo": lambda n: DxHashLIFO(n),
    "rendezvous": lambda n: RendezvousHash(n),
    "ring": lambda n: RingHash(n),
    "modulo": lambda n: ModuloHash(n),
}

#: constant-time engines compared in the paper's Fig. 5
CONSTANT_TIME = ["binomial", "jump", "fliphash-recon", "powerch-recon", "jumpback-recon"]

#: engines whose cross-power-of-two monotonicity is guaranteed (see DESIGN §6)
FULLY_CONSISTENT = [
    "binomial", "binomial32", "jump", "jump32", "rendezvous", "ring",
    "anchor-lifo", "dx-lifo",
]


def make(name: str, n: int):
    if name not in ENGINES:
        raise KeyError(f"unknown engine '{name}'; have {sorted(ENGINES)}")
    return ENGINES[name](n)


BULK_ENGINES: dict[str, BulkEngine] = {
    "binomial": BulkEngine(name="binomial", scalar_engine="binomial32", kernels=BINOMIAL),
    "jump": BulkEngine(name="jump", scalar_engine="jump32", kernels=JUMP),
}


def make_bulk(name: str) -> BulkEngine:
    """Resolve a device engine bundle by name."""
    if name not in BULK_ENGINES:
        raise KeyError(
            f"unknown bulk engine '{name}'; have {sorted(BULK_ENGINES)} "
            f"(scalar-only engines live in ENGINES)"
        )
    return BULK_ENGINES[name]
