"""Name -> engine registries.

* ``ENGINES`` — the scalar engines the device datapath is held against:
  ``binomial`` (u64, paper-exact), ``binomial32`` and ``jump32`` (the
  device-word oracles).  ``make(name, n)`` builds one.  The comparison
  baselines of the reference suite (ring, rendezvous, anchor, ...) are not
  here yet.
* ``BULK_ENGINES`` — the device engines: each ``BulkEngine`` pairs a scalar
  oracle with its routing kernels.  ``BatchRouter`` and
  ``repro_torch.kernels.ops`` resolve entries per call.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.binomial import BinomialHash, BinomialHash32
from repro_torch.core.bulk import BulkEngine
from repro_torch.core.jump import JumpHash32
from repro_torch.kernels.fused import BINOMIAL, JUMP

ENGINES: dict[str, Callable[[int], object]] = {
    "binomial": lambda n: BinomialHash(n),
    "binomial32": lambda n: BinomialHash32(n),
    "jump32": lambda n: JumpHash32(n),
}


def make(name: str, n: int):
    if name not in ENGINES:
        raise KeyError(
            f"unknown engine '{name}'; have {sorted(ENGINES)} (the scalar "
            "comparison baselines exist only in the JAX package so far)"
        )
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
