"""Core consistent-hashing library — the paper's contribution.

Exact scalar BinomialHash (u64 + u32), its torch tensor flavour (the plain
versions of the device lookup), the comparison suite, the Memento-style
failure wrapper, the fleet-state protocol (``bulk``) and the closed-form
balance theory (``analysis``).

The names the JAX package's ``repro.core`` exports are reachable here too
(``repro_torch.core.memento_remap``, ``.ENGINES``, ...), resolved at first
use, so that importing a submodule such as ``core.bits`` pulls in no
kernel wrapper or registry.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "BinomialHash": "binomial",
    "BinomialHash32": "binomial",
    "binomial_lookup32": "binomial",
    "binomial_lookup64": "binomial",
    "binomial_lookup_dyn": "binomial_torch",
    "binomial_lookup_vec": "binomial_torch",
    "BulkEngine": "bulk",
    "FleetState": "bulk",
    "RouterSpec": "bulk",
    "JumpHash32": "jump",
    "jump_lookup_dyn": "jump_torch",
    "jump_lookup_vec": "jump_torch",
    "MementoWrapper": "memento",
    "ReplacementTable": "memento",
    "memento_remap": "memento_torch",
    "memento_remap_table": "memento_torch",
    "BULK_ENGINES": "registry",
    "CONSTANT_TIME": "registry",
    "ENGINES": "registry",
    "FULLY_CONSISTENT": "registry",
    "make": "registry",
    "make_bulk": "registry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
