"""R-way placement over the routing reference: each key's ``r`` salted
families routed, then a pass that keeps each key's columns distinct.

Column ``j`` of key ``k`` routes the family key ``mix32(k ^ salt_j)`` with
``salt_j = (j * 7919 + 1) * GOLDEN32``.  A column that repeats an earlier
one probes the alive prefix of the table from a re-salted position, up to
``max_resalt`` positions (default ``r``), and takes the first shard no
earlier column holds; where none is found the key is exhausted.
"""
from __future__ import annotations

import torch

from portbench.reference.hashing import GOLDEN32, MASK32, mix32, mulhi32, route

RESALT_SALT = 0x7F4A7C15


def family_keys(keys: torch.Tensor, r: int) -> torch.Tensor:
    """(N,) u32 keys -> (N, r) u32 family keys (int64)."""
    salts = ((torch.arange(r, dtype=torch.int64, device=keys.device) * 7919 + 1) * GOLDEN32) & MASK32
    return mix32(keys[:, None] ^ salts)


def place(keys: torch.Tensor, fleet, omega: int, r: int, max_resalt: int | None = None,
          *, redirects: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) u32 keys -> ``(replicas (N, r) int64, exhausted (N,) bool)``."""
    max_resalt = r if max_resalt is None else max_resalt
    fam = family_keys(keys, r)
    base, _ = route(fam.reshape(-1), fleet, omega, redirects=redirects)
    base = base.reshape(-1, r)
    settled = torch.full_like(base, -1)
    exhausted = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    n_alive = fleet.n_alive

    def taken(b):
        return (settled == b[:, None]).any(dim=1)

    for j in range(r):
        b = base[:, j]
        if j:
            coll = taken(b)
            q = mulhi32(mix32(fam[:, j] ^ RESALT_SALT), n_alive)
            for _ in range(max_resalt):
                cand = fleet.slots[q]
                free = coll & ~taken(cand)
                b = torch.where(free, cand, b)
                coll = coll & ~free
                q = q + 1
                q = torch.where(q >= n_alive, q - n_alive, q)
            exhausted |= coll & (n_alive > j)
        settled[:, j] = b
    return settled, exhausted


def moved(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """(N, r) bool: ``new[i, j]`` held by no column of ``old[i]``."""
    return ~(new[:, :, None] == old[:, None, :]).any(dim=2)
