"""R-way placement on torch tensors — the plain versions of the placement
kernels (``csrc/routing.cu``: the family route, ``resolve_kernel`` and
``resolve_rows_kernel``, and ``place_kernel``, which runs the first two in
one launch; ``node_route_kernel``, the node level of a placement over
failure domains).

A key's ``r`` replica columns are ``r`` salted key *families* routed through
the engine's fused route, then a distinct-resolution pass breaks collisions
between columns (``repro.placement.store.route_replicas_impl``):

* ``family_keys(keys, r)`` — column ``j`` of key ``k`` is
  ``mix32(k ^ family_salts(r)[j])``, the MoE router's per-k salt schedule
  ``(j * 7919 + 1) * GOLDEN32`` (so family 0 is the plain router's key);
* ``resolve_columns`` — column ``j`` keeps its routed shard unless it
  equals a column settled before it; then a re-salt hash picks a position
  of the table's alive prefix and up to ``max_resalt`` linear probes
  (+1 with a conditional wrap) take the first alive shard no earlier column
  holds.

The reference tests "taken" with a per-lane bitmask of ``n_words`` u32
words set through select cascades.  That mask only ever holds the columns
settled before ``j``, and every shard id is below ``32 * n_words``, so
"bit ``b`` set" is exactly "``b`` equals an earlier column": this version
and the kernel compare against those columns.  u32 values travel as int64
in ``[0, 2^32)``, as in ``binomial_torch``.

Over failure domains (racks of DataNodes, ``repro_torch.core.bulk
.FailureDomains``) the columns above are racks, placed over the rack fleet,
and ``route_nodes_impl`` gives column ``j`` its DataNode: the route (lookup
and divert) of the node key ``mix32(k ^ node_salts(r)[j])`` over the fleet
of the rack column ``j`` was given, as the global id ``rack x
nodes_per_rack + local``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.binomial_torch import GOLDEN32, MASK32, hash_pair, mix32, mulhi32, u32

#: salt seeding the re-salt chain — distinct from every family salt so the
#: resolution probes decorrelate from the base placements they collide with
RESALT_SALT = 0x7F4A7C15

#: salt of the node keys (xored into the family salts): distinct from every
#: family salt and from the re-salt, so a column's node decorrelates from
#: its rack
NODE_SALT = 0x2545F491

#: replica columns ``resolve_kernel`` and ``place_kernel`` keep in registers
#: per key; past it ``resolve_rows_kernel`` stages a warp's rows in shared
#: memory (any r)
MAX_R = 8


def family_salts(r: int) -> np.ndarray:
    """The ``r`` static per-replica salts (uint32): ``(j * 7919 + 1) *
    GOLDEN32`` wrapping in u32, so replica family 0 is the plain router
    placement."""
    base = (np.arange(r, dtype=np.uint64) * 7919 + 1).astype(np.uint32)
    return base * np.uint32(GOLDEN32)


def family_keys(keys: torch.Tensor, r: int) -> torch.Tensor:
    """keys (any int shape) -> ``(N, r)`` int64 u32 family keys, row-major:
    flat index ``i`` is key ``i // r`` under salt ``i % r``."""
    salts = torch.from_numpy(family_salts(r).astype(np.int64)).to(keys.device)
    return mix32(u32(keys.reshape(-1))[:, None] ^ salts)


def node_salts(r: int) -> np.ndarray:
    """The ``r`` salts of the node keys (uint32): ``family_salts(r) ^
    NODE_SALT``."""
    return family_salts(r) ^ np.uint32(NODE_SALT)


def node_keys(keys: torch.Tensor, r: int) -> torch.Tensor:
    """keys (any int shape) -> ``(N, r)`` int64 u32 node keys, row-major:
    column ``j`` of key ``k`` is ``mix32(k ^ node_salts(r)[j])``."""
    salts = torch.from_numpy(node_salts(r).astype(np.int64)).to(keys.device)
    return mix32(u32(keys.reshape(-1))[:, None] ^ salts)


def route_nodes_impl(
    keys: torch.Tensor, racks: torch.Tensor, packed: torch.Tensor, table: torch.Tensor,
    state: torch.Tensor, nodes: int, omega: int, lookup, old: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The node level of a placement over failure domains.

    keys    (N,) u32 keys (any int dtype); racks (N, r) the rack columns
            (alive racks, from the placement over the rack fleet)
    packed / table / state — the racks' fleets stacked, a row a rack:
            ``(R, W)`` removed-slot words, ``(R, C)`` slots permutations,
            ``(R, 2)`` ``[n_total, n_alive]``; every rack's slot space is
            ``nodes`` (DataNodes fail and recover, the layout never scales)
    lookup  the engine's plain dynamic-n lookup ``(keys, n, omega)``
    old     optional (N, r) placement to diff against

    Returns ``(nodes (N, r) int32, moved)``: column ``j``'s DataNode is
    ``rack x nodes + b``, ``b`` the lookup of its node key over ``nodes``
    slots diverted, where its rack has removed ``b``, through that rack's
    replacement table (two redirects at most, as ``_table_divert``);
    ``moved[i, j] = nodes[i, j] not in old[i, :]``, or None without ``old``.
    """
    r = racks.shape[-1]
    key = node_keys(keys, r).reshape(-1)
    rack = racks.reshape(-1).to(torch.int64)
    b = u32(lookup(key, nodes, omega))
    words, width = packed.shape[-1], table.shape[-1]
    hit = ((u32(packed.reshape(-1))[rack * words + (b >> 5)] >> (b & 31)) & 1) != 0
    total, alive = u32(state[:, 0])[rack], u32(state[:, 1])[rack]
    h = hash_pair(key, b)
    q = mulhi32(h, total)
    deep = mulhi32(mix32(h ^ ((q * GOLDEN32) & MASK32)), alive)
    q = torch.where(q >= alive, deep, q)
    b = torch.where(hit, u32(table.reshape(-1))[rack * width + q], b)
    out = (rack * nodes + b).to(torch.int32).reshape(-1, r)
    moved = None
    if old is not None:
        old = old.reshape(out.shape).to(torch.int32)
        moved = ~(out[:, :, None] == old[:, None, :]).any(dim=2)
    return out, moved


def resolve_columns(
    keys: torch.Tensor, base: torch.Tensor, table: torch.Tensor,
    state: torch.Tensor, max_resalt: int, old: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The distinct-resolution pass over routed family columns.

    keys   (N,) u32 keys (any int dtype); base (N, r) routed shard ids of
           their families; table (C,) slots permutation; state (2,)
           ``[n_total, n_alive]`` with ``n_alive >= 1``
    old    optional (N, r) placement to diff against

    Returns ``(replicas (N, r) int32, exhausted (N,) bool, moved)``:
    ``exhausted`` marks keys where a distinct shard existed for some column
    (``n_alive > j``) but ``max_resalt`` probes found none; where
    ``n_alive <= j`` the duplicate is the defined degraded answer.
    ``moved[i, j] = replicas[i, j] not in old[i, :]`` ((N, r) bool), or
    None without ``old``.
    """
    k = u32(keys.reshape(-1))
    r = base.shape[-1]
    base = u32(base.reshape(k.numel(), r))
    fam = family_keys(k, r)
    n_alive = u32(state[1])
    slots = u32(table)
    # the columns settled so far; -1 (never a u32 value) marks the rest, so
    # "taken" is one compare against the row whatever j is: each column
    # costs the same ops, and the pass stays affine in r
    settled = torch.full((k.numel(), r), -1, dtype=torch.int64, device=k.device)

    def taken(b: torch.Tensor) -> torch.Tensor:
        return (settled == b[:, None]).any(dim=-1)

    exhausted = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    for j in range(r):
        b = base[:, j]
        if j > 0:
            coll = taken(b)
            q = mulhi32(mix32(fam[:, j] ^ RESALT_SALT), n_alive)
            for _ in range(max_resalt):
                cand = slots[q]
                free = coll & ~taken(cand)
                b = torch.where(free, cand, b)
                coll = coll & ~free
                q = q + 1
                q = torch.where(q >= n_alive, q - n_alive, q)
            exhausted = exhausted | (coll & (n_alive > j))
        settled[:, j] = b
    replicas = settled.to(torch.int32)
    moved = None
    if old is not None:
        old = old.reshape(replicas.shape).to(torch.int32)
        moved = torch.ones(replicas.shape, dtype=torch.bool, device=replicas.device)
        for c in range(r):
            moved = moved & (replicas != old[:, c : c + 1])
    return replicas, exhausted, moved
