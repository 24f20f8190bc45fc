"""Replacement-table failure resolution on torch tensors — the plain
versions of the route and ingest kernels, and the fleet-state packing.

The ``ReplacementTable`` slots permutation rides on the device as a
``(C,)`` int32 tensor next to the packed removed-slot mask ``(W,)`` (u32
bit-words held in int32) and the ``(2,)`` state ``[n_total, n_alive]``.
A key whose base bucket is removed is resolved by at most two u32 hash
rounds and exactly one table read (DESIGN.md §7) — no data-dependent loop.

All shapes are fixed by the capacity across arbitrary fleet-event streams.
The TPU layout's lane padding is gone: ``W = mask_words(capacity)`` and
``C = capacity``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.binomial_torch import (
    GOLDEN32,
    MASK32,
    binomial_lookup_body,
    hash_pair,
    mix32,
    mix64_lo32,
    mulhi32,
    u32,
)


def mask_words(capacity: int) -> int:
    """Number of u32 bit-words holding a ``capacity``-slot removed mask."""
    return max(1, -(-capacity // 32))


def pack_removed_mask(removed, capacity: int) -> np.ndarray:
    """Removed-slot ids -> ``(mask_words(capacity),)`` uint32 bit-words
    (bit b of the mask = slot b removed)."""
    packed = np.zeros(mask_words(capacity), dtype=np.uint32)
    for b in removed:
        if not 0 <= b < capacity:
            raise ValueError(f"removed slot {b} outside capacity {capacity}")
        packed[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    return packed


def table_width(capacity: int) -> int:
    """Entries of the device replacement table: one per slot."""
    return capacity


def pack_table(table, capacity: int) -> np.ndarray:
    """``ReplacementTable`` -> ``(capacity,)`` int32 ``slots`` permutation
    (alive prefix first; entries past ``n_total`` are never read).  ``pos``
    stays on the host: the device lookup never reads it."""
    n = table.n_total
    if n > capacity:
        raise ValueError(f"table spans {n} slots, exceeding capacity {capacity}")
    packed = np.zeros(table_width(capacity), dtype=np.int32)
    packed[:n] = table.slots
    return packed


def _gather_or_zero(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` read as u32, 0 where ``idx`` is past the end (as the
    reference's select cascades give, and as the kernel guards)."""
    n = values.numel()
    inside = idx < n
    return torch.where(inside, u32(values)[idx.clamp(max=n - 1)], 0)


def _table_divert(
    keys: torch.Tensor, b: torch.Tensor, packed: torch.Tensor,
    table: torch.Tensor, state: torch.Tensor,
) -> torch.Tensor:
    """Divert buckets off removed slots — ``ReplacementTable.resolve``
    lane-wise: ``q = mulhi32(hash_pair(key, b), n_total)``; if ``q`` is a
    removed position, ``q = mulhi32(mix32(h ^ q*GOLDEN32), n_alive)``; then
    one ``slots[q]`` read.  Lanes whose mask bit is clear keep ``b``."""
    total = u32(state[0])
    n_alive = u32(state[1])
    word = _gather_or_zero(packed, b >> 5)
    hit = ((word >> (b & 31)) & 1) != 0
    h = hash_pair(keys, b)
    q = mulhi32(h, total)
    deep = mulhi32(mix32(h ^ ((q * GOLDEN32) & MASK32)), n_alive)
    q = torch.where(q >= n_alive, deep, q)
    return torch.where(hit, _gather_or_zero(table, q), b)


def fused_route_impl(
    keys: torch.Tensor, packed: torch.Tensor, table: torch.Tensor,
    state: torch.Tensor, omega: int, lookup=binomial_lookup_body,
) -> torch.Tensor:
    """Lookup + table divert, generic over the engine:
    ``lookup(keys_u32, n_total, omega) -> u32 buckets`` is the only
    engine-specific piece.

    keys    any int shape (u32 key space)
    packed  (W,) removed-slot bit-words; table (C,) int32 slots permutation
    state   (2,) ``[n_total, n_alive]``
    """
    flat = u32(keys.reshape(-1))
    b = lookup(flat, u32(state[0]), omega)
    b = _table_divert(flat, b, packed, table, state)
    return b.to(torch.int32).reshape(keys.shape)


def binomial_memento_route(keys, packed, table, state, omega: int = 16) -> torch.Tensor:
    """Plain version of the binomial route kernel: keys -> int32 replica ids."""
    return fused_route_impl(keys, packed, table, state, omega)


def binomial_ingest_route(
    ids_lo, ids_hi, packed, table, state, omega: int = 16
) -> torch.Tensor:
    """Plain version of the binomial ingest kernel: u64 ids as u32 halves ->
    int32 replica ids (the splitmix64 mix, then the route)."""
    keys = mix64_lo32(ids_lo, ids_hi).reshape(ids_lo.shape)
    return fused_route_impl(keys, packed, table, state, omega)


def memento_remap_table(keys, buckets, packed, table, state) -> torch.Tensor:
    """Second dispatch of the two-pass baseline: divert precomputed buckets
    off removed slots (``buckets`` round-trips through memory between the
    lookup dispatch and this one — the cost the fused kernel removes)."""
    b = _table_divert(u32(keys.reshape(-1)), u32(buckets.reshape(-1)), packed, table, state)
    return b.to(torch.int32).reshape(buckets.shape)
