"""Failure resolution on torch tensors — the plain versions of the route,
ingest and chain-remap kernels, and the fleet-state packing.

The ``ReplacementTable`` slots permutation rides on the device as a
``(C,)`` int32 tensor next to the packed removed-slot mask ``(W,)`` (u32
bit-words held in int32) and the ``(2,)`` state ``[n_total, n_alive]``.
A key whose base bucket is removed is resolved by at most two u32 hash
rounds and exactly one table read (DESIGN.md §7) — no data-dependent loop.

The paper-faithful rejection chain (``resolve="chain"``) is here too:
``memento_remap`` with the JAX package's signature (a bool removed mask),
and ``chain_remap_impl``, the plain version of the chain-remap kernel, over
the packed mask words and a ``(2,)`` state ``[n_total, first_alive]``.

All shapes are fixed by the capacity across arbitrary fleet-event streams.
The TPU layout's lane padding is gone: ``W = mask_words(capacity)`` and
``C = capacity``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.markers import constant_time_waiver
from repro_torch.core.binomial_torch import (
    GOLDEN32,
    MASK32,
    binomial_lookup_body,
    hash_iter,
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


# ---------------------------------------------------------------------------
# chain-based resolution: the paper-faithful rejection walk
# ---------------------------------------------------------------------------


def _chain_walk(keys: torch.Tensor, b: torch.Tensor, removed, total, first_alive,
                max_chain: int, return_steps: bool = False):
    """The whole-batch rejection walk: each round moves every lane still on
    a removed slot to ``hash_pair(hash_iter(key, i + 1), b) % n_total``;
    the walk stops once every lane is alive or after ``max_chain`` rounds,
    and lanes still on a removed slot take ``first_alive``.  ``removed(b)``
    says which lanes sit on a removed slot.  ``return_steps`` also gives
    each lane's count of steps (0 for a lane on an alive slot)."""
    active = removed(b)
    steps = torch.zeros_like(b) if return_steps else None
    i = 0
    while i < max_chain and bool(active.any()):
        nb = hash_pair(hash_iter(keys, i + 1), b) % total
        b = torch.where(active, nb, b)
        if return_steps:
            steps += active
        active = active & removed(b)
        i += 1
    out = torch.where(active, first_alive, b)
    return (out, steps) if return_steps else out


@constant_time_waiver(
    "paper-faithful chain-mode baseline: the Memento rejection walk is a "
    "data-dependent loop by design, bounded by the max_chain operand; "
    "serving datapaths use the loop-free table-mode engines instead"
)
def memento_remap(keys, buckets, removed_mask, n_total, first_alive,
                  max_chain: int = 4096) -> torch.Tensor:
    """Divert buckets that landed on removed slots onto alive ones.

    keys         any int shape S (u32 key space)
    buckets      shape S, base-engine buckets in [0, n_total)
    removed_mask (capacity,) bool, capacity >= n_total (fixed across events)
    n_total      total slot space of the base engine (int or 0-dim tensor)
    first_alive  fallback after ``max_chain`` rejections (int or 0-dim tensor)

    -> int32 buckets of shape S, bit-exact with
    ``MementoWrapper(chain_bits=32, resolve="chain")``.
    """
    flat = u32(keys.reshape(-1))
    b = u32(buckets.reshape(-1))
    mask = torch.as_tensor(removed_mask, device=b.device).reshape(-1).to(torch.bool)
    total = u32(torch.as_tensor(n_total, device=b.device))
    first = u32(torch.as_tensor(first_alive, device=b.device))
    out = _chain_walk(flat, b, lambda x: mask[x], total, first, max_chain)
    return out.to(torch.int32).reshape(buckets.shape)


def chain_remap_impl(keys, buckets, packed, state, max_chain: int = 4096,
                     return_steps: bool = False):
    """Plain version of the chain-remap kernel: ``memento_remap`` over the
    packed removed-slot words ``(W,)`` and ``state = [n_total,
    first_alive]`` (both read on the tensors' device, as the kernel reads
    them) -> int32 buckets of the keys' shape; with ``return_steps``,
    also each key's int64 count of walk steps, from the same walk."""
    flat = u32(keys.reshape(-1))
    b = u32(buckets.reshape(-1))

    def removed(x):
        return ((_gather_or_zero(packed, x >> 5) >> (x & 31)) & 1) != 0

    out = _chain_walk(flat, b, removed, u32(state[0]), u32(state[1]), max_chain, return_steps)
    if return_steps:
        out, steps = out
        return out.to(torch.int32).reshape(buckets.shape), steps.reshape(buckets.shape)
    return out.to(torch.int32).reshape(buckets.shape)


def chain_state(domain) -> np.ndarray:
    """``[n_total, first_alive]`` of a chain-mode domain as uint32 (the
    chain remap's device scalars; ``first_alive`` is 0 on an all-failed
    fleet, where no lookup may run)."""
    first = domain.first_alive() if domain.alive_count else 0
    return np.array([domain.total_count, first], dtype=np.uint32)
