"""BinomialHash over u32 keys and the replacement-table divert, on torch
tensors: the plain lookup and divert of the paper's algorithm as the
routing tier states it (ω-bounded rejection, then the fold; a removed slot
diverted by at most two hash redirects into the table's alive prefix).

A u32 value travels as an int64 tensor holding a number in ``[0, 2^32)``;
every product is masked back to 32 bits.  The same code runs on the CPU
and on the card.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


def u32(x) -> torch.Tensor:
    """Integer tensor -> int64 tensor of its low 32 bits, read unsigned."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def hash_pair(h: torch.Tensor, f) -> torch.Tensor:
    return mix32(h ^ mix32((f + GOLDEN32) & MASK32))


def mulhi32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of the u32 product, in halves so no partial product
    leaves int64."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def _smear(m: torch.Tensor) -> torch.Tensor:
    """m -> 2^(floor(log2 m) + 1) - 1."""
    for s in (1, 2, 4, 8, 16):
        m = m | (m >> s)
    return m


def _relocate(b: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Uniform relocation of b within its level of the binomial tree."""
    f = _smear(b.clamp(min=1)) >> 1
    return torch.where(b < 2, b, f + 1 + (hash_pair(h, f) & f))


def lookup(keys: torch.Tensor, n: int, omega: int) -> torch.Tensor:
    """u32 keys (int64) -> buckets in ``[0, n)`` (int64): the first of ω
    candidates below n, each drawn from the enclosing power of two ``E``;
    a candidate below ``M = E / 2`` takes the key's fold instead; after ω
    rejections the fold."""
    if n <= 1:
        return torch.zeros_like(keys)
    E = 1 << (n - 1).bit_length()
    M = E >> 1
    h = mix32(keys)
    fold = _relocate(h & (M - 1), h)
    out = fold.clone()
    open_ = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    k = keys
    for i in range(omega):
        c = _relocate(h & (E - 1), h)
        take = open_ & (c < n)
        out = torch.where(take & (c >= M), c, out)
        open_ = open_ & ~take
        if i + 1 < omega:
            k = (k + GOLDEN32) & MASK32
            h = mix32(k)
    return out


def divert(keys: torch.Tensor, b: torch.Tensor, removed: torch.Tensor, slots: torch.Tensor,
           n_total: int, n_alive: int, *, redirects: int = 2) -> torch.Tensor:
    """Buckets on removed slots diverted into the alive prefix of the
    replacement table ``slots``: position ``q = mulhi32(hash_pair(key, b),
    n_total)``; where ``q`` is past the alive prefix, one more redirect
    ``mulhi32(mix32(h ^ q * GOLDEN32), n_alive)``.  ``removed`` is a bool
    tensor over the slot space.  ``redirects=1`` keeps the first position
    whatever it holds (the controls use it)."""
    hit = removed[b]
    h = hash_pair(keys, b)
    q = mulhi32(h, n_total)
    if redirects > 1:
        deep = mulhi32(mix32(h ^ ((q * GOLDEN32) & MASK32)), n_alive)
        q = torch.where(q >= n_alive, deep, q)
    return torch.where(hit, slots[q], b)


def route(keys: torch.Tensor, fleet, omega: int, *, redirects: int = 2) -> tuple:
    """u32 keys -> ``(replicas, base buckets)``, both int64: the lookup over
    the whole slot space, then the divert under ``fleet`` (a
    ``reference.fleet.Tensors``)."""
    base = lookup(keys, fleet.n_total, omega)
    out = divert(keys, base, fleet.removed, fleet.slots, fleet.n_total, fleet.n_alive,
                 redirects=redirects)
    return out, base
