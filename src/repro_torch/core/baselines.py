"""Comparison suite of consistent-hashing algorithms — a copy of the JAX
package's ``repro.core.baselines`` (stdlib and ``bits`` only; host engines,
as there).

Fidelity tiers (see DESIGN.md §6):

* EXACT — implemented from published pseudocode, bit-for-bit:
    JumpHash (Lamping & Veach 2014), Rendezvous/HRW (Thaler & Ravishankar),
    Karger ring, naive modulo.
* EXACT-EQUIVALENT for the paper's LIFO/no-failure operating model:
    AnchorHashLIFO (the LIFO specialisation of AnchorHash collapses to an
    iterative mod-shrink), DxHashLIFO (fixed-capacity rejection ring).
* RECONSTRUCTION — same algorithmic family, implemented from the published
    *description* (not claimed bit-identical to the authors' code):
    FlipHashRecon, PowerCHRecon (floating point, as the original),
    JumpBackHashRecon.

All engines expose the same facade as ``BinomialHash``:
``get_bucket(key) -> int``, ``add_bucket()``, ``remove_bucket()`` (LIFO),
``.size``, ``.name``, ``.exact``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from repro_torch.core import bits
from repro_torch.core.bits import MASK64

# ---------------------------------------------------------------------------
# JumpHash — exact (Lamping & Veach 2014)
# ---------------------------------------------------------------------------


def jump_lookup(key: int, n: int) -> int:
    b, j = -1, 0
    k = key & MASK64
    while j < n:
        b = j
        k = (k * 2862933555777941757 + 1) & MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((k >> 33) + 1)))
    return b


@dataclass
class JumpHash:
    n: int
    name = "jump"
    exact = True

    def get_bucket(self, key: int) -> int:
        return jump_lookup(key, self.n)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# Rendezvous / HRW — exact, O(n) per lookup (quality baseline, not constant time)
# ---------------------------------------------------------------------------


@dataclass
class RendezvousHash:
    n: int
    name = "rendezvous"
    exact = True

    def get_bucket(self, key: int) -> int:
        best_b, best_w = 0, -1
        for b in range(self.n):
            w = bits.mix64(key ^ bits.mix64(b))
            if w > best_w:
                best_b, best_w = b, w
        return best_b

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# Karger ring — exact structure (sorted virtual nodes + bisect), O(log nv)
# ---------------------------------------------------------------------------


class RingHash:
    name = "ring"
    exact = True

    def __init__(self, n: int, vnodes: int = 100):
        self.n = 0
        self.vnodes = vnodes
        self._points: list[tuple[int, int]] = []  # (position, bucket)
        for _ in range(n):
            self.add_bucket()

    def _positions(self, b: int):
        return [bits.mix64((b << 20) ^ bits.mix64(v)) for v in range(self.vnodes)]

    def add_bucket(self) -> int:
        b = self.n
        for p in self._positions(b):
            bisect.insort(self._points, (p, b))
        self.n += 1
        return b

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        b = self.n - 1
        pts = set(self._positions(b))
        self._points = [(p, q) for (p, q) in self._points if not (q == b and p in pts)]
        self.n -= 1
        return b

    def get_bucket(self, key: int) -> int:
        h = bits.mix64(key)
        i = bisect.bisect_left(self._points, (h, -1))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# Naive modulo — exact worst-case baseline (massive disruption on resize)
# ---------------------------------------------------------------------------


@dataclass
class ModuloHash:
    n: int
    name = "modulo"
    exact = True

    def get_bucket(self, key: int) -> int:
        return bits.mix64(key) % self.n

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# AnchorHash — LIFO specialisation (Mendelson et al. 2020).
#
# With LIFO-only removals the anchor arrays collapse: A[b] = b for every
# removed bucket b >= n, K = identity.  GETBUCKET degenerates to the
# iterative mod-shrink below, which is exact-equivalent for this regime.
# ---------------------------------------------------------------------------


@dataclass
class AnchorHashLIFO:
    n: int
    capacity: int = 0  # anchor size `a`; defaults to 2 * initial n
    name = "anchor-lifo"
    exact = True  # exact-equivalent in the LIFO/no-failure regime

    def __post_init__(self):
        if self.capacity <= 0:
            self.capacity = max(2 * self.n, 16)
        if self.n > self.capacity:
            raise ValueError("n exceeds anchor capacity")

    def get_bucket(self, key: int) -> int:
        b = bits.mix64(key) % self.capacity
        while b >= self.n:  # removed bucket: rehash within its removal-time set
            b = bits.hash_pair64(key, b) % b
        return b

    def add_bucket(self) -> int:
        if self.n >= self.capacity:
            raise ValueError("anchor capacity exhausted")
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# DxHash — LIFO specialisation (Dong & Wang 2021): rejection over a
# fixed-capacity pseudo-random ring.
# ---------------------------------------------------------------------------


@dataclass
class DxHashLIFO:
    n: int
    capacity: int = 0  # ring size (power of two), fixed at construction
    max_iters: int = 4096
    name = "dx-lifo"
    exact = True  # exact-equivalent in the LIFO/no-failure regime

    def __post_init__(self):
        if self.capacity <= 0:
            self.capacity = bits.next_pow2(max(2 * self.n, 16))
        self.capacity = bits.next_pow2(self.capacity)

    def get_bucket(self, key: int) -> int:
        for i in range(self.max_iters):
            r = bits.hash_iter64(key, i) & (self.capacity - 1)
            if r < self.n:
                return r
        return bits.mix64(key) % self.n  # unreachable in practice

    def add_bucket(self) -> int:
        if self.n >= self.capacity:
            raise ValueError("ring capacity exhausted")
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# FlipHash — reconstruction (Masson & Lee 2024).  Same enclosing-tree
# rejection family as BinomialHash; integer arithmetic.
# ---------------------------------------------------------------------------


@dataclass
class FlipHashRecon:
    n: int
    omega: int = 64
    name = "fliphash-recon"
    exact = False

    def get_bucket(self, key: int) -> int:
        n = self.n
        if n <= 1:
            return 0
        E = bits.next_pow2(n)
        M = E >> 1
        for i in range(self.omega):
            b = bits.hash_iter64(key, i) & (E - 1)
            if b < n:
                return b
        # fold into the lower half (all valid) with a dedicated hash
        return bits.hash_iter64(key, self.omega) & (M - 1)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# PowerCH — reconstruction (Leu 2023).  Uses floating-point arithmetic in the
# hot path, as the original does (this is what the paper's Fig. 5 attributes
# its slightly slower lookups to).
# ---------------------------------------------------------------------------


@dataclass
class PowerCHRecon:
    n: int
    omega: int = 64
    name = "powerch-recon"
    exact = False

    @staticmethod
    def _unit(h: int) -> float:
        return (h >> 11) * (1.0 / (1 << 53))

    def get_bucket(self, key: int) -> int:
        n = self.n
        if n <= 1:
            return 0
        E = bits.next_pow2(n)
        M = E >> 1
        for i in range(self.omega):
            b = int(self._unit(bits.hash_iter64(key, i)) * E)
            if b < n:
                return b
        return int(self._unit(bits.hash_iter64(key, self.omega)) * M)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# JumpBackHash — reconstruction (Ertl 2024).  The distinguishing trait kept
# from the published description: candidates come from a SEQUENTIAL integer
# PRNG stream (one state, chained mixes — no indexed rehash family, no
# modulo, no floats); rejection over the enclosing power-of-two range with a
# minor-tree fold as the bounded-time fallback.
# ---------------------------------------------------------------------------


@dataclass
class JumpBackHashRecon:
    n: int
    omega: int = 64
    name = "jumpback-recon"
    exact = False

    def get_bucket(self, key: int) -> int:
        n = self.n
        if n <= 1:
            return 0
        E = bits.next_pow2(n)
        state = bits.mix64(key)
        for _ in range(self.omega):
            state = bits.mix64((state + bits.GOLDEN64) & MASK64)
            v = state & (E - 1)
            if v < n:
                return v
        return state & ((E >> 1) - 1)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n
