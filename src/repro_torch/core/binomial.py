"""BinomialHash — paper-exact scalar implementation (Alg. 1 + Alg. 2).

Coluzzi, Brocco, Antonucci, Leidi — "BinomialHash: A Constant Time, Minimal
Memory Consistent Hashing Algorithm" (2024).

Two word-size flavours sharing the identical control flow:

* ``BinomialHash``    — u64 host flavour (paper-faithful word size),
* ``BinomialHash32``  — u32 flavour; the bit-exact scalar oracle for the
  vectorised torch versions and the CUDA kernels.

The structure of Alg. 1:

    h0 <- h <- hash(key)
    for i in 0..omega-1:
        b <- h_i AND (E-1)
        c <- relocateWithinLevel(b, h_i)
        if c < M:  return relocateWithinLevel(h AND (M-1), h)      # block A
        if c < n:  return c                                        # block B
        h_{i+1} <- hash^{i+1}(key)
    return relocateWithinLevel(h AND (M-1), h)                     # block C

Blocks A and C use the ORIGINAL hash ``h`` (h^0), not the per-iteration hash —
this is what makes the minor-tree fold consistent across tree-level changes
(paper §5.3).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import bits

DEFAULT_OMEGA = 64  # imbalance < 2^-64 on the host control plane


def _relocate_within_level_64(b: int, h: int) -> int:
    """Alg. 2 — uniform relocation of ``b`` within its tree level."""
    if b < 2:  # levels 0 and 1 hold a single node each
        return b
    d = bits.highest_one_bit_index(b)
    f = (1 << d) - 1
    r = bits.hash_pair64(h, f)
    i = r & f
    return (1 << d) + i


def binomial_lookup64(key: int, n: int, omega: int = DEFAULT_OMEGA) -> int:
    """Paper-exact u64 lookup: key -> bucket in [0, n)."""
    if n <= 1:
        return 0
    l = (n - 1).bit_length()  # ceil(log2 n)
    E = 1 << l
    M = E >> 1
    h0 = h = bits.hash_iter64(key, 0)
    hi = h0
    for i in range(omega):
        b = hi & (E - 1)
        c = _relocate_within_level_64(b, hi)
        if c < M:  # block A — fold into the minor tree with the ORIGINAL hash
            d = h & (M - 1)
            return _relocate_within_level_64(d, h)
        if c < n:  # block B — valid bucket on the lowest level
            return c
        hi = bits.hash_iter64(key, i + 1)
    d = h & (M - 1)  # block C
    return _relocate_within_level_64(d, h)


def _relocate_within_level_32(b: int, h: int) -> int:
    if b < 2:
        return b
    d = bits.highest_one_bit_index(b)
    f = (1 << d) - 1
    r = bits.hash_pair32(h, f)
    i = r & f
    return (1 << d) + i


def binomial_lookup32(key: int, n: int, omega: int = 16) -> int:
    """u32 scalar lookup — bit-exact oracle for the device implementations."""
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    E = 1 << l
    M = E >> 1
    h0 = h = bits.hash_iter32(key & bits.MASK32, 0)
    hi = h0
    for i in range(omega):
        b = hi & (E - 1)
        c = _relocate_within_level_32(b, hi)
        if c < M:
            d = h & (M - 1)
            return _relocate_within_level_32(d, h)
        if c < n:
            return c
        hi = bits.hash_iter32(key & bits.MASK32, i + 1)
    d = h & (M - 1)
    return _relocate_within_level_32(d, h)


@dataclass
class BinomialHash:
    """Stateful-looking facade over the stateless lookup (cluster size only).

    Mirrors the engine API the paper's benchmark suite uses: ``get_bucket``,
    ``add_bucket``, ``remove_bucket`` (LIFO).
    """

    n: int
    omega: int = DEFAULT_OMEGA

    name = "binomial"
    exact = True  # implemented from the paper's published pseudocode

    def get_bucket(self, key: int) -> int:
        return binomial_lookup64(key, self.n, self.omega)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        """LIFO removal — removes the last bucket, returns its id."""
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n


@dataclass
class BinomialHash32:
    """u32 flavour of the facade (device-oracle word size)."""

    n: int
    omega: int = 16

    name = "binomial32"
    exact = True

    def get_bucket(self, key: int) -> int:
        return binomial_lookup32(key, self.n, self.omega)

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
