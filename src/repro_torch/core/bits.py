"""Integer mixing / bit-twiddling primitives for the consistent-hash suite.

Two parallel families:

* ``u64``  — host-side (pure Python) 64-bit arithmetic, paper-faithful
  (the paper's reference implementations are Java ``long``).  Mixers are
  splitmix64 finalizers (Steele et al.), a standard strong 64-bit mixer.
* ``u32``  — the device word size of the routing kernels (and of the JAX
  reference they are held against).  Mixers are murmur3 ``fmix32``
  finalizers.

Both families provide:
  mix(x)            strong avalanche finalizer
  hash_iter(key, i) the i-th hash of the key (the paper's ``hash^i``)
  hash_pair(h, f)   the two-argument hash used by ``relocateWithinLevel``
"""
from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

GOLDEN64 = 0x9E3779B97F4A7C15
GOLDEN32 = 0x9E3779B9

#: FNV-1a 64-bit parameters — the session-id string hash of
#: ``repro_torch.serving.router.SessionRouter.session_key`` (scalar) and
#: ``np_fnv1a64`` (vectorised) share these.
FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3

# ---------------------------------------------------------------------------
# u64 host-side family (pure python ints)
# ---------------------------------------------------------------------------


def mix64(z: int) -> int:
    """splitmix64 finalizer — full-avalanche 64-bit mixer."""
    z &= MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & MASK64


def hash_iter64(key: int, i: int) -> int:
    """The paper's hash^i(key): an indexed family of independent hashes."""
    return mix64((key + i * GOLDEN64) & MASK64)


def hash_pair64(h: int, f: int) -> int:
    """Two-argument hash(h, f) used by relocateWithinLevel (Alg. 2 line 7)."""
    return mix64(h ^ mix64((f + GOLDEN64) & MASK64))


def highest_one_bit_index(b: int) -> int:
    """Index of the highest set bit (floor(log2 b)) for b >= 1."""
    return b.bit_length() - 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


# ---------------------------------------------------------------------------
# u32 device-side family — numpy scalar flavour (oracle for the jnp/pallas
# implementations; wraps modulo 2**32 exactly like the device code).
# ---------------------------------------------------------------------------


def mix32(h: int) -> int:
    """murmur3 fmix32 finalizer."""
    h &= MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return h


def hash_iter32(key: int, i: int) -> int:
    return mix32((key + i * GOLDEN32) & MASK32)


def hash_pair32(h: int, f: int) -> int:
    return mix32((h ^ mix32((f + GOLDEN32) & MASK32)) & MASK32)


def mulhi32(a: int, b: int) -> int:
    """High 32 bits of the u32xu32 product — the Lemire range reduction
    ``hash -> [0, b)`` used by ``ReplacementTable.resolve`` (scalar oracle of
    ``repro_torch.core.binomial_torch.mulhi32``)."""
    return ((a & MASK32) * (b & MASK32)) >> 32


# ---------------------------------------------------------------------------
# u64 vectorised numpy flavour — the host half of the batched ingest path
# (DESIGN.md §9).  numpy uint64 arithmetic wraps mod 2**64 exactly like the
# masked pure-python family above; tests pin the two equal element-for-element.
# ---------------------------------------------------------------------------


def np_mix64(z: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finalizer — bit-exact with ``mix64`` per lane."""
    z = np.asarray(z, dtype=np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def np_fnv1a64(byte_mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorised FNV-1a over a padded ``(N, L)`` uint8 byte matrix.

    Row i hashes its first ``lengths[i]`` bytes; the padding columns beyond a
    row's length leave its accumulator untouched, so ragged batches hash
    bit-exactly like the scalar per-byte loop (``SessionRouter.session_key``).
    One fused numpy pass per byte *column* — O(L) passes over N rows instead
    of O(N·L) interpreted byte steps.  The matrix is walked transposed
    (contiguous column reads) and the ``live`` blend is skipped for the
    columns every row still owns — for near-uniform id lengths (the common
    shape) the whole hash is pure xor/multiply passes.
    """
    byte_mat = np.asarray(byte_mat, dtype=np.uint8)
    lengths = np.asarray(lengths)
    cols = np.ascontiguousarray(byte_mat.T)
    n, L = byte_mat.shape
    min_len = int(lengths.min()) if n else 0
    h = np.full(n, np.uint64(FNV64_OFFSET), dtype=np.uint64)
    prime = np.uint64(FNV64_PRIME)
    for j in range(L):
        nh = (h ^ cols[j]) * prime
        h = nh if j < min_len else np.where(j < lengths, nh, h)
    return h


def np_split64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u64 array -> (low, high) u32 halves — the device-ingest operand split
    (the ingest kernel re-assembles the pair into one u64 on the device)."""
    x = np.asarray(x, dtype=np.uint64)
    return x.astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)
