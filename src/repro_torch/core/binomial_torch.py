"""Vectorised u32 BinomialHash on torch tensors — the plain versions of the
routing kernels' arithmetic.

torch's ``uint32`` lacks ``+``, ``>>`` and ``<`` on the CPU and cannot
index, so a u32 value travels here as an ``int64`` tensor holding a number
in ``[0, 2^32)``; every ``+``, ``*`` and ``<<`` that can leave that range is
followed by ``& MASK32``.  int64 multiplication wraps mod 2^64, so the low
32 bits of a product stay exact.  The same code runs on CPU and CUDA
tensors: it is what the kernels are held against on the card.

Inputs may be any integer tensor; ``u32`` reinterprets their low 32 bits
(an ``int32`` tensor of u32 bit patterns, the datapath's key layout, maps
to the same values as the ``uint32`` array it was viewed from).

Bit-exact against ``repro_torch.core.binomial.binomial_lookup32`` and the
JAX reference ``repro.core.binomial_jax`` (tests enforce).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


def u32(x) -> torch.Tensor:
    """Integer tensor -> int64 tensor of its low 32 bits, read unsigned."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32, elementwise on u32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def hash_iter(key: torch.Tensor, i) -> torch.Tensor:
    """hash^i(key) — ``i`` a Python int or a u32 tensor."""
    return mix32((key + ((i * GOLDEN32) & MASK32)) & MASK32)


def hash_pair(h: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return mix32(h ^ mix32((f + GOLDEN32) & MASK32))


def _or_cascade(m: torch.Tensor) -> torch.Tensor:
    """Smear the highest set bit downward: m -> 2^(floor(log2 m)+1) - 1."""
    m = m | (m >> 1)
    m = m | (m >> 2)
    m = m | (m >> 4)
    m = m | (m >> 8)
    return m | (m >> 16)


def next_pow2_u32(n: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= n, wrapping like u32 (0 -> 0, 2^31+1 -> 0)."""
    return (_or_cascade((n - 1) & MASK32) + 1) & MASK32


def mulhi32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of the u32 x u32 product (``__umulhi`` on the card).

    ``a`` splits into 16-bit halves so no partial product reaches 2^63:
    ``(a*b) >> 32 == ((a>>16)*b + (((a&0xFFFF)*b) >> 16)) >> 16``.
    """
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def _shr64(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u64 bit pattern held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _i64(c: int) -> int:
    """u64 constant -> the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def mix64_lo32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of ``splitmix64(hi << 32 | lo)`` — the device ingest mix.

    The u64 lives in int64 (multiplication and xor act on the bits alike;
    right shifts are made logical).  Bit-exact with
    ``uint32(bits.mix64(id))`` per lane.
    """
    z = (u32(hi) << 32) | u32(lo)
    z = (z ^ _shr64(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr64(z, 27)) * _i64(0x94D049BB133111EB)
    return (z ^ _shr64(z, 31)) & MASK32


def relocate_within_level(b: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Alg. 2 vectorised: uniform relocation of b within its tree level
    (``f = 2^d - 1`` and ``top = 2^d`` for ``d = floor(log2 b)``)."""
    f = _or_cascade(b.clamp(min=1)) >> 1
    i = hash_pair(h, f) & f
    return torch.where(b < 2, b, f + 1 + i)


def _unrolled_body(keys: torch.Tensor, E, M, n, omega: int) -> torch.Tensor:
    """ω-unrolled core: every lane runs all ω iterations and a masked blend
    keeps the first accepting one (block A folds with the original hash,
    block B returns the candidate, block C folds after ω rejections)."""
    kacc = keys
    h0 = mix32(kacc)
    fold = relocate_within_level(h0 & ((M - 1) & MASK32), h0)
    result = torch.zeros_like(keys)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    hi = h0
    for i in range(omega):
        c = relocate_within_level(hi & ((E - 1) & MASK32), hi)
        in_a = c < M
        in_b = c < n
        result = torch.where(~found & (in_a | in_b), torch.where(in_a, fold, c), result)
        found = found | in_a | in_b
        if i + 1 < omega:
            kacc = (kacc + GOLDEN32) & MASK32
            hi = mix32(kacc)
    return torch.where(found, result, fold)


def binomial_lookup_body(keys: torch.Tensor, n: torch.Tensor, omega: int) -> torch.Tensor:
    """u32 keys + u32 n (0-dim tensor) -> u32 buckets; n <= 1 gives 0."""
    E = next_pow2_u32(n)
    b = _unrolled_body(keys, E, E >> 1, n, omega)
    return torch.where(n <= 1, 0, b)


def binomial_lookup_dyn(keys: torch.Tensor, n, omega: int = 16) -> torch.Tensor:
    """Bulk lookup, n a runtime value (an int or a 1-element tensor on the
    keys' device): any-int keys -> int32 buckets in [0, n)."""
    n = u32(n).to(keys.device).reshape(())
    return binomial_lookup_body(u32(keys), n, omega).to(torch.int32)


def fold_pow2(n: int) -> tuple[int, int]:
    """Static n >= 2 -> ``(E, M)``: ``E = 2^ceil(log2 n)`` and ``M = E/2``,
    folded on the host as the static-n reference does
    (``repro.kernels.binomial_hash._kernel``).  Like the reference, raises
    OverflowError once E leaves u32 (n > 2^31)."""
    bits = (n - 1).bit_length()
    if bits > 31:
        raise OverflowError(f"n = {n}: E = 2^{bits} is out of bounds for uint32")
    return 1 << bits, 1 << (bits - 1)


def binomial_lookup_vec(keys: torch.Tensor, n: int, omega: int = 16) -> torch.Tensor:
    """Bulk lookup, n a static Python int: any-int keys -> int32 buckets in
    [0, n); n <= 1 gives zeros.  E and M are folded on the host."""
    keys = u32(keys)
    if n <= 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    E, M = fold_pow2(n)
    return _unrolled_body(keys, E, M, n, omega).to(torch.int32)


def router_keys(token_ids: torch.Tensor, layer_salt: int, top_k: int) -> torch.Tensor:
    """The MoE hash router's u32 keys (as int64 values): token ids (B,S) ->
    ``mix32(token_id ^ salt(layer, k))`` (B,S,K), every product wrapping
    in u32 as the reference's does.  ``layer_salt`` is the absolute layer
    index."""
    salt0 = (layer_salt * 1000003) & MASK32
    k_salts = torch.arange(top_k, dtype=torch.int64, device=token_ids.device) * 7919 + 1
    salts = (((salt0 + k_salts) & MASK32) * GOLDEN32) & MASK32
    return mix32(u32(token_ids)[..., None] ^ salts)
