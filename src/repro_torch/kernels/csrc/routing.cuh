// Device bodies of the routing datapath: the two lookup engines, the two key
// sources and the replacement-table divert.  routing.cu instantiates the
// kernels over them.
//
// Every function here computes exactly what its plain PyTorch version in
// repro_torch.core computes (bit for bit); u32 values are uint32_t and the
// 64-bit mixes use native uint64_t.
#pragma once

#include <cstdint>

namespace routing {

constexpr uint32_t GOLDEN32 = 0x9E3779B9u;
constexpr uint64_t JUMP_LCG = 2862933555777941757ull;

// murmur3 fmix32
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_pair(uint32_t h, uint32_t f) {
  return mix32(h ^ mix32(f + GOLDEN32));
}

// Alg. 2: uniform relocation of b within its tree level.
__device__ __forceinline__ uint32_t relocate_within_level(uint32_t b, uint32_t h) {
  if (b < 2) return b;
  const uint32_t top = 1u << (31 - __clz(b));
  const uint32_t f = top - 1u;
  return top + (hash_pair(h, f) & f);
}

// Low 32 bits of splitmix64(hi << 32 | lo).
__device__ __forceinline__ uint32_t mix64_lo32(uint32_t lo, uint32_t hi) {
  uint64_t z = (static_cast<uint64_t>(hi) << 32) | lo;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return static_cast<uint32_t>(z ^ (z >> 31));
}

// BinomialHash (Alg. 1), u32 flavour, n a runtime value.  The loop exits at
// the first accepting iteration; the value is the one the omega-unrolled
// masked blend of the reference selects.
struct Binomial {
  __device__ static uint32_t lookup(uint32_t key, uint32_t n, int omega) {
    if (n <= 1) return 0;
    uint32_t m = n - 1u;  // E = next power of two >= n, wrapping like u32
    m |= m >> 1;
    m |= m >> 2;
    m |= m >> 4;
    m |= m >> 8;
    m |= m >> 16;
    const uint32_t E = m + 1u;
    return lookup_folded(key, n, E, E >> 1, omega);
  }

  // The loop with E = 2^ceil(log2 n) and M = E/2 given (folded on the host
  // for the static-n kernel); n >= 2.
  __device__ __forceinline__ static uint32_t lookup_folded(uint32_t key, uint32_t n,
                                                           uint32_t E, uint32_t M, int omega) {
    const uint32_t h0 = mix32(key);
    uint32_t hi = h0;
    uint32_t kacc = key;
    for (int i = 0; i < omega; ++i) {
      const uint32_t c = relocate_within_level(hi & (E - 1u), hi);
      if (c < M) break;     // block A: fold with the original hash
      if (c < n) return c;  // block B
      kacc += GOLDEN32;
      hi = mix32(kacc);
    }
    return relocate_within_level(h0 & (M - 1u), h0);  // blocks A and C
  }
};

// Jump consistent hash, omega-bounded, f32 step.  Every float operation is
// IEEE single with round-to-nearest, as in the scalar oracle; the cast to
// u32 only happens on continuing lanes, where fj < n <= 2^24.
struct Jump {
  __device__ static uint32_t lookup(uint32_t key, uint32_t n, int omega) {
    if (n <= 1) return 0;
    uint64_t k = key;
    uint32_t b = 0;
    const float fn = __uint2float_rn(n);
    for (int i = 0; i < omega; ++i) {
      k = k * JUMP_LCG + 1ull;
      const uint32_t r = static_cast<uint32_t>(k >> 33) + 1u;
      const float fj = __fmul_rn(__uint2float_rn(b + 1u),
                                 __fdiv_rn(2147483648.0f, __uint2float_rn(r)));
      if (fj >= fn) return b;
      b = __float2uint_rz(fj);
    }
    return b;
  }

  // Jump needs no folded constants: the static-n kernel passes n alone.
  __device__ __forceinline__ static uint32_t lookup_folded(uint32_t key, uint32_t n, uint32_t,
                                                           uint32_t, int omega) {
    return lookup(key, n, omega);
  }
};

// Key sources: pre-hashed u32 keys, or raw u64 ids as (lo, hi) u32 halves
// mixed in-register (no key array exists on the ingest path).
struct KeySource {
  const uint32_t* keys;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const { return keys[i]; }
};

struct IdSource {
  const uint32_t* lo;
  const uint32_t* hi;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    return mix64_lo32(lo[i], hi[i]);
  }
};

// ReplacementTable.resolve for one key: bucket b is kept unless its mask bit
// is set; then at most two Lemire redirects and one direct slots[] read.
// Words and slots past the operands' extents read as 0, as the reference's
// select cascades do.
__device__ __forceinline__ uint32_t divert(uint32_t key, uint32_t b,
                                           const uint32_t* mask, int n_words,
                                           const int32_t* slots, int n_slots,
                                           uint32_t n_total, uint32_t n_alive) {
  const uint32_t w = b >> 5;
  const uint32_t word = w < static_cast<uint32_t>(n_words) ? mask[w] : 0u;
  if (((word >> (b & 31u)) & 1u) == 0) return b;
  const uint32_t h = hash_pair(key, b);
  uint32_t q = __umulhi(h, n_total);
  if (q >= n_alive) q = __umulhi(mix32(h ^ (q * GOLDEN32)), n_alive);
  return q < static_cast<uint32_t>(n_slots) ? static_cast<uint32_t>(slots[q]) : 0u;
}

}  // namespace routing
