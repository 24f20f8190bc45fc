// Device bodies of the routing datapath: the two lookup engines, the three
// key sources and the replacement table.  routing.cu builds the kernels
// from them.
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

// BinomialHash (Alg. 1), u32 flavour, in two parts that binomial_chunk in
// routing.cu runs: the loop's first trip for every key, the rest for the keys
// it does not settle.  The loop exits at the first accepting iteration; the
// value is the one the omega-unrolled masked blend of the reference selects.
struct Binomial {
  // The loop's first trip, E = 2^ceil(log2 n) folded by the caller.  Its
  // candidate c is the lookup's answer whenever c < n and omega >= 1: block B
  // returns c, and block A's fold equals c on this trip (c < M puts c, hence
  // h0 & (E-1), in a level below M, so h0 & (E-1) == h0 & (M-1) and the fold
  // relocates the same value with the same hash).
  __device__ __forceinline__ static uint32_t first_trip(uint32_t key, uint32_t E) {
    const uint32_t h0 = mix32(key);
    return relocate_within_level(h0 & (E - 1u), h0);
  }

  // The rest of the loop for a key whose first trip gave c >= n: trips
  // 1 .. omega-1 with the original semantics, then blocks A and C.
  __device__ static uint32_t rest(uint32_t key, uint32_t n, uint32_t E, uint32_t M, int omega) {
    uint32_t kacc = key;
    // ct-loop: omega: the lookup's trips 1 .. omega-1
    for (int i = 1; i < omega; ++i) {
      kacc += GOLDEN32;
      const uint32_t hi = mix32(kacc);
      const uint32_t c = relocate_within_level(hi & (E - 1u), hi);
      if (c < M) break;
      if (c < n) return c;
    }
    const uint32_t h0 = mix32(key);
    return relocate_within_level(h0 & (M - 1u), h0);
  }
};

// Jump consistent hash, omega-bounded, f32 step, run as chains by
// jump_chains in routing.cu.  Every float operation is IEEE single with
// round-to-nearest, as in the scalar oracle; the cast to u32 only happens on
// continuing lanes, where fj < n < 2^32.
struct Jump {
  // One step of a chain: advances the LCG state k and returns
  // fj = b1 * (2^31 / r), b1 being f32(b + 1) as the scalar oracle rounds it.
  __device__ __forceinline__ static float step(uint64_t& k, float b1) {
    k = k * JUMP_LCG + 1ull;
    const uint32_t r = static_cast<uint32_t>(k >> 33) + 1u;
    return __fmul_rn(b1, __fdiv_rn(2147483648.0f, __uint2float_rn(r)));
  }
};

// Key sources: pre-hashed u32 keys, raw u64 ids as (lo, hi) u32 halves
// mixed in-register (no key array exists on the ingest path), the MoE hash
// router's keys built from token ids in-register, or a placement's salted
// key families.
struct KeySource {
  static constexpr bool kPreload = true;  // a plain load
  const uint32_t* keys;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const { return keys[i]; }
};

struct IdSource {
  static constexpr bool kPreload = false;  // two loads and a 64-bit mix
  const uint32_t* lo;
  const uint32_t* hi;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    return mix64_lo32(lo[i], hi[i]);
  }
};

// Key i of a (B, S, K) router call: token t = i / K, choice k = i % K,
// mix32(u32(token) ^ ((salt0 + k*7919 + 1) * GOLDEN32)) with every product
// wrapping in u32, salt0 = layer_salt * 1000003 folded on the host.  The
// token's low 32 bits are word t * stride of the ids (stride 1 for int32
// ids, 2 for little-endian int64).  i < 2^32 (the wrapper checks).
struct RouterKeySource {
  // loads as it goes: preloading a lane's keys made the binomial router call
  // 13 % slower on the H100 (PERF.md §6)
  static constexpr bool kPreload = false;
  const uint32_t* tokens;
  int stride;
  uint32_t salt0;
  uint32_t top_k;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    const uint32_t ii = static_cast<uint32_t>(i);
    const uint32_t t = ii / top_k;
    const uint32_t k = ii - t * top_k;
    const uint32_t salt = (salt0 + k * 7919u + 1u) * GOLDEN32;
    return mix32(tokens[static_cast<int64_t>(t) * stride] ^ salt);
  }
};

// The salt of a placement's replica column j: (j * 7919 + 1) * GOLDEN32 in
// u32, the family_salts(r)[j] of repro_torch.core.placement_torch (the MoE
// router's schedule at salt0 = 0).
__device__ __forceinline__ uint32_t family_salt(uint32_t j) { return (j * 7919u + 1u) * GOLDEN32; }

// Key i of a placement's (N, r) family batch: key t = i / r, column
// j = i % r, mix32(keys[t] ^ family_salt(j)); so route_kernel routes all r
// columns of a batch in one launch and the (N, r) family keys never exist.
// The salt is two instructions, so no salt table is passed.  i < 2^32 (the
// wrapper checks).
struct FamilyKeySource {
  // loads as it goes: preloading a lane's keys made the binomial family
  // route 30 % slower on the H100 (43 registers against 38; PERF.md §6)
  static constexpr bool kPreload = false;
  const uint32_t* keys;
  uint32_t r;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    const uint32_t ii = static_cast<uint32_t>(i);
    const uint32_t t = ii / r;
    return mix32(keys[t] ^ family_salt(ii - t * r));
  }
};

// The replacement table of ReplacementTable.resolve, split so that a kernel
// can test every key cheaply and redirect the few removed ones together.
// Words and slots past the operands' extents read as 0, as the reference's
// select cascades do.
struct Fleet {
  const uint32_t* mask;
  int n_words;
  const int32_t* slots;
  int n_slots;

  __device__ __forceinline__ bool removed(uint32_t b) const {
    const uint32_t w = b >> 5;
    const uint32_t word = w < static_cast<uint32_t>(n_words) ? mask[w] : 0u;
    return ((word >> (b & 31u)) & 1u) != 0;
  }

  // A removed bucket's replacement: at most two Lemire redirects and one
  // direct slots[] read.
  __device__ __forceinline__ uint32_t redirect(uint32_t key, uint32_t b, uint32_t n_total,
                                               uint32_t n_alive) const {
    const uint32_t h = hash_pair(key, b);
    uint32_t q = __umulhi(h, n_total);
    if (q >= n_alive) q = __umulhi(mix32(h ^ (q * GOLDEN32)), n_alive);
    return q < static_cast<uint32_t>(n_slots) ? static_cast<uint32_t>(slots[q]) : 0u;
  }
};

}  // namespace routing
