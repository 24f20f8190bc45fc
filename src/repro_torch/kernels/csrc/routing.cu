// The routing datapath's CUDA kernels for sm_90a, each instantiated for both
// lookup engines (binomial, jump):
//
//   route_kernel<Engine, KeySource>   replaces src/repro/kernels/fused.py
//       _kernel_route (pallas_call at fused.py:202): lookup, removed-bit
//       test, replacement-table divert -> i32 replica ids;
//   route_kernel<Engine, IdSource>    replaces _kernel_ingest (fused.py:255):
//       splitmix64 of the u64 id halves, then the same body;
//   lookup_dyn_kernel<Engine>         replaces _kernel_lookup_dyn
//       (fused.py:295): the bare lookup with n read from the device;
//   lookup_vec_kernel<Engine, Source> replaces src/repro/kernels/binomial_hash.py
//       _kernel (pallas_call at binomial_hash.py:91, binomial_bulk_lookup_2d):
//       the bare lookup with n static.  The TPU kernel bakes n, E = 2^ceil(log2 n)
//       and M = E/2 into its trace; here the host folds them and passes them
//       by value.  Over KeySource it takes u32 keys; over RouterKeySource it
//       builds the MoE hash router's keys from token ids in-register, so a
//       router call is one launch.  The jump instances are the card's form of
//       jump_lookup_vec;
//   route_kernel<Engine, FamilyKeySource> routes an R-way placement's r salted
//       key families (src/repro/placement/store.py:87, route_replicas_impl,
//       whose family route is the fused route, pallas_call at fused.py:202):
//       the same chunk loop, all r columns in one launch;
//   resolve_kernel<kRegs>             the distinct-resolution pass of
//       route_replicas_impl (store.py:131-178), which the reference runs as
//       elementwise jnp outside any Pallas kernel; one thread per key, its
//       columns in registers up to r = MAX_R and re-read from its own row of
//       the output beyond;
//   route_load_kernel<Engine, kShared> the instrumented route of
//       src/repro/observability/load.py:71-118 (route_with_load_impl, jnp in
//       the reference, one jitted dispatch): route_kernel's chunk loop with
//       the sampled replicas also counted into a (capacity,) u32
//       accumulator, in the same launch;
//   chain_remap_kernel                the Memento rejection chain of
//       src/repro/core/memento_jax.py:101-145 (memento_remap: a jnp
//       lax.while_loop over the whole batch, no Pallas kernel), the port's
//       own kernel: the second launch of the chain-mode two-pass path, after
//       lookup_dyn_kernel.  Each warp queues its chunks' removed keys and
//       walks them with lane refill (see its note).
//
// What bounds the lookups (route, ingest, lookup_dyn, lookup_vec):
// instruction issue, never bytes (8 B/key moved, 12 for ingest: 0.040-0.060
// ms at 2^24 keys on the H100, against 0.11-0.34 ms of kernel time).  The
// keys are hashes, so the lanes of a warp leave the lookup loops at
// different trips, and a warp issues the union of its lanes' paths.  With
// one thread per key (the first build's layout), at n = 1000 a binomial
// warp runs 1.55 loop trips and block A/C's fold where its keys need 1.02
// trips, a jump warp 12.9 steps where its keys need 7.5, and nearly every
// route warp the divert that a quarter of its lanes need (chip_smoke.py
// phase 4 counts these for its data).  So every kernel
// gives each warp a chunk of up to 32 x MAX_ITEMS keys (a grid of resident
// blocks walks the chunks; SMs x blocks per SM comes from the occupancy
// query) and keeps its lanes on the same work, through one loop per engine
// (chunks<Engine>):
//
// - Binomial settles a key on the loop's first trip whenever the candidate
//   is below n (Binomial::first_trip: block A's fold equals the candidate
//   there): 97.6 % of keys at n = 1000, all of them at n = 128.  The rest
//   go onto a queue in the warp's shared memory with one ballot (no
//   atomics), and the warp finishes them densely after the chunk.  Where
//   a key is a plain load (KeySource) all of a lane's loads are issued
//   before its hashing starts.
// - Jump stages the chunk's keys in shared memory with coalesced loads.
//   Each lane runs one chain, four steps per trip; when it ends the lane
//   writes its bucket and takes the chunk's next key, so the warp runs the
//   chunk's total steps rather than 32 times its longest chains.  With
//   n <= 2^23 a chain keeps b + 1 as an exact f32, skipping two of a step's
//   three conversions.  The buckets go back to device memory coalesced.
// - route writes each settled bucket unless it is removed; the removed ones
//   are queued the same way and redirected densely.
//
// Warps share nothing, so no block barrier is needed; __syncwarp() orders
// each warp's shared memory.  (route_load's shared histogram is the one
// exception: a barrier before its first count and one before its flush.)
//
// The fleet state [n_total, n_alive] (route) and n (lookup_dyn) are read
// from device memory and folded into E and M by each thread, so a launch
// needs no host copy of them; lookup_dyn launches for n <= 1 too, where the
// chunk gives zeros.  lookup_vec's n is a launch argument, folded on the
// host, as it is static on the TPU.  chip_smoke.py holds the SASS sizes of
// each build and the card's times beside the bound.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).
//
// Every loop carries a "// ct-loop: <bound>" comment naming what bounds its
// trips (omega, a chunk's keys, the grid's stride, the capacity, r,
// max_resalt, max_chain, or a static count); the SASS gate
// (repro_torch.analysis.sass_gate) maps each back edge of the compiled
// kernels to one of them.
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "routing.cuh"

namespace routing {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ITEMS = 8;          // keys per lane in a warp's chunk
constexpr int SEG = 32 * MAX_ITEMS;   // a warp's chunk, at most
constexpr unsigned FULL = 0xFFFFFFFFu;

// One warp's area of shared memory: its chunk's keys and buckets, and a
// queue of chunk offsets (front: binomial keys whose loop goes on; back:
// removed buckets to divert).  Only its own warp touches it, so __syncwarp()
// orders it and the block never waits on a barrier.
struct WarpArea {
  uint32_t key[SEG];
  uint32_t out[SEG];
  uint8_t queue[SEG];
};

// The lookup's constants: n, E = 2^ceil(log2 n) and M = E/2 (binomial), omega.
struct Lookup {
  uint32_t n, E, M;
  int omega;
};

__device__ __forceinline__ Lookup fold(uint32_t n, int omega) {
  uint32_t m = n - 1u;
  m |= m >> 1;
  m |= m >> 2;
  m |= m >> 4;
  m |= m >> 8;
  m |= m >> 16;
  return {n, m + 1u, (m + 1u) >> 1, omega};
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// What happens to a settled bucket: route diverts the removed ones through
// the replacement table, the bare lookup keeps every bucket.
struct Divert {
  static constexpr bool kDiverts = true;
  Fleet fleet;
  uint32_t n_total, n_alive;
  __device__ __forceinline__ bool removed(uint32_t b) const { return fleet.removed(b); }
  __device__ __forceinline__ uint32_t redirect(uint32_t key, uint32_t b) const {
    return fleet.redirect(key, b, n_total, n_alive);
  }
};

struct Keep {
  static constexpr bool kDiverts = false;
  __device__ __forceinline__ bool removed(uint32_t) const { return false; }
  __device__ __forceinline__ uint32_t redirect(uint32_t, uint32_t b) const { return b; }
};

// What else happens to a settled replica b of flat index i, beside its store:
// nothing (every kernel but route_load), or the load count's sample (i a
// multiple of 2^shift, weight 2^shift, wrapping as u32), in one of two ways.
// GlobalCount adds each sampled key to the (capacity,) accumulator from
// inside the lookup loop (kPerKey).  SharedCount keeps every key's replica
// in the warp's w.out (kKeeps), and the warp adds the chunk's sampled keys
// to the block's histogram in shared memory after the chunk (count_chunk):
// counted inside the loop, a key paid an index test and a branch, and
// binomial 61 registers against route's 48, ~15 us at 2^24 keys on the H100
// (PERF.md §5).  b < n_total <= capacity; an id past the accumulator is not
// counted.
struct NoCount {
  static constexpr bool kPerKey = false;
  static constexpr bool kKeeps = false;
};

struct SharedCount {
  static constexpr bool kPerKey = false;
  static constexpr bool kKeeps = true;
  uint32_t hist;  // the block's bins: their shared-memory address
  uint32_t cap;
  int shift;
  __device__ __forceinline__ void add(uint32_t b) const {
    if (b < cap) {
      asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(hist + 4u * b), "r"(1u << shift)
                   : "memory");
    }
  }
};

struct GlobalCount {
  static constexpr bool kPerKey = true;
  static constexpr bool kKeeps = false;
  uint32_t* counts;
  uint32_t cap;
  uint32_t smask;
  uint32_t weight;
  __device__ __forceinline__ void add(int64_t i, uint32_t b) const {
    if ((static_cast<uint32_t>(i) & smask) == 0 && b < cap) atomicAdd(counts + b, weight);
  }
};

// Binomial over one warp's chunk of `count` keys (base .. base + count - 1):
// every key whose first-trip candidate settles it is written at once; the
// keys whose loop goes on (front) and the removed buckets (back) are queued
// with one ballot each and finished densely by the warp afterwards.  A
// count that keeps (C::kKeeps) also leaves each key's replica in w.out.
template <class Source, class D, class C = NoCount>
__device__ void binomial_chunk(WarpArea& w, const Source& src, const D& d, const Lookup& p,
                               int32_t* __restrict__ out, int64_t base, int count,
                               const C& cnt = C{}) {
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  int front = 0, back = 0;
  // a source that only loads has all its loads issued before the hashing
  // starts; one that computes its key (IdSource, RouterKeySource) loads as
  // it goes, where preloading held more registers and ran slower
  uint32_t keys[MAX_ITEMS];
  if constexpr (Source::kPreload) {
    // ct-loop: static: MAX_ITEMS keys a lane, unrolled
#pragma unroll
    for (int j = 0; j < MAX_ITEMS; ++j) {
      const int e = j * 32 + lane;
      keys[j] = j * 32 < count ? src(base + (e < count ? e : 0)) : 0u;
    }
  }
  // ct-loop: static: MAX_ITEMS keys a lane, unrolled
#pragma unroll
  for (int j = 0; j < MAX_ITEMS; ++j) {
    if (j * 32 >= count) break;
    const int e = j * 32 + lane;
    const bool in = e < count;
    uint32_t key;
    if constexpr (Source::kPreload) {
      key = keys[j];
    } else {
      key = src(base + (in ? e : 0));
    }
    uint32_t c = 0;
    bool more = false;
    if (p.n > 1) {
      c = Binomial::first_trip(key, p.E);
      more = in && !(p.omega >= 1 && c < p.n);
    }
    const bool hit = in && !more && d.removed(c);
    if (in && !more && !hit) out[base + e] = static_cast<int32_t>(c);
    if constexpr (C::kPerKey) {
      if (in && !more && !hit) cnt.add(base + e, c);
    }
    if constexpr (C::kKeeps) {
      if (in) w.out[e] = c;  // the queue loop below rewrites the keys it settles
    }
    const unsigned mf = __ballot_sync(FULL, more);
    if (more) {
      w.queue[front + __popc(mf & below)] = static_cast<uint8_t>(e);
      w.key[e] = key;
    }
    front += __popc(mf);
    if constexpr (D::kDiverts) {
      const unsigned mb = __ballot_sync(FULL, hit);
      if (hit) {
        w.queue[SEG - 1 - back - __popc(mb & below)] = static_cast<uint8_t>(e);
        w.key[e] = key;
        w.out[e] = c;
      }
      back += __popc(mb);
    }
  }
  __syncwarp();
  // ct-loop: chunk: the chunk's queued keys (at most SEG), 32 a trip
  for (int q = lane; q < front + back; q += 32) {
    const bool goes_on = q < front;
    const int e = goes_on ? w.queue[q] : w.queue[SEG - 1 - (q - front)];
    const uint32_t key = w.key[e];
    uint32_t b = goes_on ? Binomial::rest(key, p.n, p.E, p.M, p.omega) : w.out[e];
    if (!goes_on || d.removed(b)) b = d.redirect(key, b);
    out[base + e] = static_cast<int32_t>(b);
    if constexpr (C::kPerKey) cnt.add(base + e, b);
    if constexpr (C::kKeeps) w.out[e] = b;
  }
  __syncwarp();
}

// Jump chains over the keys in w.key[0, count): each lane runs one chain,
// four steps per trip (a chain that ends early keeps its value through the
// trip's remaining steps), and a lane whose chain has ended writes its
// bucket and takes the warp's next key.  Four steps amortise the refill's
// bookkeeping (a ballot, two popcounts, a shared load) over more work, at
// the cost of 1.5 idle steps per key on average.  With n <= 2^23 (kExact) b + 1 stays an exact f32:
// for a continuing chain fj < n, so fj + 2^23 rounded toward zero is
// 2^23 + floor(fj) and subtracting 2^23 - 1 gives floor(fj) + 1, what the
// general path's u32 round trip gives, without its two conversions (24
// SASS instructions a step against 27; PERF.md §6 has its timings).
template <bool kExact>
__device__ void jump_chains(WarpArea& w, int count, uint32_t n, int omega) {
  const unsigned below = lanemask_lt();
  const float fn = __uint2float_rn(n);
  int idx = threadIdx.x & 31;
  int cursor = 32;
  bool live = idx < count;
  uint64_t k = live ? w.key[idx] : 0u;
  uint32_t b = 0;   // the bucket (general path)
  float b1 = 1.0f;  // the bucket + 1 (kExact)
  int left = omega;
  // ct-loop: omega: each of the chunk's keys takes at most omega steps, four a trip
  while (__any_sync(FULL, live)) {
    bool done = false;
    // ct-loop: static: four steps a trip, unrolled
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float fj;
      if constexpr (kExact) {
        fj = Jump::step(k, b1);
      } else {
        fj = Jump::step(k, __uint2float_rn(b + 1u));
      }
      const bool go = !done && fj < fn;
      if constexpr (kExact) {
        b1 = go ? __fsub_rn(__fadd_rz(fj, 8388608.0f), 8388607.0f) : b1;
      } else {
        b = go ? __float2uint_rz(fj) : b;
      }
      left -= go;
      done = done || !go || left == 0;
    }
    // refill without branching: finished lanes store, then take the next keys
    const bool fin = done && live;
    if constexpr (kExact) {
      if (fin) w.out[idx] = __float2uint_rz(b1) - 1u;
    } else {
      if (fin) w.out[idx] = b;
    }
    const unsigned m = __ballot_sync(FULL, fin);
    idx = fin ? cursor + __popc(m & below) : idx;
    cursor += __popc(m);
    live = idx < count;
    const uint32_t next = fin && live ? w.key[idx] : 0u;
    k = fin ? next : k;
    b = fin ? 0u : b;
    b1 = fin ? 1.0f : b1;
    left = fin ? omega : left;
  }
}

// Jump over one warp's chunk: stage the keys (coalesced), run the chains,
// write the buckets back (coalesced), removed ones queued and diverted
// densely.  A count that keeps (C::kKeeps) also leaves each key's replica in
// w.out.
template <class Source, class D, class C = NoCount>
__device__ void jump_chunk(WarpArea& w, const Source& src, const D& d, const Lookup& p,
                           int32_t* __restrict__ out, int64_t base, int count,
                           const C& cnt = C{}) {
  const int lane = threadIdx.x & 31;
  // ct-loop: chunk: the chunk's keys, 32 a trip
  for (int e = lane; e < count; e += 32) w.key[e] = src(base + e);
  __syncwarp();
  if (p.n <= 1 || p.omega <= 0) {
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int e = lane; e < count; e += 32) w.out[e] = 0u;
  } else if (p.n <= (1u << 23)) {
    jump_chains<true>(w, count, p.n, p.omega);
  } else {
    jump_chains<false>(w, count, p.n, p.omega);
  }
  __syncwarp();
  if constexpr (D::kDiverts) {
    const unsigned below = lanemask_lt();
    int hits = 0;
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int j = 0; j * 32 < count; ++j) {
      const int e = j * 32 + lane;
      const bool in = e < count;
      const uint32_t b = in ? w.out[e] : 0u;
      const bool hit = in && d.removed(b);
      if (in && !hit) out[base + e] = static_cast<int32_t>(b);
      if constexpr (C::kPerKey) {
        if (in && !hit) cnt.add(base + e, b);
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) w.queue[hits + __popc(m & below)] = static_cast<uint8_t>(e);
      hits += __popc(m);
    }
    __syncwarp();
    // ct-loop: chunk: the chunk's removed buckets, 32 a trip
    for (int q = lane; q < hits; q += 32) {
      const int e = w.queue[q];
      if constexpr (C::kPerKey || C::kKeeps) {
        const uint32_t b = d.redirect(w.key[e], w.out[e]);
        out[base + e] = static_cast<int32_t>(b);
        if constexpr (C::kPerKey) cnt.add(base + e, b);
        if constexpr (C::kKeeps) w.out[e] = b;
      } else {
        out[base + e] = static_cast<int32_t>(d.redirect(w.key[e], w.out[e]));
      }
    }
  } else {
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int e = lane; e < count; e += 32) out[base + e] = static_cast<int32_t>(w.out[e]);
  }
  __syncwarp();
}

// The count of a routed chunk (C::kKeeps): its sampled indices base + e
// (multiples of 2^shift, e < count: at shift 6 at most 4 of a chunk's 256)
// are known from base, so the warp's lanes add just those replicas, read
// from w.out.  The __syncwarp() keeps w.out until every lane has read it.
template <class C>
__device__ __forceinline__ void count_chunk(const WarpArea& w, const C& cnt, int64_t base,
                                            int count) {
  const uint32_t first = (0u - static_cast<uint32_t>(base)) & ((1u << cnt.shift) - 1u);
  const int sampled = first < static_cast<uint32_t>(count)
                          ? static_cast<int>(((count - 1 - first) >> cnt.shift) + 1)
                          : 0;
  // ct-loop: chunk: the chunk's sampled keys, 32 a trip
  for (int k = threadIdx.x & 31; k < sampled; k += 32) {
    cnt.add(w.out[first + (static_cast<uint32_t>(k) << cnt.shift)]);
  }
  __syncwarp();
}

// Every warp of the grid walks the chunks of 32 * items keys.
template <class Engine, class Source, class D, class C = NoCount>
__device__ __forceinline__ void chunks(WarpArea& w, const Source& src, const D& d,
                                       const Lookup& p, int32_t* __restrict__ out, int64_t n,
                                       int items, const C& cnt = C{}) {
  const int64_t seg = 32 * items;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * seg;
  // ct-loop: grid: the warp's chunks, one resident grid's stride apart
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * seg;
       base < n; base += stride) {
    const int count = static_cast<int>(n - base < seg ? n - base : seg);
    if constexpr (std::is_same_v<Engine, Binomial>) {
      binomial_chunk(w, src, d, p, out, base, count, cnt);
    } else {
      jump_chunk(w, src, d, p, out, base, count, cnt);
    }
    if constexpr (C::kKeeps) count_chunk(w, cnt, base, count);
  }
}

template <class Engine, class Source>
__global__ void __launch_bounds__(THREADS)
route_kernel(Source src, Fleet fleet, const int32_t* __restrict__ state, int omega,
             int32_t* __restrict__ out, int64_t n, int items) {
  __shared__ WarpArea area[WARPS];
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  chunks<Engine>(area[threadIdx.x >> 5], src, Divert{fleet, n_total, n_alive},
                 fold(n_total, omega), out, n, items);
}

// The instrumented route: route_kernel's loop over u32 keys, the sampled
// replicas also counted (SharedCount / GlobalCount say how).  With kShared
// (capacity <= SHARED_BINS) a block counts into its own histogram in shared
// memory and, once every warp has left the chunk loop (a warp with no chunk
// reaches the barrier at once), adds its nonzero bins to `counts` with one
// global atomic each; above SHARED_BINS the histogram would cost occupancy
// (the WarpAreas already take 18 KB a block), so every counted key is one
// global atomic, added from inside the loop (GlobalCount): counted after
// each chunk instead, it ran slower in 7 of chip_smoke.py's 8 timed cells
// (PERF.md §6).  Unsigned adds wrap as the reference's u32 sums do.
constexpr int SHARED_BINS = 4096;  // 16 KB of u32 bins

template <class Engine, bool kShared>
__global__ void __launch_bounds__(THREADS)
route_load_kernel(KeySource src, Fleet fleet, const int32_t* __restrict__ state, int omega,
                  int32_t* __restrict__ out, int64_t n, int items, uint32_t* __restrict__ counts,
                  uint32_t cap, int shift) {
  __shared__ WarpArea area[WARPS];
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const uint32_t smask = (1u << shift) - 1u;
  const uint32_t weight = 1u << shift;
  const Divert d{fleet, n_total, n_alive};
  if constexpr (kShared) {
    __shared__ uint32_t hist[SHARED_BINS];
    // ct-loop: capacity: the block's bins, THREADS a trip
    for (uint32_t b = threadIdx.x; b < cap; b += THREADS) hist[b] = 0u;
    __syncthreads();
    chunks<Engine>(area[threadIdx.x >> 5], src, d, fold(n_total, omega), out, n, items,
                   SharedCount{static_cast<uint32_t>(__cvta_generic_to_shared(hist)), cap,
                               shift});
    __syncthreads();
    // ct-loop: capacity: the block's bins, THREADS a trip
    for (uint32_t b = threadIdx.x; b < cap; b += THREADS) {
      const uint32_t v = hist[b];
      if (v) atomicAdd(counts + b, v);
    }
  } else {
    chunks<Engine>(area[threadIdx.x >> 5], src, d, fold(n_total, omega), out, n, items,
                   GlobalCount{counts, cap, smask, weight});
  }
}

template <class Engine, class Source>
__global__ void __launch_bounds__(THREADS)
lookup_vec_kernel(Source src, uint32_t n_buckets, uint32_t E, uint32_t M, int omega,
                  int32_t* __restrict__ out, int64_t n, int items) {
  __shared__ WarpArea area[WARPS];
  chunks<Engine>(area[threadIdx.x >> 5], src, Keep{}, Lookup{n_buckets, E, M, omega}, out, n,
                 items);
}

template <class Engine>
__global__ void __launch_bounds__(THREADS)
lookup_dyn_kernel(KeySource src, const int32_t* __restrict__ n_ptr, int omega,
                  int32_t* __restrict__ out, int64_t n, int items) {
  __shared__ WarpArea area[WARPS];
  const uint32_t n_buckets = static_cast<uint32_t>(n_ptr[0]);
  chunks<Engine>(area[threadIdx.x >> 5], src, Keep{}, fold(n_buckets, omega), out, n, items);
}

// The distinct-resolution pass of an R-way placement, one thread per key with
// its routed columns in registers (kRegs: r <= MAX_R): column j keeps its routed shard
// unless an earlier settled column holds it; then a re-salt hash picks a
// position in the table's alive prefix and up to max_resalt linear probes
// take the first slots[q] no earlier column holds.  The reference tests
// "taken" with a per-lane bitmask of n_words u32 words set through select
// cascades (store.py:140-153); that mask only ever holds the columns settled
// before j, and every shard id is below 32 * n_words, so "bit b set" is
// exactly "b equals an earlier settled column", which is what taken()
// compares.  A probe that finds a free shard ends the chain: later probes of
// the reference change nothing then.  n_alive <= j leaves the defined
// duplicate and is no exhaustion.  With `old` (the placement before a
// membership change) the launch also writes moved[i, j] = out[i, j] not in
// old[i, :].  exhausted and moved are bool tensors (one byte each).  Past
// MAX_R columns (!kRegs) the thread compares against the columns it has
// already written to its own row of `out` (its own stores, visible to its
// loads; mostly L1 hits), and the moved mask against its row of `old`: the
// same semantics, in the same launch.
constexpr int MAX_R = 8;
constexpr uint32_t RESALT_SALT = 0x7F4A7C15u;

__device__ __forceinline__ bool taken(const uint32_t (&col)[MAX_R], int j, uint32_t b) {
  bool hit = false;
  // ct-loop: static: MAX_R register columns, unrolled
#pragma unroll
  for (int k = 0; k < MAX_R; ++k) hit |= k < j && col[k] == b;
  return hit;
}

// "taken" past the registers: b equals one of the row's first j columns.
__device__ __forceinline__ bool taken_row(const int32_t* row, int j, uint32_t b) {
  bool hit = false;
  // ct-loop: r: the row's settled columns
  for (int k = 0; k < j; ++k) hit |= static_cast<uint32_t>(row[k]) == b;
  return hit;
}

template <bool kRegs>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ base,
               const int32_t* __restrict__ slots, const int32_t* __restrict__ state, int r,
               int max_resalt, const int32_t* __restrict__ old, int32_t* __restrict__ out,
               uint8_t* __restrict__ exhausted, uint8_t* __restrict__ moved, int64_t n) {
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  // ct-loop: grid: one key a thread, one launch grid's stride apart
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < n; i += stride) {
    if constexpr (!kRegs) {
      const uint32_t key = keys[i];
      int32_t* row = out + i * r;
      bool ex = false;
      // ct-loop: r: the key's columns
      for (int j = 0; j < r; ++j) {
        uint32_t b = static_cast<uint32_t>(base[i * r + j]);
        if (j > 0) {
          bool coll = taken_row(row, j, b);
          uint32_t q = __umulhi(mix32(mix32(key ^ family_salt(j)) ^ RESALT_SALT), n_alive);
          // ct-loop: max_resalt: the column's probes
          for (int p = 0; coll && p < max_resalt; ++p) {
            const uint32_t cand = static_cast<uint32_t>(slots[q]);
            if (!taken_row(row, j, cand)) {
              b = cand;
              coll = false;
            }
            q += 1u;
            if (q >= n_alive) q -= n_alive;
          }
          ex |= coll && static_cast<uint32_t>(j) < n_alive;
        }
        row[j] = static_cast<int32_t>(b);
      }
      exhausted[i] = ex;
      if (old != nullptr) {
        const int32_t* prev = old + i * r;
        // ct-loop: r: the key's columns
        for (int j = 0; j < r; ++j) {
          const int32_t b = row[j];
          bool kept = false;
          // ct-loop: r: the key's old columns
          for (int k = 0; k < r; ++k) kept |= prev[k] == b;
          moved[i * r + j] = !kept;
        }
      }
      continue;
    }
    const uint32_t key = keys[i];
    uint32_t col[MAX_R];
    bool ex = false;
    // ct-loop: static: MAX_R register columns, unrolled
#pragma unroll
    for (int j = 0; j < MAX_R; ++j) {
      if (j >= r) break;
      uint32_t b = static_cast<uint32_t>(base[i * r + j]);
      if (j > 0) {
        bool coll = taken(col, j, b);
        uint32_t q = __umulhi(mix32(mix32(key ^ family_salt(j)) ^ RESALT_SALT), n_alive);
        // ct-loop: max_resalt: the column's probes
        for (int p = 0; coll && p < max_resalt; ++p) {
          const uint32_t cand = static_cast<uint32_t>(slots[q]);
          if (!taken(col, j, cand)) {
            b = cand;
            coll = false;
          }
          q += 1u;
          if (q >= n_alive) q -= n_alive;  // conditional wrap, no division
        }
        ex |= coll && static_cast<uint32_t>(j) < n_alive;
      }
      col[j] = b;
      out[i * r + j] = static_cast<int32_t>(b);
    }
    exhausted[i] = ex;
    if (old != nullptr) {
      uint32_t prev[MAX_R];
      // ct-loop: static: MAX_R register columns, unrolled
#pragma unroll
      for (int k = 0; k < MAX_R; ++k) prev[k] = k < r ? static_cast<uint32_t>(old[i * r + k]) : 0u;
      // ct-loop: static: MAX_R register columns, unrolled
#pragma unroll
      for (int j = 0; j < MAX_R; ++j) {
        if (j >= r) break;
        bool kept = false;
        // ct-loop: static: MAX_R register columns, unrolled
#pragma unroll
        for (int k = 0; k < MAX_R; ++k) kept |= k < r && prev[k] == col[j];
        moved[i * r + j] = !kept;
      }
    }
  }
}

// The rejection-chain remap: a key whose base bucket b is removed moves to
// hash_pair(hash^(s+1)(key), b) % n_total at step s = 0, 1, ... until it
// lands on an alive slot; after max_chain steps it takes first_alive.  It
// replaces src/repro/core/memento_jax.py:101-145 (memento_remap), a
// lax.while_loop over the whole batch whose rounds end when every lane has
// settled or at i = max_chain.  A lane that settles stays put, so each key's
// answer depends only on its own walk and that shared bound: walking the
// keys one at a time, in any order and in any lane, gives the whole-batch
// loop's answer bit for bit.
//
// The removed mask is read as the packed u32 words (bit b = slot b removed)
// that FleetState and ChainFleet already hold, not as the JAX package's
// (capacity,) bool array; words past n_words read as 0 (b < n_total <=
// capacity, so a real gather never goes past them).  n_total and
// first_alive are read from device memory (state[0], state[1]), so a fleet
// event costs the host no synchronisation and no launch argument is ever
// stale.  n_total >= 1 (a domain never empties its slot space).
//
// One thread per key (the first build) made a warp issue the longest of its
// 32 walks: at a failed share f, the maximum of 32 geometric walk lengths
// (5.4 steps at f = 1/2) where a removed key needs 1/(1-f) (2.0).  So a
// resident grid of warps (shape_for) walks chunks of 32 x items keys, and
// each warp
// - scans a chunk: loads its buckets coalesced, stores every bucket at once
//   (whole sectors: a removed key's base bucket stands until its walk ends)
//   and appends each removed key to a ring in the warp's shared memory with
//   one ballot per 32 keys: its position and bucket, and its key by a
//   cp.async that the scan does not wait for.  A key is read only where its
//   bucket is removed; with max_chain = 0 those lanes store first_alive and
//   nothing is queued;
// - walks the ring with lane refill: each lane holds one queued key and
//   takes one step of it between refills; a lane whose walk ended stores
//   its answer and takes the ring's next entry through a ballot cursor,
//   waiting for the key copies only when it reaches the last scan's;
// - scans its next chunk whenever fewer than CHAIN_LOW keys wait, so the
//   ring carries across chunks and the lanes stay busy until the warp's
//   last chunk: a warp issues about its keys' total steps / 32 trips and
//   one tail of its longest walk, not one longest walk per 32 keys.
// % n_total is Lemire's fastmod: M = 2^64 / n_total rounded up, computed
// once per thread, and x % n_total = the high word of (M * x mod 2^64) *
// n_total, exact for every u32 x and 1 <= n_total < 2^32 (n_total = 1 wraps
// M to 0 and gives 0); two wide multiplies, no division.
//
// What bounds it, on chip_smoke.py phase 4's 1000 of 1024 slots: bytes, at
// every failed share up to one half (8 B a key, and the 32-byte key sectors
// that hold a removed key: none healthy, nine in ten at a quarter failed);
// the work's instructions (CHAIN_KEY, CHAIN_REMOVED and CHAIN_STEP in
// chip_smoke.py, counted from this build's SASS) stay just below them at
// one half.  Healthy the scan streams at about 0.7 of the bytes bound; each
// failed share adds the removed keys' reads and walk steps to it, and at one
// half the walk, with the refill's bookkeeping (CHAIN_TRIP), issues more
// than the bytes take (phase 4 prints the time at max_chain 0 and 1 beside
// the default, and what this build issues).
constexpr int CHAIN_LOW = 64;             // scan while fewer keys wait
constexpr int CHAIN_Q = CHAIN_LOW + SEG;  // the ring: what waits + one chunk

// One warp's ring of removed keys: chunk position, key (copied in by
// cp.async), bucket.  A queued key's position is c * SEG + e for offset e
// of the warp's c-th chunk: a u32 while a warp has fewer than 2^24 chunks
// (the launch checks).
struct ChainRing {
  uint32_t pos[CHAIN_Q];
  uint32_t key[CHAIN_Q];
  uint32_t bucket[CHAIN_Q];
};

__device__ __forceinline__ bool removed_bit(const uint32_t* __restrict__ mask, int n_words,
                                            uint32_t b) {
  const uint32_t w = b >> 5;
  const uint32_t word = w < static_cast<uint32_t>(n_words) ? mask[w] : 0u;
  return ((word >> (b & 31u)) & 1u) != 0;
}

// x % d for the magic M = UINT64_MAX / d + 1: the high 64 bits of
// (M * x mod 2^64) * d, from two 32 x 32 -> 64 products.
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t M, uint32_t d) {
  const uint64_t low = M * x;
  const uint64_t lo = static_cast<uint64_t>(static_cast<uint32_t>(low)) * d;
  const uint64_t hi = static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) * d;
  return static_cast<uint32_t>((hi + (lo >> 32)) >> 32);
}

__global__ void __launch_bounds__(THREADS)
chain_remap_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ buckets,
                   const uint32_t* __restrict__ mask, int n_words,
                   const int32_t* __restrict__ state, int max_chain, int32_t* __restrict__ out,
                   int64_t n, int items) {
  __shared__ ChainRing rings[WARPS];
  ChainRing& r = rings[threadIdx.x >> 5];
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t first_alive = static_cast<uint32_t>(state[1]);
  const uint64_t M = ~0ull / n_total + 1ull;
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  const uint32_t key_dst = static_cast<uint32_t>(__cvta_generic_to_shared(r.key));
  const int64_t seg = 32 * items;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * seg;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * seg;
  uint32_t scan = 0;         // the warp's next chunk: it starts at first + scan * stride
  int head = 0, queued = 0;  // the ring's entries: head, head + 1, ... mod CHAIN_Q
  int fresh = 0;             // the last `fresh` of them came from the last scan
  bool live = false;         // this lane walks a key: output index, key + s * GOLDEN32,
  int64_t at = 0;            // bucket, steps left
  uint32_t kacc = 0, b = 0;
  int left = 0;
  // ct-loop: max_chain: each queued key walks at most max_chain steps (the chain baseline's bound)
  while (true) {
    // top up: scan chunks while fewer than CHAIN_LOW keys wait
    // ct-loop: grid: the warp's chunks, scanned while fewer than CHAIN_LOW keys wait
    for (int64_t base = first + scan * stride; queued < CHAIN_LOW && base < n;
         base += stride, ++scan) {
      const int count = static_cast<int>(n - base < seg ? n - base : seg);
      uint32_t bk[MAX_ITEMS];
      // ct-loop: static: MAX_ITEMS keys a lane, unrolled
#pragma unroll
      for (int j = 0; j < MAX_ITEMS; ++j) {
        const int e = j * 32 + lane;
        bk[j] = e < count ? buckets[base + e] : 0u;
      }
      fresh = 0;
      // ct-loop: static: MAX_ITEMS keys a lane, unrolled
#pragma unroll
      for (int j = 0; j < MAX_ITEMS; ++j) {
        if (j * 32 >= count) break;
        const int e = j * 32 + lane;
        const bool in = e < count;
        const bool hit = in && removed_bit(mask, n_words, bk[j]);
        // whole sectors: a removed key's base bucket stands until its walk
        // ends (max_chain = 0: first_alive at once)
        if (in) out[base + e] = static_cast<int32_t>(hit && max_chain == 0 ? first_alive : bk[j]);
        const bool walk = hit && max_chain > 0;
        const unsigned m = __ballot_sync(FULL, walk);
        if (walk) {
          int q = head + queued + fresh + __popc(m & below);
          q = q >= CHAIN_Q ? q - CHAIN_Q : q;
          r.pos[q] = scan * SEG + e;
          r.bucket[q] = bk[j];
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(key_dst + 4u * q),
                       "l"(keys + base + e)
                       : "memory");
        }
        fresh += __popc(m);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      queued += fresh;
    }
    // refill: idle lanes take the next entries in lane order, once the
    // copies of their keys have landed (the last scan's only if needed)
    const unsigned idle = __ballot_sync(FULL, !live);
    const int taken = min(__popc(idle), queued);
    if (taken > queued - fresh) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      fresh = 0;
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    __syncwarp();
    const int rank = __popc(idle & below);
    if (!live && rank < taken) {
      int q = head + rank;
      q = q >= CHAIN_Q ? q - CHAIN_Q : q;
      const uint32_t p = r.pos[q];
      at = first + static_cast<int64_t>(p / SEG) * stride + p % SEG;
      kacc = r.key[q];
      b = r.bucket[q];
      left = max_chain;
      live = true;
    }
    head += taken;
    head = head >= CHAIN_Q ? head - CHAIN_Q : head;
    queued -= taken;
    fresh = min(fresh, queued);
    if (!__any_sync(FULL, live)) break;  // nothing queued, no chunk left
    if (live) {  // one step
      kacc += GOLDEN32;
      b = fastmod(hash_pair(mix32(kacc), b), M, n_total);
      const bool alive = !removed_bit(mask, n_words, b);
      if (alive || --left == 0) {
        out[at] = static_cast<int32_t>(alive ? b : first_alive);
        live = false;
      }
    }
    __syncwarp();  // the ring's slots just read are written again by the next scan
  }
}

// Keys per lane and chunk, and the grid: as many keys per lane (up to
// MAX_ITEMS) as fill the blocks the card holds at once, then at most one
// block per THREADS * items keys.  `resident` caches, per device, the blocks of `kernel` that
// fit at once (SMs x the occupancy query), so each kernel queries it once.
struct Shape {
  int grid, items;
};

// The launch log: the shape of each launch this host thread made since the
// log was last taken (routing_take_launches), written where each kernel is
// launched, so a caller can read back the grids a call really launched (the
// SASS gate's severity check holds a healthy fleet's against a storm's).
// The first LOG_LAUNCHES are kept; the count goes on.
constexpr int LOG_LAUNCHES = 16;
thread_local Shape launch_log[LOG_LAUNCHES];
thread_local int64_t launches_logged = 0;

inline void log_launch(Shape shape) {
  if (launches_logged < LOG_LAUNCHES) launch_log[launches_logged] = shape;
  ++launches_logged;
}

template <class Kernel>
Shape shape_for(Kernel kernel, int64_t n, int (&resident)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < 64 ? dev : 0;
  if (!resident[slot]) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[slot] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t blocks = resident[slot];
  int64_t items = (n + blocks * THREADS - 1) / (blocks * THREADS);
  items = items < 1 ? 1 : (items > MAX_ITEMS ? MAX_ITEMS : items);
  const int64_t tiles = (n + THREADS * items - 1) / (THREADS * items);
  return {static_cast<int>(tiles < blocks ? tiles : blocks), static_cast<int>(items)};
}

Shape chain_shape(int64_t n) {
  static int resident[64] = {};
  return shape_for(chain_remap_kernel, n, resident);
}

int launch_chain_remap(const void* keys, const void* buckets, const void* mask, int n_words,
                       const void* state, int max_chain, void* out, int64_t n,
                       cudaStream_t stream) {
  if (max_chain < 0) return -1;
  const Shape shape = chain_shape(n);
  // a queued key's position c * SEG + e is a u32: fewer than 2^24 chunks a warp
  const int64_t stride = static_cast<int64_t>(shape.grid) * THREADS * shape.items;
  if ((n + stride - 1) / stride >= (int64_t{1} << 24)) return -1;
  log_launch(shape);
  chain_remap_kernel<<<shape.grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(buckets),
      static_cast<const uint32_t*>(mask), n_words, static_cast<const int32_t*>(state), max_chain,
      static_cast<int32_t*>(out), n, shape.items);
  return static_cast<int>(cudaGetLastError());
}

template <class Engine, class Source>
int launch_route(Source src, const void* mask, int n_words, const void* slots, int n_slots,
                 const void* state, int omega, void* out, int64_t n, cudaStream_t stream) {
  static int resident[64] = {};
  const Shape shape = shape_for(route_kernel<Engine, Source>, n, resident);
  const Fleet fleet{static_cast<const uint32_t*>(mask), n_words,
                    static_cast<const int32_t*>(slots), n_slots};
  log_launch(shape);
  route_kernel<Engine, Source><<<shape.grid, THREADS, 0, stream>>>(
      src, fleet, static_cast<const int32_t*>(state), omega, static_cast<int32_t*>(out), n,
      shape.items);
  return static_cast<int>(cudaGetLastError());
}

template <class Engine, bool kShared>
Shape route_load_shape(int64_t n) {
  static int resident[64] = {};
  return shape_for(route_load_kernel<Engine, kShared>, n, resident);
}

template <class Engine, bool kShared>
int launch_route_load_as(KeySource src, const Fleet& fleet, const void* state, int omega,
                         void* out, int64_t n, void* counts, uint32_t cap, int shift,
                         cudaStream_t stream) {
  const Shape shape = route_load_shape<Engine, kShared>(n);
  log_launch(shape);
  route_load_kernel<Engine, kShared><<<shape.grid, THREADS, 0, stream>>>(
      src, fleet, static_cast<const int32_t*>(state), omega, static_cast<int32_t*>(out), n,
      shape.items, static_cast<uint32_t*>(counts), cap, shift);
  return static_cast<int>(cudaGetLastError());
}

template <class Engine>
int launch_route_load(KeySource src, const void* mask, int n_words, const void* slots,
                      int n_slots, const void* state, int omega, void* out, int64_t n,
                      void* counts, int capacity, int shift, cudaStream_t stream) {
  if (capacity < 1 || shift < 0 || shift > 31) return -1;
  const Fleet fleet{static_cast<const uint32_t*>(mask), n_words,
                    static_cast<const int32_t*>(slots), n_slots};
  const uint32_t cap = static_cast<uint32_t>(capacity);
  if (capacity <= SHARED_BINS) {
    return launch_route_load_as<Engine, true>(src, fleet, state, omega, out, n, counts, cap,
                                              shift, stream);
  }
  return launch_route_load_as<Engine, false>(src, fleet, state, omega, out, n, counts, cap,
                                             shift, stream);
}

template <class Engine>
int launch_lookup_dyn(KeySource src, const void* n_buckets, int omega, void* out, int64_t n,
                      cudaStream_t stream) {
  static int resident[64] = {};
  const Shape shape = shape_for(lookup_dyn_kernel<Engine>, n, resident);
  log_launch(shape);
  lookup_dyn_kernel<Engine><<<shape.grid, THREADS, 0, stream>>>(
      src, static_cast<const int32_t*>(n_buckets), omega, static_cast<int32_t*>(out), n,
      shape.items);
  return static_cast<int>(cudaGetLastError());
}

template <class Engine, class Source>
int launch_lookup_vec(Source src, unsigned n_buckets, unsigned E, unsigned M, int omega,
                      void* out, int64_t n, cudaStream_t stream) {
  static int resident[64] = {};
  const Shape shape = shape_for(lookup_vec_kernel<Engine, Source>, n, resident);
  log_launch(shape);
  lookup_vec_kernel<Engine, Source><<<shape.grid, THREADS, 0, stream>>>(
      src, n_buckets, E, M, omega, static_cast<int32_t*>(out), n, shape.items);
  return static_cast<int>(cudaGetLastError());
}

int launch_resolve(const void* keys, const void* base, const void* slots, const void* state,
                   int r, int max_resalt, const void* old, void* out, void* exhausted,
                   void* moved, int64_t n, cudaStream_t stream) {
  if (r < 1) return -1;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(blocks < (1 << 30) ? blocks : (1 << 30));
  // the register path for r <= MAX_R, the row path beyond
  auto* kernel = r <= MAX_R ? resolve_kernel<true> : resolve_kernel<false>;
  log_launch({grid, 1});
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(state), r, max_resalt,
      static_cast<const int32_t*>(old), static_cast<int32_t*>(out),
      static_cast<uint8_t*>(exhausted), static_cast<uint8_t*>(moved), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace routing

// engine: 0 = binomial, 1 = jump.  Returns a cudaError_t, or -1 for an
// unknown engine.  All pointers are device pointers; n > 0.
extern "C" int routing_route(int engine, const void* keys, const void* mask, int n_words,
                             const void* slots, int n_slots, const void* state, int omega,
                             void* out, long long n, void* stream) {
  using namespace routing;
  const KeySource src{static_cast<const uint32_t*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_route<Binomial>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    case 1: return launch_route<Jump>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    default: return -1;
  }
}

extern "C" int routing_ingest(int engine, const void* lo, const void* hi, const void* mask,
                              int n_words, const void* slots, int n_slots, const void* state,
                              int omega, void* out, long long n, void* stream) {
  using namespace routing;
  const IdSource src{static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_route<Binomial>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    case 1: return launch_route<Jump>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    default: return -1;
  }
}

extern "C" int routing_lookup_dyn(int engine, const void* keys, const void* n_buckets,
                                  int omega, void* out, long long n, void* stream) {
  using namespace routing;
  const KeySource src{static_cast<const uint32_t*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_lookup_dyn<Binomial>(src, n_buckets, omega, out, n, s);
    case 1: return launch_lookup_dyn<Jump>(src, n_buckets, omega, out, n, s);
    default: return -1;
  }
}

// n_buckets >= 2; E and M as binomial_hash.py:64-66 computes them (jump
// ignores E and M).  The wrapper answers n <= 1 with zeros and no launch.
extern "C" int routing_lookup_vec(int engine, const void* keys, unsigned int n_buckets,
                                  unsigned int E, unsigned int M, int omega, void* out,
                                  long long n, void* stream) {
  using namespace routing;
  const KeySource src{static_cast<const uint32_t*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_lookup_vec<Binomial>(src, n_buckets, E, M, omega, out, n, s);
    case 1: return launch_lookup_vec<Jump>(src, n_buckets, E, M, omega, out, n, s);
    default: return -1;
  }
}

// The MoE hash router's call: token ids (their low 32-bit words at `stride`
// words apart) -> n = tokens x top_k expert ids, key i built in-register as
// RouterKeySource says; salt0 = layer_salt * 1000003 mod 2^32.  n < 2^32.
extern "C" int routing_lookup_router(int engine, const void* tokens, int stride,
                                     unsigned int salt0, unsigned int top_k,
                                     unsigned int n_buckets, unsigned int E, unsigned int M,
                                     int omega, void* out, long long n, void* stream) {
  using namespace routing;
  const RouterKeySource src{static_cast<const uint32_t*>(tokens), stride, salt0, top_k};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_lookup_vec<Binomial>(src, n_buckets, E, M, omega, out, n, s);
    case 1: return launch_lookup_vec<Jump>(src, n_buckets, E, M, omega, out, n, s);
    default: return -1;
  }
}

// The instrumented route: the route of n u32 keys into out, and counts
// (capacity u32 bins) advanced in place by the replicas of flat indices that
// are multiples of 2^shift, 2^shift each (0 <= shift <= 31; -1 otherwise).
extern "C" int routing_route_load(int engine, const void* keys, const void* mask, int n_words,
                                  const void* slots, int n_slots, const void* state, int omega,
                                  void* out, long long n, void* counts, int capacity, int shift,
                                  void* stream) {
  using namespace routing;
  const KeySource src{static_cast<const uint32_t*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_route_load<Binomial>(src, mask, n_words, slots, n_slots, state, omega,
                                               out, n, counts, capacity, shift, s);
    case 1: return launch_route_load<Jump>(src, mask, n_words, slots, n_slots, state, omega, out,
                                           n, counts, capacity, shift, s);
    default: return -1;
  }
}

// route_load's grid for n keys at this capacity (the resident blocks, or
// fewer for a small n), so a caller can size a pass of the resident grid;
// -1 for an unknown engine.
extern "C" int routing_route_load_grid(int engine, long long n, int capacity) {
  using namespace routing;
  const bool shared = capacity <= SHARED_BINS;
  switch (engine) {
    case 0:
      return (shared ? route_load_shape<Binomial, true>(n) : route_load_shape<Binomial, false>(n))
          .grid;
    case 1:
      return (shared ? route_load_shape<Jump, true>(n) : route_load_shape<Jump, false>(n)).grid;
    default: return -1;
  }
}

// An R-way placement's family route: keys (N,) -> out (N, r) row-major, the
// route of key i / r under family salt i % r; n = N * r < 2^32.
extern "C" int routing_route_family(int engine, const void* keys, unsigned int r,
                                    const void* mask, int n_words, const void* slots,
                                    int n_slots, const void* state, int omega, void* out,
                                    long long n, void* stream) {
  using namespace routing;
  const FamilyKeySource src{static_cast<const uint32_t*>(keys), r};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_route<Binomial>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    case 1: return launch_route<Jump>(src, mask, n_words, slots, n_slots, state, omega, out, n, s);
    default: return -1;
  }
}

// The distinct-resolution pass over n keys' (n, r) routed columns `base`,
// r >= 1 (-1 otherwise); old and moved may both be null.
extern "C" int routing_resolve(const void* keys, const void* base, const void* slots,
                               const void* state, int r, int max_resalt, const void* old,
                               void* out, void* exhausted, void* moved, long long n,
                               void* stream) {
  return routing::launch_resolve(keys, base, slots, state, r, max_resalt, old, out, exhausted,
                                 moved, n, static_cast<cudaStream_t>(stream));
}

// Takes this host thread's launch log: writes the (grid, items) of up to
// max of the launches made since the last take into out (2 ints each),
// empties the log, and returns the count of launches made (which may exceed
// what was kept).
extern "C" int routing_take_launches(void* out, int max) {
  using namespace routing;
  const int64_t made = launches_logged;
  const int64_t kept = made < LOG_LAUNCHES ? made : LOG_LAUNCHES;
  if (max > 0) std::memcpy(out, launch_log, sizeof(Shape) * (kept < max ? kept : max));
  launches_logged = 0;
  return static_cast<int>(made < (int64_t{1} << 30) ? made : (int64_t{1} << 30));
}

// The chain-mode remap of n keys' base buckets: state = [n_total,
// first_alive] on the device, mask the packed removed words (n_words of
// them); max_chain >= 0 (-1 otherwise).
extern "C" int routing_chain_remap(const void* keys, const void* buckets, const void* mask,
                                   int n_words, const void* state, int max_chain, void* out,
                                   long long n, void* stream) {
  return routing::launch_chain_remap(keys, buckets, mask, n_words, state, max_chain, out, n,
                                     static_cast<cudaStream_t>(stream));
}

// The chain remap's grid for n keys (the resident blocks, or fewer for a
// small n), so a caller can reckon the keys and walk steps per lane.
extern "C" int routing_chain_grid(long long n) { return routing::chain_shape(n).grid; }
