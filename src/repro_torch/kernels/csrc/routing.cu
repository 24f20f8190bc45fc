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
//   resolve_kernel / resolve_rows_kernel the distinct-resolution pass of
//       route_replicas_impl (store.py:131-178), which the reference runs as
//       elementwise jnp outside any Pallas kernel; one thread per key with
//       its columns in registers up to r = MAX_R, and beyond, a warp's rows
//       staged in shared memory and resolved there, a lane a key;
//   place_kernel<Engine>              the family route and the resolution in
//       one launch for r <= MAX_R (the placement's main path): a warp routes
//       a chunk of whole objects with the route's chunk code, keeps their
//       columns in shared memory, resolves them a lane an object and writes
//       the rows coalesced, so the (N, r) routed columns never reach device
//       memory (see its note); r > MAX_R keeps the family route and the row
//       path;
//   node_route_kernel<Engine>         the node level of a rack-aware
//       placement: each object's r columns, given r distinct racks by the
//       placement above over the rack fleet, routed inside their racks over
//       a stacked table of the racks' fleets, with the same chunk code (no
//       TPU counterpart: the JAX package has no failure domains; see its
//       note);
//   route_load_kernel<Engine, kShared> the instrumented route of
//       src/repro/observability/load.py:71-118 (route_with_load_impl, jnp in
//       the reference, one jitted dispatch): route_kernel's chunk loop with
//       the sampled replicas also counted into a (capacity,) u32
//       accumulator after each chunk, in the same launch;
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
// kernels to one of them.  Every loop whose bound is not static also
// counts its trips in the counting build (CT_TRIPS in routing.cuh), and
// the gate holds each count to its tag's bound for the launch.
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

// What else happens to a settled replica of flat index i, beside its store:
// nothing (every kernel but route_load), or the load count's sample (i a
// multiple of 2^shift, weight 2^shift, wrapping as u32).  A sampled count
// is added after each chunk (count_chunk) from the chunk's sampled
// positions alone, which base and the shift give: SharedCount keeps every
// key's replica in the warp's w.out (kKeeps) and adds the sampled ones to
// the block's histogram in shared memory; GlobalCount (kReads) keeps
// nothing and reads the sampled replicas back from `out`, where the chunk
// has just stored them, adding each to the (capacity,) accumulator with one
// global reduction.  Counted inside the loop instead, a key paid an index
// test and a branch, and binomial 61 registers against route's 48: ~15 us
// at 2^24 keys on the H100 for the shared histogram (PERF.md §5), 10.7 us
// at shift 6 for the global one (PERF.md §6).  Every key counted (shift 0,
// DenseCount, kPerKey) needs no index test, and there each key's reduction
// goes out where the loop settles it, spread over the chunk's work: after
// each chunk the same reductions came as a burst behind the read-back,
// 4.4 us slower at 2^20 keys and 12 at 2^24 on 40000/65536 (PERF.md §6).
// b < n_total <= capacity; an id past the accumulator is not counted.
struct NoCount {
  static constexpr bool kKeeps = false;
  static constexpr bool kReads = false;
  static constexpr bool kPerKey = false;
  static constexpr bool kStores = true;
};

struct SharedCount {
  static constexpr bool kKeeps = true;
  static constexpr bool kReads = false;
  static constexpr bool kPerKey = false;
  static constexpr bool kStores = true;
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
  static constexpr bool kKeeps = false;
  static constexpr bool kReads = true;
  static constexpr bool kPerKey = false;
  static constexpr bool kStores = true;
  uint32_t* counts;
  uint32_t cap;
  int shift;
  __device__ __forceinline__ void add(uint32_t b) const {
    if (b < cap) {
      asm volatile("red.global.add.u32 [%0], %1;" ::"l"(counts + b), "r"(1u << shift) : "memory");
    }
  }
};

struct DenseCount {
  static constexpr bool kKeeps = false;
  static constexpr bool kReads = false;
  static constexpr bool kPerKey = true;
  static constexpr bool kStores = true;
  uint32_t* counts;
  uint32_t cap;
  __device__ __forceinline__ void add(uint32_t b) const {
    if (b < cap) asm volatile("red.global.add.u32 [%0], %1;" ::"l"(counts + b), "r"(1u) : "memory");
  }
};

// The fused placement's (place_kernel): no count, every settled replica
// kept in the warp's w.out for the resolution in the same launch, and none
// stored to `out` (kStores false; every other policy stores).
struct Stage {
  static constexpr bool kKeeps = true;
  static constexpr bool kReads = false;
  static constexpr bool kPerKey = false;
  static constexpr bool kStores = false;
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
    if constexpr (C::kStores) {
      if (in && !more && !hit) out[base + e] = static_cast<int32_t>(c);
    }
    if constexpr (C::kPerKey) {
      if (in && !more && !hit) cnt.add(c);
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
  CT_TRIPS(BINOMIAL_QUEUE);
  // ct-loop: chunk: the chunk's queued keys (at most SEG), 32 a trip
  for (int q = lane; q < front + back; q += 32) {
    CT_TRIP(BINOMIAL_QUEUE);
    const bool goes_on = q < front;
    const int e = goes_on ? w.queue[q] : w.queue[SEG - 1 - (q - front)];
    const uint32_t key = w.key[e];
    uint32_t b = goes_on ? Binomial::rest(key, p.n, p.E, p.M, p.omega) : w.out[e];
    if (!goes_on || d.removed(b)) b = d.redirect(key, b);
    if constexpr (C::kStores) out[base + e] = static_cast<int32_t>(b);
    if constexpr (C::kPerKey) cnt.add(b);
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
  CT_TRIPS(JUMP_CHAINS);
  // ct-loop: omega: each of the chunk's keys takes at most omega steps, four a trip
  while (__any_sync(FULL, live)) {
    CT_TRIP(JUMP_CHAINS);
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
    CT_STEPS(JUMP_CHAINS, fin ? static_cast<uint32_t>(omega - left) : 0u);
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
  CT_TRIPS(JUMP_STAGE);
  // ct-loop: chunk: the chunk's keys, 32 a trip
  for (int e = lane; e < count; e += 32) {
    CT_TRIP(JUMP_STAGE);
    w.key[e] = src(base + e);
  }
  __syncwarp();
  if (p.n <= 1 || p.omega <= 0) {
    CT_TRIPS(JUMP_ZERO);
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int e = lane; e < count; e += 32) {
      CT_TRIP(JUMP_ZERO);
      w.out[e] = 0u;
    }
  } else if (p.n <= (1u << 23)) {
    jump_chains<true>(w, count, p.n, p.omega);
  } else {
    jump_chains<false>(w, count, p.n, p.omega);
  }
  __syncwarp();
  if constexpr (D::kDiverts) {
    const unsigned below = lanemask_lt();
    int hits = 0;
    CT_TRIPS(JUMP_SCAN);
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int j = 0; j * 32 < count; ++j) {
      CT_TRIP(JUMP_SCAN);
      const int e = j * 32 + lane;
      const bool in = e < count;
      const uint32_t b = in ? w.out[e] : 0u;
      const bool hit = in && d.removed(b);
      if constexpr (C::kStores) {
        if (in && !hit) out[base + e] = static_cast<int32_t>(b);
      }
      if constexpr (C::kPerKey) {
        if (in && !hit) cnt.add(b);
      }
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) w.queue[hits + __popc(m & below)] = static_cast<uint8_t>(e);
      hits += __popc(m);
    }
    __syncwarp();
    CT_TRIPS(JUMP_DIVERT);
    // ct-loop: chunk: the chunk's removed buckets, 32 a trip
    for (int q = lane; q < hits; q += 32) {
      CT_TRIP(JUMP_DIVERT);
      const int e = w.queue[q];
      if constexpr (C::kKeeps || C::kPerKey) {
        const uint32_t b = d.redirect(w.key[e], w.out[e]);
        if constexpr (C::kStores) out[base + e] = static_cast<int32_t>(b);
        if constexpr (C::kKeeps) w.out[e] = b;
        if constexpr (C::kPerKey) cnt.add(b);
      } else {
        out[base + e] = static_cast<int32_t>(d.redirect(w.key[e], w.out[e]));
      }
    }
  } else {
    CT_TRIPS(JUMP_COPY);
    // ct-loop: chunk: the chunk's keys, 32 a trip
    for (int e = lane; e < count; e += 32) {
      CT_TRIP(JUMP_COPY);
      out[base + e] = static_cast<int32_t>(w.out[e]);
    }
  }
  __syncwarp();
}

// The count of a routed chunk (C::kKeeps or C::kReads): its sampled indices
// base + e (multiples of 2^shift, e < count: at shift 6 at most 4 of a
// chunk's 256) are known from base, so the warp's lanes add just those
// replicas, read from w.out (kKeeps; the closing __syncwarp() keeps w.out
// until every lane has read it) or from `out` through L2 (kReads; the
// chunk's own closing __syncwarp() orders its lanes' stores before these
// loads).
template <class C>
__device__ __forceinline__ void count_chunk(const WarpArea& w, const int32_t* out, const C& cnt,
                                            int64_t base, int count) {
  const uint32_t first = (0u - static_cast<uint32_t>(base)) & ((1u << cnt.shift) - 1u);
  const int sampled = first < static_cast<uint32_t>(count)
                          ? static_cast<int>(((count - 1 - first) >> cnt.shift) + 1)
                          : 0;
  CT_TRIPS(COUNT_CHUNK);
  // ct-loop: chunk: the chunk's sampled keys, 32 a trip
  for (int k = threadIdx.x & 31; k < sampled; k += 32) {
    CT_TRIP(COUNT_CHUNK);
    const uint32_t e = first + (static_cast<uint32_t>(k) << cnt.shift);
    if constexpr (C::kKeeps) {
      cnt.add(w.out[e]);
    } else {
      cnt.add(static_cast<uint32_t>(__ldcg(out + base + e)));
    }
  }
  if constexpr (C::kKeeps) __syncwarp();
}

// Every warp of the grid walks the chunks of 32 * items keys.
template <class Engine, class Source, class D, class C = NoCount>
__device__ __forceinline__ void chunks(WarpArea& w, const Source& src, const D& d,
                                       const Lookup& p, int32_t* __restrict__ out, int64_t n,
                                       int items, const C& cnt = C{}) {
  const int64_t seg = 32 * items;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * seg;
  CT_TRIPS(CHUNKS);
  // ct-loop: grid: the warp's chunks, one resident grid's stride apart
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * seg;
       base < n; base += stride) {
    CT_TRIP(CHUNKS);
    const int count = static_cast<int>(n - base < seg ? n - base : seg);
    if constexpr (std::is_same_v<Engine, Binomial>) {
      binomial_chunk(w, src, d, p, out, base, count, cnt);
    } else {
      jump_chunk(w, src, d, p, out, base, count, cnt);
    }
    if constexpr (C::kKeeps || C::kReads) count_chunk(w, out, cnt, base, count);
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
// replicas also counted after each chunk (SharedCount / GlobalCount say
// how).  With kShared (capacity <= SHARED_BINS) a block counts into its own
// histogram in shared memory and, once every warp has left the chunk loop (a
// warp with no chunk reaches the barrier at once), adds its nonzero bins to
// `counts` with one global atomic each; above SHARED_BINS the histogram would
// cost occupancy (the WarpAreas already take 18 KB a block), so every
// counted key is one global reduction, its replica read back from `out`
// (GlobalCount): the lookup loop carries no count, and a chunk costs its
// sampled positions alone (4 loads and reductions at shift 6); with every
// key counted (shift 0) each key's reduction goes out from the loop
// (DenseCount).  Unsigned adds wrap as the reference's u32 sums do.
constexpr int SHARED_BINS = 4096;  // 16 KB of u32 bins

template <class Engine, bool kShared>
__global__ void __launch_bounds__(THREADS)
route_load_kernel(KeySource src, Fleet fleet, const int32_t* __restrict__ state, int omega,
                  int32_t* __restrict__ out, int64_t n, int items, uint32_t* __restrict__ counts,
                  uint32_t cap, int shift) {
  __shared__ WarpArea area[WARPS];
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const Divert d{fleet, n_total, n_alive};
  if constexpr (kShared) {
    __shared__ uint32_t hist[SHARED_BINS];
    CT_TRIPS(HIST_ZERO);
    // ct-loop: capacity: the block's bins, THREADS a trip
    for (uint32_t b = threadIdx.x; b < cap; b += THREADS) {
      CT_TRIP(HIST_ZERO);
      hist[b] = 0u;
    }
    __syncthreads();
    chunks<Engine>(area[threadIdx.x >> 5], src, d, fold(n_total, omega), out, n, items,
                   SharedCount{static_cast<uint32_t>(__cvta_generic_to_shared(hist)), cap,
                               shift});
    __syncthreads();
    CT_TRIPS(HIST_FLUSH);
    // ct-loop: capacity: the block's bins, THREADS a trip
    for (uint32_t b = threadIdx.x; b < cap; b += THREADS) {
      CT_TRIP(HIST_FLUSH);
      const uint32_t v = hist[b];
      if (v) atomicAdd(counts + b, v);
    }
  } else if (shift == 0) {
    chunks<Engine>(area[threadIdx.x >> 5], src, d, fold(n_total, omega), out, n, items,
                   DenseCount{counts, cap});
  } else {
    chunks<Engine>(area[threadIdx.x >> 5], src, d, fold(n_total, omega), out, n, items,
                   GlobalCount{counts, cap, shift});
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

// The distinct-resolution pass of an R-way placement: column j keeps its
// routed shard unless an earlier settled column holds it; then a re-salt
// hash picks a position in the table's alive prefix and up to max_resalt
// linear probes take the first slots[q] no earlier column holds.  The
// reference tests "taken" with a per-lane bitmask of n_words u32 words set
// through select cascades (store.py:140-153); that mask only ever holds the
// columns settled before j, and every shard id is below 32 * n_words, so
// "bit b set" is exactly "b equals an earlier settled column", which is what
// taken() compares.  A probe that finds a free shard ends the chain: later
// probes of the reference change nothing then.  n_alive <= j leaves the
// defined duplicate and is no exhaustion.  With `old` (the placement before
// a membership change) the launch also writes moved[i, j] = out[i, j] not in
// old[i, :].  exhausted and moved are bool tensors (one byte each).
// resolve_kernel runs one thread per key with its routed columns in
// registers (r <= MAX_R); resolve_rows_kernel, below it, takes r > MAX_R.
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
// Unrolled by eight: the compiler's own sixteen left r <= 16 in a ladder of
// remainder branches; eight ran 4 % faster than four at r = 16 and 11-19 %
// at r = 33 and 64 on the H100 (PERF.md §6).
__device__ __forceinline__ bool taken_row(const int32_t* row, int j, uint32_t b) {
  bool hit = false;
  CT_TRIPS(TAKEN_ROW);
  // ct-loop: r: the row's settled columns
#pragma unroll 8
  for (int k = 0; k < j; ++k) {
    CT_TRIP(TAKEN_ROW);
    hit |= static_cast<uint32_t>(row[k]) == b;
  }
  return hit;
}

__global__ void __launch_bounds__(THREADS)
resolve_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ base,
               const int32_t* __restrict__ slots, const int32_t* __restrict__ state, int r,
               int max_resalt, const int32_t* __restrict__ old, int32_t* __restrict__ out,
               uint8_t* __restrict__ exhausted, uint8_t* __restrict__ moved, int64_t n) {
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  CT_TRIPS(RESOLVE_GRID);
  // ct-loop: grid: one key a thread, one launch grid's stride apart
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < n; i += stride) {
    CT_TRIP(RESOLVE_GRID);
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
        CT_TRIPS(REG_PROBE);
        // ct-loop: max_resalt: the column's probes
        for (int p = 0; coll && p < max_resalt; ++p) {
          CT_TRIP(REG_PROBE);
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

// The row path (r > MAX_R).  A key's r columns are a row-major row of r
// int32, so one thread per key reading its row from device memory (this
// path's first design) sent each warp load of column j to 32 rows 4r bytes
// apart, 32 sectors a request, and re-read its row's settled columns from
// its own stores for every column and probe: ~r^2/2 uncoalesced loads a key,
// 3.7x the function's own bytes at r = 16, for 0.11 of its bound (PERF.md
// §6).  Here a warp takes up to 32 consecutive keys, whose rows are one
// contiguous span of keys * r int32 in `base` (and in `old`): it stages the
// span in its shared memory with coalesced 4-byte cp.async copies, at an
// odd row stride (r | 1 words, so a lane-per-key access is free of bank
// conflicts); each lane resolves its own key there in place, column by
// column, as the register path does; and the warp writes the rows back to
// `out` as one coalesced span, each word's moved byte computed against the
// staged `old` row as it goes (lanes on one row read the same word, lanes on
// rows 1-3 apart other banks).  One round a warp and a grid of every round:
// a resident grid whose warps walked their rounds with two buffers, the
// next round's copies in flight over the current one's work, ran 1.37x
// slower at r = 16, and cheaper index walks (pointer steps for the copies)
// 1.16x slower (PERF.md §6).  The launch sizes the shared memory from r
// (keys * (r | 1) * 4 bytes a warp, twice that with `old`), in blocks of
// ROW_WARPS warps (eight ran 1.35x slower at r = 64 with `old`: 133 KB
// blocks, one an SM), and gives a warp fewer keys, and a block fewer warps,
// where 32 rows do not fit.  A row
// longer than a block's shared memory holds (r | 1 > 29,056 with `old`,
// 58,112 without, on the H100) is staged in its own row of `out` instead
// (stride 0 at launch): the same code over device memory.
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One warp's round: keys first .. first + cnt - 1 (cnt <= 32), their rows at
// `rows`, `stride` words apart.  kStaged: rows is the warp's shared memory,
// the old rows `area` words past it, both filled here; otherwise rows is the
// round's span of `out` (stride r) and the old rows are read from `old`.
template <bool kStaged>
__device__ __forceinline__ void resolve_round(
    const uint32_t* __restrict__ keys, const int32_t* __restrict__ base,
    const int32_t* __restrict__ slots, uint32_t n_alive, int r, int max_resalt,
    const int32_t* __restrict__ old, int32_t* __restrict__ out, uint8_t* __restrict__ exhausted,
    uint8_t* __restrict__ moved, int64_t first, int cnt, int32_t* rows, int stride, int area) {
  const int lane = threadIdx.x & 31;
  const int64_t span = first * r;
  const int words = cnt * r;
  const int32_t* olds = kStaged ? rows + area : (old != nullptr ? old + span : nullptr);
  // word t of the span is column t % r of row t / r; a lane's words are 32
  // apart, so its (row, column) steps by (32 / r, 32 % r) with one carry
  const int drow = 32 / r;
  const int dcol = 32 - drow * r;
  const int row0 = lane / r;
  const int col0 = lane - row0 * r;
  const uint32_t key = lane < cnt ? keys[first + lane] : 0u;
  {
    int row = row0, col = col0;
    CT_TRIPS(ROW_STAGE);
    // ct-loop: r: the round's cnt * r words (cnt <= 32), 32 a trip
    for (int t = lane; t < words; t += 32) {
      CT_TRIP(ROW_STAGE);
      if constexpr (kStaged) {
        cp_async4(rows + row * stride + col, base + span + t);
        if (old != nullptr) cp_async4(rows + area + row * stride + col, old + span + t);
      } else {
        rows[t] = base[span + t];
      }
      row += drow;
      col += dcol;
      if (col >= r) {
        col -= r;
        ++row;
      }
    }
  }
  if constexpr (kStaged) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  if (lane < cnt) {
    int32_t* row = rows + lane * stride;
    bool ex = false;
    CT_TRIPS(ROW_COLUMNS);
    // ct-loop: r: the key's columns
    for (int j = 1; j < r; ++j) {
      CT_TRIP(ROW_COLUMNS);
      if (taken_row(row, j, static_cast<uint32_t>(row[j]))) {
        bool coll = true;
        uint32_t q = __umulhi(mix32(mix32(key ^ family_salt(j)) ^ RESALT_SALT), n_alive);
        CT_TRIPS(ROW_PROBE);
        // ct-loop: max_resalt: the column's probes
        for (int p = 0; coll && p < max_resalt; ++p) {
          CT_TRIP(ROW_PROBE);
          const uint32_t cand = static_cast<uint32_t>(slots[q]);
          if (!taken_row(row, j, cand)) {
            row[j] = static_cast<int32_t>(cand);
            coll = false;
          }
          q += 1u;
          if (q >= n_alive) q -= n_alive;
        }
        ex |= coll && static_cast<uint32_t>(j) < n_alive;
      }
    }
    exhausted[first + lane] = ex;
  }
  __syncwarp();
  if (kStaged || old != nullptr) {
    int row = row0, col = col0;
    CT_TRIPS(ROW_WRITE);
    // ct-loop: r: the round's cnt * r words (cnt <= 32), 32 a trip
    for (int t = lane; t < words; t += 32) {
      CT_TRIP(ROW_WRITE);
      const int32_t b = rows[row * stride + col];
      if constexpr (kStaged) out[span + t] = b;
      if (old != nullptr) {
        const int32_t* prev = olds + row * stride;
        bool kept = false;
        CT_TRIPS(ROW_OLD);
        // ct-loop: r: the key's old columns
        for (int k = 0; k < r; ++k) {
          CT_TRIP(ROW_OLD);
          kept |= prev[k] == b;
        }
        moved[span + t] = !kept;
      }
      row += drow;
      col += dcol;
      if (col >= r) {
        col -= r;
        ++row;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
resolve_rows_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ base,
                    const int32_t* __restrict__ slots, const int32_t* __restrict__ state, int r,
                    int max_resalt, const int32_t* __restrict__ old, int32_t* __restrict__ out,
                    uint8_t* __restrict__ exhausted, uint8_t* __restrict__ moved, int64_t n,
                    int per_warp, int stride) {
  extern __shared__ int32_t row_area[];
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const int warp = threadIdx.x >> 5;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * per_warp;
  if (first >= n) return;  // the whole warp: first is the warp's
  const int cnt = static_cast<int>(n - first < per_warp ? n - first : per_warp);
  if (stride > 0) {
    const int area = per_warp * stride;
    int32_t* rows = row_area + static_cast<int64_t>(warp) * area * (old != nullptr ? 2 : 1);
    resolve_round<true>(keys, base, slots, n_alive, r, max_resalt, old, out, exhausted, moved,
                        first, cnt, rows, stride, area);
  } else {
    resolve_round<false>(keys, base, slots, n_alive, r, max_resalt, old, out, exhausted, moved,
                         first, cnt, out + first * r, r, 0);
  }
}

// The fused placement (r <= MAX_R): the family route and the
// distinct-resolution pass in one launch, bit for bit what
// route_kernel<Engine, FamilyKeySource> followed by resolve_kernel gives.
// It replaces src/repro/placement/store.py:87's family route (the fused
// route, the K1/K2 pallas_call at fused.py:202) and store.py:131-178's jnp
// resolve, which the reference runs one after the other over an (N, r)
// array.  As two launches the routed (N, r) columns went to device memory
// and came back with the keys: 8r + 4 B an object beyond the 4 + 4r + 1 B
// the call must move (17 B at r = 3), and at r = 3 on 200 of 256 OSDs the
// second launch was 35 % of the call's device time (PERF.md §6).  Here the
// columns stay on chip.  A warp takes a chunk of the whole objects whose
// family keys fit in SEG (SEG / r of them, 85 at r = 3), so that no
// object's columns straddle two warps, and routes the chunk's family keys
// (entry e: column e % r of object e / r, as the family route lays them
// out) with the route kernel's own chunk code (binomial_chunk, jump_chunk),
// told by Stage to keep every settled column in the warp's w.out and store
// none; then a lane takes an object, resolves its row there in registers
// with resolve_kernel's taken test, re-salt and probes, and writes it back
// in place (moved bytes beside it in w.key, free by then), and the warp
// copies the chunk's rows, which w.out holds in the output's own layout, to
// `out` coalesced.  A first design gave each lane one object with its r
// columns as its items: 3 items a lane at r = 3 against the family route's
// 8, and 61 registers; it ran 0.594 ms against the two launches' 0.692 at
// 2^24 objects on 200 of 256 (binomial; jump no faster), this one 0.508
// (PERF.md §6).  What bounds it on the H100 is the family route's:
// instruction issue and its latency, not bytes (17 B an object, 0.085 ms at
// 2^24).  r > MAX_R keeps the two launches: the row path's rows take up to a
// block's whole opt-in shared memory, which the route's WarpAreas (18 KB a
// block) would cost occupancy to share.

// The family keys of a fused placement's chunk: entry e (< SEG) is column
// e % r of the chunk's object e / r, mix32(keys[e / r] ^ family_salt(e % r));
// e / r is (e * inv) >> 16 with inv = 2^16 / r rounded up, exact for every
// e < 2^8 and r <= 8 (a multiply, no division).
struct ChunkFamilySource {
  // loads as it goes, as FamilyKeySource: preloaded, 2^24 objects at r = 3
  // on 200 of 256 took 0.538 ms against 0.520 (binomial; PERF.md §6)
  static constexpr bool kPreload = false;
  const uint32_t* keys;  // the chunk's first object's key
  uint32_t r, inv;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    const uint32_t e = static_cast<uint32_t>(i);
    const uint32_t t = (e * inv) >> 16;
    return mix32(keys[t] ^ family_salt(e - t * r));
  }
};

template <class Engine>
__global__ void __launch_bounds__(THREADS)
place_kernel(const uint32_t* __restrict__ keys, Fleet fleet, const int32_t* __restrict__ state,
             int omega, int r, int max_resalt, const int32_t* __restrict__ old,
             int32_t* __restrict__ out, uint8_t* __restrict__ exhausted,
             uint8_t* __restrict__ moved, int64_t n) {
  __shared__ WarpArea area[WARPS];
  WarpArea& w = area[threadIdx.x >> 5];
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const Divert d{fleet, n_total, n_alive};
  const Lookup p = fold(n_total, omega);
  const int lane = threadIdx.x & 31;
  const int objs = SEG / r;  // a chunk's objects: at most SEG family keys
  const uint32_t inv = (65536u + r - 1u) / static_cast<uint32_t>(r);
  uint8_t* const moves = reinterpret_cast<uint8_t*>(w.key);  // the chunk's moved bytes
  const int64_t step = static_cast<int64_t>(gridDim.x) * WARPS * objs;
  CT_TRIPS(PLACE_GRID);
  // ct-loop: grid: the warp's chunks of SEG / r objects, one resident grid's stride apart
  for (int64_t first = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * objs;
       first < n; first += step) {
    CT_TRIP(PLACE_GRID);
    const int cnt = static_cast<int>(n - first < objs ? n - first : objs);
    const ChunkFamilySource src{keys + first, static_cast<uint32_t>(r), inv};
    if constexpr (std::is_same_v<Engine, Binomial>) {
      binomial_chunk(w, src, d, p, nullptr, 0, cnt * r, Stage{});
    } else {
      jump_chunk(w, src, d, p, nullptr, 0, cnt * r, Stage{});
    }
    CT_TRIPS(PLACE_OBJECTS);
    // ct-loop: chunk: the chunk's objects (at most SEG / r), a lane each, 32 a trip
    for (int t = lane; t < cnt; t += 32) {
      CT_TRIP(PLACE_OBJECTS);
      uint32_t* row = w.out + t * r;
      uint32_t col[MAX_R];
      // ct-loop: static: MAX_R columns, unrolled
#pragma unroll
      for (int j = 0; j < MAX_R; ++j) col[j] = j < r ? row[j] : 0u;
      bool ex = false;
      // ct-loop: static: MAX_R columns, unrolled
#pragma unroll
      for (int j = 1; j < MAX_R; ++j) {
        if (j >= r) break;
        uint32_t b = col[j];
        bool coll = taken(col, j, b);
        if (coll) {
          uint32_t q = __umulhi(mix32(mix32(keys[first + t] ^ family_salt(j)) ^ RESALT_SALT),
                                n_alive);
          CT_TRIPS(PLACE_PROBE);
          // ct-loop: max_resalt: the column's probes
          for (int k = 0; coll && k < max_resalt; ++k) {
            CT_TRIP(PLACE_PROBE);
            const uint32_t cand = static_cast<uint32_t>(fleet.slots[q]);
            if (!taken(col, j, cand)) {
              b = cand;
              coll = false;
            }
            q += 1u;
            if (q >= n_alive) q -= n_alive;  // conditional wrap, no division
          }
          row[j] = b;
        }
        ex |= coll && static_cast<uint32_t>(j) < n_alive;
        col[j] = b;
      }
      exhausted[first + t] = ex;
      if (old != nullptr) {
        uint32_t prev[MAX_R];
        // ct-loop: static: MAX_R old columns, unrolled
#pragma unroll
        for (int k = 0; k < MAX_R; ++k) {
          prev[k] = k < r ? static_cast<uint32_t>(old[(first + t) * r + k]) : 0u;
        }
        // ct-loop: static: MAX_R columns, unrolled
#pragma unroll
        for (int j = 0; j < MAX_R; ++j) {
          if (j >= r) break;
          bool kept = false;
          // ct-loop: static: MAX_R old columns, unrolled
#pragma unroll
          for (int k = 0; k < MAX_R; ++k) kept |= k < r && prev[k] == col[j];
          moves[t * r + j] = !kept;
        }
      }
    }
    __syncwarp();
    CT_TRIPS(PLACE_WRITE);
    // ct-loop: chunk: the chunk's cnt x r columns (at most SEG), 32 a trip
    for (int e = lane; e < cnt * r; e += 32) {
      CT_TRIP(PLACE_WRITE);
      out[first * r + e] = static_cast<int32_t>(w.out[e]);
      if (old != nullptr) moved[first * r + e] = moves[e];
    }
    __syncwarp();  // the rows are read before the next chunk's route writes w
  }
}

// The node level of a rack-aware placement (node_route_kernel): each object
// (a block group) is first placed on r distinct alive racks by the store's
// R-way placement over the rack fleet (the family route and the
// distinct-resolution pass, above), then column j's DataNode is the route,
// lookup and divert, of the node key mix32(key ^ node_salt(j)) over the
// fleet of the rack column j was given, and its global id is rack x nodes +
// local.  The racks' fleets are stacked: rack g's removed words at g x
// n_words, its table at g x n_slots, its [n_total, n_alive] at 2 g.  No TPU
// kernel has a counterpart: the JAX package knows no failure domains; it is
// the node level of repro_torch.core.placement_torch.route_nodes_impl.
//
// A warp takes a chunk of the whole objects whose node keys fit in SEG (SEG
// / r of them, 28 at r = 9), as place_kernel does, and runs the lookup of
// its keys with the route's own chunk code (binomial_chunk, jump_chunk),
// told by Defer to divert nothing and by Stage to keep every bucket in
// w.out and store none: every rack's slot space is the layout's `nodes`
// (DataNodes fail and recover, the layout never scales), so one fold serves
// the chunk.  Then the warp walks the chunk's items in the output's own
// layout, 32 a trip: each lane reads its item's rack (coalesced, the rack
// columns' row-major layout), diverts a bucket its rack has removed through
// that rack's table (its node key recomputed: at a tenth of the DataNodes
// down, one item in ten), and writes the global id coalesced; with `old`
// (the placement before a membership change) it also writes moved[i, j] =
// out[i, j] not in old[i, :].  What bounds it on the H100: 76 B an object at
// r = 9 (the key, the rack columns read, the ids written), 0.38 ms at 2^24
// objects; the lookup's issue rate at 9 keys an object comes close (the
// family route of r = 3 objects ran 0.36 ms for 3 keys an object, PERF.md §6).
constexpr uint32_t NODE_SALT = 0x2545F491u;

// The salt of the node key of column j, distinct from every family salt
// (the rack level's) and from the re-salt.
__device__ __forceinline__ uint32_t node_salt(uint32_t j) { return family_salt(j) ^ NODE_SALT; }

// The node keys of a chunk: entry e (< SEG) is column e % r of the chunk's
// object e / r, mix32(keys[e / r] ^ node_salt(e % r)); e / r is (e * inv)
// >> 16 with inv = 2^16 / r rounded up, exact for every e < 2^8 and r <= 256.
struct ChunkNodeSource {
  static constexpr bool kPreload = false;
  const uint32_t* keys;  // the chunk's first object's key
  uint32_t r, inv;
  __device__ __forceinline__ uint32_t operator()(int64_t i) const {
    const uint32_t e = static_cast<uint32_t>(i);
    const uint32_t t = (e * inv) >> 16;
    return mix32(keys[t] ^ node_salt(e - t * r));
  }
};

// The node level's policy in the chunk code: the lookup alone, the divert of
// each bucket deferred to the pass over its rack's fleet after the chunk.
// kDiverts so that jump_chunk takes its divert branch, which with Stage
// stores nothing (its other branch stores every bucket to `out`).
struct Defer {
  static constexpr bool kDiverts = true;
  __device__ __forceinline__ bool removed(uint32_t) const { return false; }
  __device__ __forceinline__ uint32_t redirect(uint32_t, uint32_t b) const { return b; }
};

template <class Engine>
__global__ void __launch_bounds__(THREADS)
node_route_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ racks, int r,
                  const uint32_t* __restrict__ mask, int n_words,
                  const int32_t* __restrict__ slots, int n_slots,
                  const int32_t* __restrict__ state, uint32_t nodes, int omega,
                  const int32_t* __restrict__ old, int32_t* __restrict__ out,
                  uint8_t* __restrict__ moved, int64_t n) {
  __shared__ WarpArea area[WARPS];
  WarpArea& w = area[threadIdx.x >> 5];
  const Lookup p = fold(nodes, omega);
  const int lane = threadIdx.x & 31;
  const int objs = SEG / r;  // a chunk's objects: at most SEG node keys
  const uint32_t inv = (65536u + r - 1u) / static_cast<uint32_t>(r);
  const int64_t step = static_cast<int64_t>(gridDim.x) * WARPS * objs;
  CT_TRIPS(NODE_GRID);
  // ct-loop: grid: the warp's chunks of SEG / r objects, one resident grid's stride apart
  for (int64_t first = (static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * objs;
       first < n; first += step) {
    CT_TRIP(NODE_GRID);
    const int cnt = static_cast<int>(n - first < objs ? n - first : objs);
    const ChunkNodeSource src{keys + first, static_cast<uint32_t>(r), inv};
    if constexpr (std::is_same_v<Engine, Binomial>) {
      binomial_chunk(w, src, Defer{}, p, nullptr, 0, cnt * r, Stage{});
    } else {
      jump_chunk(w, src, Defer{}, p, nullptr, 0, cnt * r, Stage{});
    }
    const int64_t span = first * r;
    CT_TRIPS(NODE_ITEMS);
    // ct-loop: chunk: the chunk's cnt x r node keys (at most SEG), 32 a trip
    for (int e = lane; e < cnt * r; e += 32) {
      CT_TRIP(NODE_ITEMS);
      const uint32_t rack = static_cast<uint32_t>(racks[span + e]);
      const uint32_t t = (static_cast<uint32_t>(e) * inv) >> 16;
      const Fleet f{mask + rack * n_words, n_words, slots + rack * n_slots, n_slots};
      uint32_t b = w.out[e];
      if (f.removed(b)) {
        const uint32_t key = mix32(keys[first + t] ^ node_salt(e - t * r));
        b = f.redirect(key, b, static_cast<uint32_t>(state[2 * rack]),
                       static_cast<uint32_t>(state[2 * rack + 1]));
      }
      const int32_t id = static_cast<int32_t>(rack * nodes + b);
      out[span + e] = id;
      if (old != nullptr) {
        const int32_t* prev = old + (first + t) * r;
        bool kept = false;
        CT_TRIPS(NODE_OLD);
        // ct-loop: r: the object's old columns
        for (int k = 0; k < r; ++k) {
          CT_TRIP(NODE_OLD);
          kept |= prev[k] == id;
        }
        moved[span + e] = !kept;
      }
    }
    __syncwarp();  // w.out is read before the next chunk's lookup writes it
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
  CT_TRIPS(CHAIN_WALK);
  // ct-loop: max_chain: each queued key walks at most max_chain steps (the chain baseline's bound)
  while (true) {
    CT_TRIP(CHAIN_WALK);
    CT_TRIPS(CHAIN_SCAN);
    // top up: scan chunks while fewer than CHAIN_LOW keys wait
    // ct-loop: grid: the warp's chunks, scanned while fewer than CHAIN_LOW keys wait
    for (int64_t base = first + scan * stride; queued < CHAIN_LOW && base < n;
         base += stride, ++scan) {
      CT_TRIP(CHAIN_SCAN);
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
        CT_STEPS(CHAIN_WALK, static_cast<uint32_t>(max_chain - left + (alive ? 1 : 0)));
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
int64_t resident_blocks(Kernel kernel, int (&resident)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < 64 ? dev : 0;
  if (!resident[slot]) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[slot] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  return resident[slot];
}

template <class Kernel>
Shape shape_for(Kernel kernel, int64_t n, int (&resident)[64]) {
  const int64_t blocks = resident_blocks(kernel, resident);
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

// The row path's launch for r columns (with or without `old`) over n keys:
// keys a warp takes (up to 32), warps a block, the staged rows' stride
// (r | 1, or 0 for rows staged in `out`), the block's shared memory, and the
// grid: one round a warp.  The kernel is granted the card's opt-in shared
// memory once per device.
struct RowsShape {
  int per_warp, warps, stride, grid;
  int64_t smem;
};

constexpr int ROW_WARPS = 4;  // warps a block of the row path, at most

int rows_shape(int r, bool with_old, int64_t n, RowsShape* shape) {
  static int optin[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slot = dev >= 0 && dev < 64 ? dev : 0;
  if (!optin[slot]) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(resolve_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    optin[slot] = limit;
  }
  const int64_t row_bytes = int64_t{4} * (r | 1) * (with_old ? 2 : 1);
  const int64_t fit = optin[slot] / row_bytes;  // rows a block's shared memory holds
  if (fit < 1) {  // rows staged in `out`; a round's words stay an int
    *shape = {r <= (1 << 25) ? 32 : 1, ROW_WARPS, 0, 0, 0};
  } else {
    const int per_warp = static_cast<int>(fit < 32 ? fit : 32);
    const int64_t warps = fit / per_warp;
    *shape = {per_warp, static_cast<int>(warps < ROW_WARPS ? warps : ROW_WARPS), r | 1, 0, 0};
    shape->smem = shape->warps * per_warp * row_bytes;
  }
  const int64_t rounds = (n + shape->per_warp - 1) / shape->per_warp;
  const int64_t blocks = (rounds + shape->warps - 1) / shape->warps;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  shape->grid = static_cast<int>(blocks);
  return 0;
}

// The fused placement's launch: chunks of SEG / r objects a warp over the
// resident grid, at most one block per WARPS chunks; logged with items =
// MAX_ITEMS (a chunk's family keys are at most 32 x items; the SASS gate's
// place_grid_trips counts its chunks).  1 <= r <= MAX_R.
template <class Engine>
int launch_place(const void* keys, int r, const Fleet& fleet, const void* state, int omega,
                 int max_resalt, const void* old, void* out, void* exhausted, void* moved,
                 int64_t n, cudaStream_t stream) {
  static int resident[64] = {};
  const int64_t blocks = resident_blocks(place_kernel<Engine>, resident);
  const int64_t per_block = int64_t{WARPS} * (SEG / r);  // objects
  const int64_t tiles = (n + per_block - 1) / per_block;
  const Shape shape{static_cast<int>(tiles < blocks ? tiles : blocks), MAX_ITEMS};
  log_launch(shape);
  place_kernel<Engine><<<shape.grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(keys), fleet, static_cast<const int32_t*>(state), omega, r,
      max_resalt, static_cast<const int32_t*>(old), static_cast<int32_t*>(out),
      static_cast<uint8_t*>(exhausted), static_cast<uint8_t*>(moved), n);
  return static_cast<int>(cudaGetLastError());
}

// The node level's launch: chunks of SEG / r objects a warp over the
// resident grid, at most one block per WARPS chunks, logged as
// launch_place's is.  1 <= r <= SEG.
template <class Engine>
int launch_node_route(const void* keys, const void* racks, int r, const Fleet& fleets,
                      const void* state, unsigned nodes, int omega, const void* old, void* out,
                      void* moved, int64_t n, cudaStream_t stream) {
  static int resident[64] = {};
  const int64_t blocks = resident_blocks(node_route_kernel<Engine>, resident);
  const int64_t per_block = int64_t{WARPS} * (SEG / r);  // objects
  const int64_t tiles = (n + per_block - 1) / per_block;
  const Shape shape{static_cast<int>(tiles < blocks ? tiles : blocks), MAX_ITEMS};
  log_launch(shape);
  node_route_kernel<Engine><<<shape.grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(racks), r, fleets.mask,
      fleets.n_words, fleets.slots, fleets.n_slots, static_cast<const int32_t*>(state), nodes,
      omega, static_cast<const int32_t*>(old), static_cast<int32_t*>(out),
      static_cast<uint8_t*>(moved), n);
  return static_cast<int>(cudaGetLastError());
}

int launch_resolve(const void* keys, const void* base, const void* slots, const void* state,
                   int r, int max_resalt, const void* old, void* out, void* exhausted,
                   void* moved, int64_t n, cudaStream_t stream) {
  if (r < 1) return -1;
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* t = static_cast<const int32_t*>(slots);
  const auto* st = static_cast<const int32_t*>(state);
  const auto* o = static_cast<const int32_t*>(old);
  auto* dst = static_cast<int32_t*>(out);
  auto* ex = static_cast<uint8_t*>(exhausted);
  auto* mv = static_cast<uint8_t*>(moved);
  if (r <= MAX_R) {  // the register path
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    const int grid = static_cast<int>(blocks < (1 << 30) ? blocks : (1 << 30));
    log_launch({grid, 1});
    resolve_kernel<<<grid, THREADS, 0, stream>>>(k, b, t, st, r, max_resalt, o, dst, ex, mv, n);
    return static_cast<int>(cudaGetLastError());
  }
  RowsShape shape{};
  const int err = rows_shape(r, old != nullptr, n, &shape);
  if (err) return err;
  log_launch({shape.grid, shape.per_warp});
  resolve_rows_kernel<<<shape.grid, shape.warps * 32, shape.smem, stream>>>(
      k, b, t, st, r, max_resalt, o, dst, ex, mv, n, shape.per_warp, shape.stride);
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

// An R-way placement in one launch: keys (n,) -> out (n, r) row-major, the
// family route and the distinct-resolution pass, exhausted (n,) bytes and,
// with old (n, r), moved (n, r) bytes (old and moved may both be null);
// 1 <= r <= 8 and max_resalt >= 0 (-1 otherwise, or for an unknown engine).
extern "C" int routing_place(int engine, const void* keys, int r, const void* mask, int n_words,
                             const void* slots, int n_slots, const void* state, int omega,
                             int max_resalt, const void* old, void* out, void* exhausted,
                             void* moved, long long n, void* stream) {
  using namespace routing;
  if (r < 1 || r > MAX_R || max_resalt < 0) return -1;
  const Fleet fleet{static_cast<const uint32_t*>(mask), n_words,
                    static_cast<const int32_t*>(slots), n_slots};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_place<Binomial>(keys, r, fleet, state, omega, max_resalt, old, out,
                                          exhausted, moved, n, s);
    case 1: return launch_place<Jump>(keys, r, fleet, state, omega, max_resalt, old, out,
                                      exhausted, moved, n, s);
    default: return -1;
  }
}

// The node level of a rack-aware placement: keys (n,) and their (n, r)
// row-major rack columns -> out (n, r), the global DataNode ids (rack x
// nodes + the route of the column's node key over its rack's fleet), and
// with old (n, r) moved (n, r) bytes (old and moved may both be null).  The
// racks' fleets are stacked: n_words removed words, n_slots table entries
// and [n_total, n_alive] a rack; every rack's slot space is `nodes`.
// 1 <= r <= 256 and nodes >= 1 (-1 otherwise, or for an unknown engine).
extern "C" int routing_node_route(int engine, const void* keys, const void* racks, int r,
                                  const void* mask, int n_words, const void* slots, int n_slots,
                                  const void* state, unsigned int nodes, int omega,
                                  const void* old, void* out, void* moved, long long n,
                                  void* stream) {
  using namespace routing;
  if (r < 1 || r > SEG || nodes < 1) return -1;
  const Fleet fleets{static_cast<const uint32_t*>(mask), n_words,
                     static_cast<const int32_t*>(slots), n_slots};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: return launch_node_route<Binomial>(keys, racks, r, fleets, state, nodes, omega, old,
                                               out, moved, n, s);
    case 1: return launch_node_route<Jump>(keys, racks, r, fleets, state, nodes, omega, old, out,
                                           moved, n, s);
    default: return -1;
  }
}

// The row path's launch for r > 8 columns (with or without the old rows)
// over n keys on the current device: writes keys a warp takes, warps a
// block, the staged rows' stride (0: staged in the output) and the grid to
// out (4 ints); returns 0, -1 for r <= 8, or a cudaError_t.
extern "C" int routing_resolve_rows_shape(int r, int with_old, long long n, void* out) {
  using namespace routing;
  if (r <= MAX_R) return -1;
  RowsShape shape{};
  const int err = rows_shape(r, with_old != 0, n, &shape);
  if (err) return err;
  int* dst = static_cast<int*>(out);
  dst[0] = shape.per_warp;
  dst[1] = shape.warps;
  dst[2] = shape.stride;
  dst[3] = shape.grid;
  return 0;
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

#ifdef ROUTING_COUNT_TRIPS
// The counting build's entry points (routing.cuh's counted loops): zero
// ct_trips and ct_steps on the stream, and copy them (ct_trips, then
// ct_steps: TRIP_LOOPS u32 each) into out, a device buffer of 2 *
// TRIP_LOOPS u32, on the stream.  Each returns TRIP_LOOPS, or -1 after a
// CUDA error.
extern "C" int routing_trips_reset(void* stream) {
  using namespace routing;
  const auto s = static_cast<cudaStream_t>(stream);
  void* trips = nullptr;
  void* steps = nullptr;
  if (cudaGetSymbolAddress(&trips, ct_trips) || cudaGetSymbolAddress(&steps, ct_steps) ||
      cudaMemsetAsync(trips, 0, sizeof(ct_trips), s) ||
      cudaMemsetAsync(steps, 0, sizeof(ct_steps), s)) {
    return -1;
  }
  return TRIP_LOOPS;
}

extern "C" int routing_trips_read(void* out, void* stream) {
  using namespace routing;
  const auto s = static_cast<cudaStream_t>(stream);
  void* trips = nullptr;
  void* steps = nullptr;
  auto* dst = static_cast<uint32_t*>(out);
  if (cudaGetSymbolAddress(&trips, ct_trips) || cudaGetSymbolAddress(&steps, ct_steps) ||
      cudaMemcpyAsync(dst, trips, sizeof(ct_trips), cudaMemcpyDeviceToDevice, s) ||
      cudaMemcpyAsync(dst + TRIP_LOOPS, steps, sizeof(ct_steps), cudaMemcpyDeviceToDevice, s)) {
    return -1;
  }
  return TRIP_LOOPS;
}
#endif
