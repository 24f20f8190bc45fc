// The routing datapath's four CUDA kernels for sm_90a, each instantiated for
// both lookup engines (binomial, jump):
//
//   route_kernel<Engine, KeySource>  replaces src/repro/kernels/fused.py
//       _kernel_route (pallas_call at fused.py:202): lookup, removed-bit
//       test, replacement-table divert -> i32 replica ids;
//   route_kernel<Engine, IdSource>   replaces _kernel_ingest (fused.py:255):
//       splitmix64 of the u64 id halves, then the same body;
//   lookup_dyn_kernel<Engine>        replaces _kernel_lookup_dyn
//       (fused.py:295): the bare lookup with n read from the device;
//   lookup_vec_kernel<Engine>        replaces src/repro/kernels/binomial_hash.py
//       _kernel (pallas_call at binomial_hash.py:91, binomial_bulk_lookup_2d):
//       the bare lookup with n static.  The TPU kernel bakes n, E = 2^ceil(log2 n)
//       and M = E/2 into its trace; here the host folds them and passes them
//       by value, so they sit in the constant bank: no device read of n and
//       no per-thread next-pow2 cascade.  The jump instance is the card's
//       form of jump_lookup_vec, so a jump-routed MoE runs a kernel too.
//
// Layout: flat 1-D operands, one thread per key in a grid-stride loop, the
// tail masked by the loop bound.  The fleet state [n_total, n_alive] and n
// are read from device memory, so a launch needs no host copy of them
// (lookup_vec excepted: its n is a launch argument, as it is static on the
// TPU).
//
// Bound: instructions, not bytes.  route, lookup_dyn and lookup_vec move
// 8 B/key and ingest 12 B/key (keys or id halves in, ids out).  In the sm_90a SASS
// (CUDA 12.9) a binomial loop iteration is 44 instructions and a jump step
// 31-32 (the IEEE division is an MUFU.RCP + FFMA refinement with a rarely
// taken slow path); with the per-key prologue, loads, fold and divert a key
// costs ~110-160 instructions on binomial (about one loop trip per key) and
// ~270-320 on jump at n = 1000 (~7.5 steps).  Over the H100 SXM data-sheet
// peaks (700 W) that instruction time exceeds the byte time for all eight
// instances; the bound is derived, not measured.  chip_smoke.py holds the
// SASS table behind these counts, checks it against each build, and works
// out the bound from each run's trip counts; PERF.md section 5 has the
// card's times beside it.
//
// The design spends nothing on memory: the mask word and the slot are read
// by direct index (the TPU's select cascades are gone), and each thread
// leaves its loop at the first accepting iteration instead of running all
// omega iterations with a masked blend.
//
// Every entry point returns cudaGetLastError() after its launch (0 = ok).
#include <cuda_runtime.h>

#include "routing.cuh"

namespace routing {

constexpr int THREADS = 256;

template <class Engine, class Source>
__global__ void route_kernel(Source src, const uint32_t* __restrict__ mask, int n_words,
                             const int32_t* __restrict__ slots, int n_slots,
                             const int32_t* __restrict__ state, int omega,
                             int32_t* __restrict__ out, int64_t n) {
  const uint32_t n_total = static_cast<uint32_t>(state[0]);
  const uint32_t n_alive = static_cast<uint32_t>(state[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t key = src(i);
    const uint32_t b = Engine::lookup(key, n_total, omega);
    out[i] = static_cast<int32_t>(
        divert(key, b, mask, n_words, slots, n_slots, n_total, n_alive));
  }
}

template <class Engine>
__global__ void lookup_dyn_kernel(const uint32_t* __restrict__ keys,
                                  const int32_t* __restrict__ n_ptr, int omega,
                                  int32_t* __restrict__ out, int64_t n) {
  const uint32_t n_buckets = static_cast<uint32_t>(n_ptr[0]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = static_cast<int32_t>(Engine::lookup(keys[i], n_buckets, omega));
  }
}

template <class Engine>
__global__ void lookup_vec_kernel(const uint32_t* __restrict__ keys, uint32_t n_buckets,
                                  uint32_t E, uint32_t M, int omega,
                                  int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = static_cast<int32_t>(Engine::lookup_folded(keys[i], n_buckets, E, M, omega));
  }
}

inline int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < (int64_t{1} << 30) ? b : (int64_t{1} << 30));
}

template <class Engine, class Source>
int launch_route(Source src, const void* mask, int n_words, const void* slots, int n_slots,
                 const void* state, int omega, void* out, int64_t n, cudaStream_t stream) {
  route_kernel<Engine, Source><<<blocks_for(n), THREADS, 0, stream>>>(
      src, static_cast<const uint32_t*>(mask), n_words, static_cast<const int32_t*>(slots),
      n_slots, static_cast<const int32_t*>(state), omega, static_cast<int32_t*>(out), n);
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
  const auto k = static_cast<const uint32_t*>(keys);
  const auto nb = static_cast<const int32_t*>(n_buckets);
  const auto o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: lookup_dyn_kernel<Binomial><<<blocks_for(n), THREADS, 0, s>>>(k, nb, omega, o, n); break;
    case 1: lookup_dyn_kernel<Jump><<<blocks_for(n), THREADS, 0, s>>>(k, nb, omega, o, n); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// n_buckets >= 2; E and M as binomial_hash.py:64-66 computes them (jump
// ignores them).  The wrapper answers n <= 1 with zeros and no launch.
extern "C" int routing_lookup_vec(int engine, const void* keys, unsigned int n_buckets,
                                  unsigned int E, unsigned int M, int omega, void* out,
                                  long long n, void* stream) {
  using namespace routing;
  const auto k = static_cast<const uint32_t*>(keys);
  const auto o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0: lookup_vec_kernel<Binomial><<<blocks_for(n), THREADS, 0, s>>>(k, n_buckets, E, M, omega, o, n); break;
    case 1: lookup_vec_kernel<Jump><<<blocks_for(n), THREADS, 0, s>>>(k, n_buckets, E, M, omega, o, n); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
