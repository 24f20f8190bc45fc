// The training path's CUDA kernels for sm_90a.  Neither replaces a Pallas
// kernel: the JAX package computes both functions in jnp (its AdamW,
// src/repro/training/optimizer.py:63-93) or with jax.lax.top_k (its top-k
// compression, src/repro/training/compression.py:39-45).  They were written
// because the port's training steps spent the most card time there, as
// plain torch:
//
//   adamw_kernel<G, P, kMaster>   one AdamW step over one leaf (or one
//       ZeRO-1 block), with the global-norm clip's scale folded in: reads the
//       gradient (G: bf16 or float32), m, v and the float32 reference (the
//       master weight, or with kMaster false the parameter itself), writes
//       m, v, the master and the parameter (P: bf16 or float32), in one pass.
//       The plain version (repro_torch/kernels/train.py) walks the leaf in
//       slices with about sixteen elementwise torch passes and their float32
//       temporaries, and the clip before it rewrote every gradient once more.
//       Bound: bytes (28 B an element with a bf16 gradient and parameter and
//       master weights: 3.73 G elements of a full-width Qwen3-235B-A22B
//       layer move 104.4 GB, 31.2 ms at 3.35 TB/s).  Design: each thread
//       takes 8 elements at a time with 16-byte loads and stores (one per
//       8 bf16 values, two per 8 float32), a grid-stride loop over a grid of
//       resident blocks with 64-bit indices, and a scalar head and tail
//       where a view does not start on a 16-byte boundary.
//   radix_hist_kernel<kPrefixed>  one round of the exact radix select behind
//       the top-k threshold (kth_magnitude): the histogram of one digit of
//       |x|'s bit pattern over the elements whose higher digits match the
//       prefix found so far (read from the device).  Bound: bytes, the leaf
//       read once a round.  Design: each block counts into 2^width u32 bins
//       of shared memory with one shared atomic an element, and adds its
//       non-zero bins into a u64 histogram in device memory when it is done.
//       A gradient's magnitudes crowd into a few dozen bins of the first
//       digit (the exponent and two mantissa bits), so a warp's atomics
//       often share an address; the card resolves that in the atomic unit
//       faster than a warp can group its lanes first: with
//       __match_any_sync and one add a group, round 1 took 3.69 ms on
//       0.805 G gradient-like values, against 1.05 ms with the plain
//       atomics and 0.96 ms of bound (NVIDIA H100 80GB HBM3 at 700 W,
//       chip_smoke.py --baseline with the grouped build).
//   radix_pick_kernel             the round's choice: one block takes the
//       suffix sums of the (mesh-summed) histogram and keeps the highest
//       digit whose count from the top reaches the rank still sought,
//       updating the sought rank and the prefix in device memory, so the
//       select never waits for the host.
//
// Every floating-point operation of adamw_kernel is an IEEE round-to-nearest
// intrinsic taken in the plain version's order, so no multiply-add is
// contracted and the results equal the plain torch update bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace train {

constexpr int THREADS = 256;
constexpr int HIST_THREADS = 512;
constexpr int PICK_THREADS = 1024;
constexpr int MAX_BINS = 2048;  // the widest digit: 11 bits
constexpr uint32_t NONE = 0xffffffffu;  // not a digit: the element is not counted

// ---------------------------------------------------------------------------
// AdamW
// ---------------------------------------------------------------------------

struct Hyper {
  float lr, c1, c2, lr_wd, scale;
  bool scaled;
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and read back as float32 (the clip's scaled gradient)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One element's step, each operation rounded once, in the plain version's
// order: m*b1 + g*(1-b1); v*b2 + (g*g)*(1-b2); ((m/c1)*lr) / (sqrt(v/c2) + eps);
// r - u - r*lr_wd.  With the clip's scale the gradient is first
// to_dtype(g * scale), as the clip wrote it into the gradient before.
template <class G>
__device__ __forceinline__ void adamw_step(float g, float& m, float& v, float& r, const Hyper& h) {
  if (h.scaled) g = round_to(__fmul_rn(g, h.scale), static_cast<const G*>(nullptr));
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float u = __fdiv_rn(__fmul_rn(__fdiv_rn(m, h.c1), h.lr),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  const float decay = __fmul_rn(r, h.lr_wd);
  r = __fsub_rn(__fsub_rn(r, u), decay);
}

// The scalars live on the device (the schedule's lr and the bias
// corrections are 0-dim tensors of the step; the clip's scale follows the
// global norm), so the launch waits for nothing on the host.
template <class G, class P, bool kMaster>
__global__ void __launch_bounds__(THREADS) adamw_kernel(
    const G* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
    float* __restrict__ master, P* __restrict__ p, const float* __restrict__ lr,
    const float* __restrict__ c1, const float* __restrict__ c2, const float* __restrict__ lr_wd,
    const float* __restrict__ scale, float b1, float omb1, float b2, float omb2, float eps,
    int64_t n, int64_t head, int64_t groups) {
  const Hyper h{*lr, *c1, *c2, *lr_wd, scale ? *scale : 1.0f, scale != nullptr,
                b1, omb1, b2, omb2, eps};
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t q = tid; q < groups; q += stride) {
    const int64_t i = head + q * 8;
    float gg[8], mm[8], vv[8], rr[8];
    load8(g + i, gg);
    load8(m + i, mm);
    load8(v + i, vv);
    if (kMaster) load8(master + i, rr); else load8(p + i, rr);
#pragma unroll
    for (int j = 0; j < 8; ++j) adamw_step<G>(gg[j], mm[j], vv[j], rr[j], h);
    store8(m + i, mm);
    store8(v + i, vv);
    if (kMaster) store8(master + i, rr);
    store8(p + i, rr);
  }
  // the elements outside the aligned groups: the head before them and the
  // tail after them, one a thread
  const int64_t tail = head + groups * 8;
  for (int64_t e = tid; e < head + (n - tail); e += stride) {
    const int64_t i = e < head ? e : tail + (e - head);
    float mm = m[i], vv = v[i], rr = kMaster ? master[i] : to_float(p[i]);
    adamw_step<G>(to_float(g[i]), mm, vv, rr, h);
    m[i] = mm;
    v[i] = vv;
    if (kMaster) master[i] = rr;
    store(p + i, rr);
  }
}

// The first index from which every operand's address is 16-byte aligned
// (0-7), or -1 where no index aligns them all (views at odd offsets of
// their storage): then every element takes the scalar path.
int aligned_head(const void* const* ptrs, const int* sizes, int operands, int64_t n) {
  for (int h = 0; h < 8 && h <= n; ++h) {
    bool ok = true;
    for (int k = 0; k < operands; ++k) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(ptrs[k]) +
                           static_cast<uintptr_t>(h) * static_cast<uintptr_t>(sizes[k]);
      ok = ok && at % 16 == 0;
    }
    if (ok) return h;
  }
  return -1;
}

template <class Kernel>
int resident_blocks(Kernel kernel, int threads, int (&resident)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < 64 ? dev : 0;
  if (!resident[slot]) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[slot] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  return resident[slot];
}

template <class G, class P, bool kMaster>
int launch_adamw(const void* g, float* m, float* v, float* master, void* p, const float* lr,
                 const float* c1, const float* c2, const float* lr_wd, const float* scale,
                 float b1, float omb1, float b2, float omb2, float eps, int64_t n,
                 cudaStream_t stream) {
  static int resident[64] = {};
  auto* kernel = adamw_kernel<G, P, kMaster>;
  const void* ptrs[5] = {g, m, v, p, master};
  const int sizes[5] = {static_cast<int>(sizeof(G)), 4, 4, static_cast<int>(sizeof(P)), 4};
  const int h = aligned_head(ptrs, sizes, kMaster ? 5 : 4, n);
  const int64_t head = h < 0 ? n : h;
  const int64_t groups = (n - head) / 8;
  const int64_t work = groups > 0 ? groups : n;
  const int64_t need = (work + THREADS - 1) / THREADS;
  const int64_t blocks = resident_blocks(kernel, THREADS, resident);
  const int grid = static_cast<int>(need < blocks ? (need > 0 ? need : 1) : blocks);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const G*>(g), m, v, master, static_cast<P*>(p), lr, c1, c2, lr_wd, scale,
      b1, omb1, b2, omb2, eps, n, head, groups);
  return static_cast<int>(cudaGetLastError());
}

template <class G, class P>
int launch_adamw_master(bool with_master, const void* g, float* m, float* v, float* master,
                        void* p, const float* lr, const float* c1, const float* c2,
                        const float* lr_wd, const float* scale, float b1, float omb1, float b2,
                        float omb2, float eps, int64_t n, cudaStream_t stream) {
  if (with_master) {
    return launch_adamw<G, P, true>(g, m, v, master, p, lr, c1, c2, lr_wd, scale, b1, omb1, b2,
                                    omb2, eps, n, stream);
  }
  return launch_adamw<G, P, false>(g, m, v, nullptr, p, lr, c1, c2, lr_wd, scale, b1, omb1, b2,
                                   omb2, eps, n, stream);
}

// ---------------------------------------------------------------------------
// the radix select
// ---------------------------------------------------------------------------

// The digit of |x| at [shift, shift + width) where the bits above it match
// the prefix's (always in the first round, kPrefixed false), else NONE.
// |x| is fabsf's, the instruction torch's abs runs on the card (what it
// makes of a NaN's payload included); a NaN orders above inf.
template <bool kPrefixed>
__device__ __forceinline__ uint32_t digit_of(float x, int shift, uint32_t mask, int top,
                                             uint32_t above) {
  const uint32_t bits = __float_as_uint(fabsf(x));
  if (kPrefixed && (bits >> top) != above) return NONE;
  return (bits >> shift) & mask;
}

__device__ __forceinline__ void count(uint32_t* bins, uint32_t d) {
  if (d != NONE) atomicAdd(bins + d, 1u);
}

// One round's histogram: x holds n float32 values, the first `head` of them
// before a 16-byte boundary and `vecs` float4 after them.  A block counts at
// most n / gridDim elements, far below 2^32 for any leaf the card holds.
template <bool kPrefixed>
__global__ void __launch_bounds__(HIST_THREADS) radix_hist_kernel(
    const float* __restrict__ x, int64_t n, int64_t head, int64_t vecs, int shift, int width,
    const int32_t* __restrict__ prefix, unsigned long long* __restrict__ hist) {
  __shared__ uint32_t bins[MAX_BINS];
  const int nbins = 1 << width;
  for (int b = threadIdx.x; b < nbins; b += HIST_THREADS) bins[b] = 0;
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(nbins - 1);
  const int top = shift + width;
  const uint32_t above = kPrefixed ? static_cast<uint32_t>(*prefix) >> top : 0u;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * HIST_THREADS + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (HIST_THREADS / 32);
  // two float4 a lane a trip, both loads issued before the counting
  for (int64_t base = warp * 64; base < vecs; base += warps * 64) {
    const int64_t q0 = base + lane, q1 = base + 32 + lane;
    const float4 a = q0 < vecs ? xv[q0] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = q1 < vecs ? xv[q1] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float vals[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j < 4 ? q0 : q1) < vecs) {
        count(bins, digit_of<kPrefixed>(vals[j], shift, mask, top, above));
      }
    }
  }
  // the head and the tail past the last float4 (fewer than 8 elements):
  // the first threads of the first block
  const int64_t tail = head + vecs * 4;
  if (blockIdx.x == 0 && threadIdx.x < head + (n - tail)) {
    const int64_t i = threadIdx.x < head ? threadIdx.x : tail + (threadIdx.x - head);
    count(bins, digit_of<kPrefixed>(x[i], shift, mask, top, above));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += HIST_THREADS) {
    if (bins[b]) atomicAdd(hist + b, static_cast<unsigned long long>(bins[b]));
  }
}

// The round's digit: the highest d whose count from the top (the elements
// at or above d) reaches the rank still sought; the elements strictly above
// d leave the rank, d joins the prefix.  One block: each thread sums its
// run of bins, a suffix scan over the threads, then the thread whose run
// holds d writes the two words.  A sought rank above the histogram's total
// (k beyond the leaf) finds no digit and writes nothing.
__global__ void __launch_bounds__(PICK_THREADS) radix_pick_kernel(
    const unsigned long long* __restrict__ hist, int shift, int width,
    long long* __restrict__ sought, int32_t* __restrict__ prefix) {
  __shared__ unsigned long long scan[PICK_THREADS];
  const int nbins = 1 << width;
  const int per = (nbins + PICK_THREADS - 1) / PICK_THREADS;
  const int lo = threadIdx.x * per;
  const unsigned long long want = static_cast<unsigned long long>(*sought);
  unsigned long long own = 0;
  for (int j = 0; j < per; ++j) own += lo + j < nbins ? hist[lo + j] : 0ull;
  scan[threadIdx.x] = own;
  __syncthreads();
  for (int off = 1; off < PICK_THREADS; off <<= 1) {
    const unsigned long long add =
        threadIdx.x + off < PICK_THREADS ? scan[threadIdx.x + off] : 0ull;
    __syncthreads();
    scan[threadIdx.x] += add;
    __syncthreads();
  }
  // the elements above this thread's run, then down its run
  unsigned long long above = scan[threadIdx.x] - own;
  for (int j = per - 1; j >= 0; --j) {
    const int d = lo + j;
    if (d >= nbins) continue;
    const unsigned long long from_top = above + hist[d];
    if (from_top >= want && above < want) {
      *sought = static_cast<long long>(want - above);
      *prefix = static_cast<int32_t>(static_cast<uint32_t>(*prefix) |
                                     (static_cast<uint32_t>(d) << shift));
    }
    above = from_top;
  }
}

int launch_radix_hist(const float* x, int64_t n, int shift, int width, const int32_t* prefix,
                      unsigned long long* hist, cudaStream_t stream) {
  if (width < 1 || width > 11 || shift < 0 || shift + width > 32) return -1;
  static int resident[2][64] = {};
  const bool prefixed = shift + width < 32;
  auto* kernel = prefixed ? radix_hist_kernel<true> : radix_hist_kernel<false>;
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(x) % 16) / 4);
  int64_t head = mis ? 4 - mis : 0;
  head = head < n ? head : n;
  const int64_t vecs = (n - head) / 4;
  const int64_t need = (vecs + HIST_THREADS * 2 - 1) / (HIST_THREADS * 2);
  const int64_t blocks = resident_blocks(kernel, HIST_THREADS, resident[prefixed]);
  const int grid = static_cast<int>(need < blocks ? (need > 0 ? need : 1) : blocks);
  kernel<<<grid, HIST_THREADS, 0, stream>>>(x, n, head, vecs, shift, width, prefix, hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace train

// All pointers are device pointers; each entry returns a cudaError_t, or -1
// for an argument the kernel does not take.

// g_bf16 / p_bf16: the gradient's / parameter's dtype is bf16 (else
// float32).  master may be null (no master weights: the parameter is the
// reference), and so may scale (no clip scale).  lr, c1, c2, lr_wd and
// scale point at float32 scalars.
extern "C" int train_adamw_update(int g_bf16, int p_bf16, const void* g, void* m, void* v,
                                  void* master, void* p, const void* lr, const void* c1,
                                  const void* c2, const void* lr_wd, const void* scale, float b1,
                                  float omb1, float b2, float omb2, float eps, long long n,
                                  void* stream) {
  using namespace train;
  using bf16 = __nv_bfloat16;
  if (n < 1) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fm = static_cast<float*>(m);
  auto* fv = static_cast<float*>(v);
  auto* fr = static_cast<float*>(master);
  const auto* flr = static_cast<const float*>(lr);
  const auto* fc1 = static_cast<const float*>(c1);
  const auto* fc2 = static_cast<const float*>(c2);
  const auto* fwd = static_cast<const float*>(lr_wd);
  const auto* fsc = static_cast<const float*>(scale);
  const bool with_master = master != nullptr;
  switch ((g_bf16 ? 2 : 0) + (p_bf16 ? 1 : 0)) {
    case 0: return launch_adamw_master<float, float>(with_master, g, fm, fv, fr, p, flr, fc1, fc2,
                                                     fwd, fsc, b1, omb1, b2, omb2, eps, n, s);
    case 1: return launch_adamw_master<float, bf16>(with_master, g, fm, fv, fr, p, flr, fc1, fc2,
                                                    fwd, fsc, b1, omb1, b2, omb2, eps, n, s);
    case 2: return launch_adamw_master<bf16, float>(with_master, g, fm, fv, fr, p, flr, fc1, fc2,
                                                    fwd, fsc, b1, omb1, b2, omb2, eps, n, s);
    default: return launch_adamw_master<bf16, bf16>(with_master, g, fm, fv, fr, p, flr, fc1, fc2,
                                                    fwd, fsc, b1, omb1, b2, omb2, eps, n, s);
  }
}

// x: n float32 values; prefix: one int32; hist: 2^width int64 counts the
// launch adds into (zeroed by the caller).
extern "C" int train_radix_hist(const void* x, long long n, int shift, int width,
                                const void* prefix, void* hist, void* stream) {
  if (n < 1) return -1;
  return train::launch_radix_hist(static_cast<const float*>(x), n, shift, width,
                                  static_cast<const int32_t*>(prefix),
                                  static_cast<unsigned long long*>(hist),
                                  static_cast<cudaStream_t>(stream));
}

// hist: 2^width int64 counts; sought: one int64; prefix: one int32, both
// updated in place.
extern "C" int train_radix_pick(const void* hist, int shift, int width, void* sought,
                                void* prefix, void* stream) {
  if (width < 1 || width > 11 || shift < 0 || shift + width > 32) return -1;
  train::radix_pick_kernel<<<1, train::PICK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(hist), shift, width, static_cast<long long*>(sought),
      static_cast<int32_t*>(prefix));
  return static_cast<int>(cudaGetLastError());
}
