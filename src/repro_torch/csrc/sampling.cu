// On-device sampling: greedy argmax and temperature / top-k gumbel-max.
// Replace the Pallas kernels repro/kernels/sampling.py greedy_sample and
// gumbel_sample.
//
// Both are a per-row argmax of a score over the vocab:
//   greedy  score = logit
//   gumbel  score = g + logit / T           (IEEE division)
//           or, with top-k, -inf where logit < kth (the row's kth largest
//           logit, duplicates counted, as lax.top_k gives it)
// logits, g (B, V) float32 -> out (B,) int32.  The tie rule is
// jnp.argmax's, applied in every partial reduction: the larger value
// wins, equal values go to the LOWER column, and NaN counts as larger
// than any number (the first NaN wins).  A row of -inf gives column 0.
//
// One kernel, gumbel_cluster_kernel<MODE>, one launch a call for both:
// one thread-block cluster a row (cluster sizes 1-16, from
// kernels/sampling.py greedy_plan / gumbel_plan), CTA r of the cluster
// taking the contiguous slice [r * slice, (r + 1) * slice) of the row;
// 512-thread CTAs.  Greedy (kArgmax) and gumbel without top-k (kGumbel)
// stream the CTA's slice once (logits alone, or logits and noise) with
// 16-byte evict-first loads where the row allows, 4-byte ones where it
// does not, into the CTA's argmax.  With top-k (kTopK) each CTA copies
// its logits slice into shared memory (TMA bulk copies where the row
// allows, else 4-byte cp.async), and kth comes from a radix select over
// ordered(x), the uint32 image of x that sorts as the floats do, in four
// 8-bit digits from the top, every pass over shared memory
// (cluster_kth).  A row whose slices no cluster's shared memory holds
// (kTopKWide: wider than 16 x 51,200 columns) runs the same select and
// argmax over its slices in device memory instead (a few MB a row, read
// twice, the second time mostly from the 50 MB L2).  Each pass counts
// the digit of the CTA's elements whose higher digits equal the prefix
// chosen so far into 256 bins (the first pass counts the top 11 bits
// into 2048 local bins, so that the shared atomics of the few
// sign-and-exponent bins most logits share rarely collide, and folds
// them to 256), adds its nonzero bins into rank 0's sums through
// distributed shared memory, and after a cluster barrier every CTA reads
// rank 0's sums and chooses the same digit.  The second pass also lists
// the CTA's candidates, the columns at or above the first digit chosen
// (a few hundred for a top-k of 50), so that the last two passes and the
// argmax read the list and not the slice (a list past 2048 columns falls
// back to the slice).  The argmax reads the noise of the kept columns
// alone: a masked column scores -inf and cannot win (a row whose scores
// are all -inf gives column 0, as jnp.argmax does).  Each CTA writes its
// partial argmax into rank 0's shared memory; after a last cluster
// barrier rank 0 merges the partials and writes the token.  No global
// scratch, no memset, no second kernel: five cluster barriers with top-k
// (four merges and the last), one without (and the start's, waited for
// before the first remote access).  Bound: bytes (each logit read once,
// and the noise of the columns that can win).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

#include "mma.cuh"   // rt::cp_async16, cp_async_commit / wait, smem_u32

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;   // kernels/sampling.py CLUSTER_SIZES

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && bn ? ia < ib : an;
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& best, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, idx, o);
    if (better(ob, oi, best, idx)) {
      best = ob;
      idx = oi;
    }
  }
}

__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

constexpr int kGThreads = 512;   // the gumbel cluster kernel's CTA
constexpr int kGWarps = kGThreads / 32;
constexpr int kChunk = 2048;      // bytes of one TMA bulk copy
constexpr int kBins = 256;        // one 8-bit digit of the radix select
constexpr int kFine = 2048;       // the first pass's local bins (11 bits)
constexpr int kCap = 2048;        // a CTA's candidate list (columns)
static_assert(kGThreads >= kBins, "gumbel select: a bin a thread");

// 4 bytes global -> shared (a row that is not 16-byte aligned)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Waits for phase 0 of the mbarrier at shared address `bar`.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// The two halves of a cluster barrier: arrive releases this thread's
// writes (shared memory included), wait acquires everyone's.  All threads
// of every CTA take part (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Copies n floats of global src into shared dst, called by every thread;
// returns when they have landed.  With vec (n, src 16-byte multiples)
// warp 0 issues TMA bulk copies of kChunk bytes, completing on the
// mbarrier `bar`; else every thread copies 4-byte elements with cp.async.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      bool vec, uint64_t* bar) {
  const uint32_t b = rt::smem_u32(bar);
  if (!vec) {
    for (int i = threadIdx.x; i < n; i += kGThreads)
      cp_async4(rt::smem_u32(dst + i), src + i);
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    return;
  }
  if (threadIdx.x == 0)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 "fence.mbarrier_init.release.cluster;\n" ::"r"(b)
                 : "memory");
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned bytes = 4u * n;
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes)
                   : "memory");
    __syncwarp();
    for (unsigned off = kChunk * threadIdx.x; off < bytes;
         off += kChunk * 32) {
      const unsigned len = min(bytes - off, (unsigned)kChunk);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(rt::smem_u32(dst) + off),
          "l"(reinterpret_cast<const char*>(src) + off), "r"(len), "r"(b)
          : "memory");
    }
  }
  mbar_wait(b);
}

// f(column in the slice, value) for this thread's share of n floats of
// shared or device memory: with vec (s 16-byte aligned) 16-byte reads,
// then the ragged tail; else 4-byte reads.
template <class F>
__device__ __forceinline__ void each(const float* s, int n, bool vec,
                                     F&& f) {
  int i0 = 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const int n4 = n >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < n4; i += kGThreads) {
      const float4 v = s4[i];
      f(4 * i, v.x);
      f(4 * i + 1, v.y);
      f(4 * i + 2, v.z);
      f(4 * i + 3, v.w);
    }
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kGThreads) f(i, s[i]);
}

// The select's shared state: this CTA's histograms, rank 0's sums of the
// cluster's (one buffer a pass), the candidate list, scan words.
struct Select {
  unsigned fine[kFine];
  unsigned hist[kBins];
  unsigned sum[4][kBins];
  int list[kCap];
  unsigned warp[kBins / 32];
  unsigned count, prefix, krem;
};

// Adds this CTA's counts (v for bin t < 256, thread t) into rank 0's sums
// of pass p, then the cluster barrier after which every CTA's are in; then
// every thread learns the digit (at `shift`) holding the krem-th largest
// of the elements that match `prefix` above it (sel.prefix, sel.krem).
// Thread t < 256 owns digit 255 - t (the sums read in that order), so an
// inclusive scan over t counts the elements at or above each digit.
__device__ __forceinline__ void merge_choose(unsigned* sum0, Select& sel,
                                             int p, unsigned v,
                                             unsigned prefix, int shift,
                                             unsigned krem) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < kBins && v) atomicAdd(sum0 + p * kBins + t, v);
  cluster_sync();
  if (t < kBins) {
    const int digit = kBins - 1 - t;
    const unsigned cnt = sum0[p * kBins + digit];
    unsigned incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned m = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += m;
    }
    if (lane == 31) sel.warp[warp] = incl;
    asm volatile("bar.sync 1, %0;\n" ::"n"(kBins) : "memory");
    for (int w = 0; w < warp; ++w) incl += sel.warp[w];
    const unsigned above = incl - cnt;
    if (above < krem && incl >= krem) {
      sel.prefix = prefix | ((unsigned)digit << shift);
      sel.krem = krem - above;
    }
  }
  __syncthreads();
}

// This CTA's count of bin t < 256 of sel.hist, which it zeroes for the
// next pass.
__device__ __forceinline__ unsigned take(Select& sel) {
  __syncthreads();
  unsigned v = 0;
  if (threadIdx.x < kBins) {
    v = sel.hist[threadIdx.x];
    sel.hist[threadIdx.x] = 0;
  }
  return v;
}

// The kth largest logit of the cluster's row, duplicates counted, from its
// slices (lg, n floats: in each CTA's shared memory, or in device memory
// for kTopKWide; vec as for each()): four 8-bit radix passes, each merged
// in rank 0's sums.  The first counts the top 11 bits locally (2048 bins:
// most logits share a few sign-and-exponent bins of the top 8, whose
// shared atomics would collide) and folds them to 8.  The second also
// lists this CTA's candidates, the columns at or above the first digit
// chosen (and NaN, which no mask drops): the last two passes, and the
// argmax, read the list alone unless it overflowed kCap (sel.count >
// kCap; then they read the slice).  Called by every thread; the cluster
// barrier armed at the kernel's start is waited for here.
__device__ __forceinline__ float cluster_kth(cg::cluster_group& cluster,
                                             const float* lg, int n, bool vec,
                                             int k, Select& sel) {
  const int lane = threadIdx.x & 31;
  unsigned* sum0 = cluster.map_shared_rank(&sel.sum[0][0], 0);
  each(lg, n, vec,
       [&](int, float x) { atomicAdd(&sel.fine[ordered(x) >> 21], 1u); });
  __syncthreads();
  unsigned v = 0;
  if (threadIdx.x < kBins)
    for (int j = 0; j < kFine / kBins; ++j)
      v += sel.fine[threadIdx.x * (kFine / kBins) + j];
  cluster_wait();                      // rank 0 runs, its sums are zero
  merge_choose(sum0, sel, 0, v, 0u, 24, (unsigned)k);
  unsigned prefix = sel.prefix, krem = sel.krem;
  // pass 1: bits 23-16 of the elements in the chosen bin; every element
  // at or above it joins the list (warp-aggregated appends)
  const unsigned d0 = prefix >> 24;
  each(lg, n, vec, [&](int i, float x) {
    const unsigned u = ordered(x), top = u >> 24;
    if (top == d0) atomicAdd(&sel.hist[(u >> 16) & (kBins - 1)], 1u);
    const bool cand = top >= d0 || isnan(x);
    const unsigned active = __activemask();
    const unsigned want = __ballot_sync(active, cand);
    if (!want) return;
    const int leader = __ffs(want) - 1;
    unsigned base = 0;
    if (lane == leader) base = atomicAdd(&sel.count, __popc(want));
    base = __shfl_sync(active, base, leader);
    const unsigned pos = base + __popc(want & ((1u << lane) - 1));
    if (cand && pos < kCap) sel.list[pos] = i;
  });
  merge_choose(sum0, sel, 1, take(sel), prefix, 16, krem);
  const bool list = sel.count <= kCap;
  // passes 2-3: the next 8 bits of the elements matching the prefix
  for (int p = 2; p < 4; ++p) {
    prefix = sel.prefix;
    krem = sel.krem;
    const int shift = 24 - 8 * p;
    const unsigned mask = ~0u << (shift + 8);
    auto count = [&](float x) {
      const unsigned u = ordered(x);
      if ((u & mask) == prefix)
        atomicAdd(&sel.hist[(u >> shift) & (kBins - 1)], 1u);
    };
    if (list) {
      for (int j = threadIdx.x; j < (int)sel.count; j += kGThreads)
        count(lg[sel.list[j]]);
    } else {
      each(lg, n, vec, [&](int, float x) { count(x); });
    }
    merge_choose(sum0, sel, p, take(sel), prefix, shift, krem);
  }
  return from_ordered(sel.prefix);
}

// What a launch of gumbel_cluster_kernel computes (kernels/sampling.py
// passes the code): the argmax of the logits (greedy), of g + lg / T, of
// that over the top-k columns with each CTA's logits slice staged in
// shared memory, or the same over slices read from device memory.
enum Mode : int { kArgmax = 0, kGumbel = 1, kTopK = 2, kTopKWide = 3 };

// grid (cluster, B), clusters of (cluster, 1, 1): row b's slices of
// `slice` columns (a multiple of 4).  kArgmax and kGumbel stream the
// slice once from device memory (the logits, and for kGumbel the noise)
// and allocate no select state.  kTopK holds the CTA's logits slice in
// dynamic shared memory; kTopKWide reads it from device memory.  Both
// read the noise of the kept columns alone.  vec: the row is 16-byte
// aligned (V % 4 == 0 and aligned bases).
template <int MODE>
__global__ void __launch_bounds__(kGThreads)
gumbel_cluster_kernel(const float* __restrict__ logits,
                      const float* __restrict__ gumbel,
                      int* __restrict__ out, int V, int slice, int top_k,
                      float t, bool vec) {
  __shared__ float s_val[kMaxCluster];           // rank 0's: the partials
  __shared__ int s_idx[kMaxCluster];
  __shared__ float s_wval[kGWarps];
  __shared__ int s_widx[kGWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = rank * slice;
  const int n = max(0, min(slice, V - lo));
  const float* lg = logits + (long long)b * V + lo;
  const float* g = gumbel + (long long)b * V + lo;
  float best = -INFINITY;
  int idx = INT_MAX;
  auto consider = [&](int i, float sc) {
    if (better(sc, lo + i, best, idx)) {
      best = sc;
      idx = lo + i;
    }
  };
  if constexpr (MODE == kTopK || MODE == kTopKWide) {
    __shared__ Select sel;
    for (int i = threadIdx.x; i < 4 * kBins; i += kGThreads)
      (&sel.sum[0][0])[i] = 0;
    for (int i = threadIdx.x; i < kFine; i += kGThreads) sel.fine[i] = 0;
    if (threadIdx.x < kBins) sel.hist[threadIdx.x] = 0;
    if (threadIdx.x == 0) sel.count = 0;
    cluster_arrive();            // this CTA runs, its sums are zero
    // kth over the slice at src, then the argmax of the kept columns (lg
    // >= kth; NaN too) with their noise: a masked column scores -inf and
    // never wins (a row whose scores are all -inf gives column 0 below)
    auto kth_argmax = [&](const float* src, bool src_vec) {
      const float thr = cluster_kth(cluster, src, n, src_vec, top_k, sel);
      auto keep = [&](int i, float x) {
        if (!(x < thr))
          consider(i, __fadd_rn(__ldg(g + i), __fdiv_rn(x, t)));
      };
      if (sel.count <= kCap) {           // the candidate list held
        for (int j = threadIdx.x; j < (int)sel.count; j += kGThreads)
          keep(sel.list[j], src[sel.list[j]]);
      } else {
        each(src, n, src_vec, keep);
      }
    };
    if constexpr (MODE == kTopK) {
      extern __shared__ __align__(16) float s_lg[];
      __shared__ __align__(8) uint64_t s_bar;    // the logits have landed
      stage(s_lg, lg, n, vec, &s_bar);
      kth_argmax(s_lg, true);
    } else {
      kth_argmax(lg, vec);
    }
  } else {
    // one streaming pass: the score of a logit x whose noise is y
    auto score = [&](float x, float y) {
      if constexpr (MODE == kArgmax) return x;
      else return __fadd_rn(y, __fdiv_rn(x, t));
    };
    cluster_arrive();            // this CTA runs
    if (vec) {
      const float4* l4 = reinterpret_cast<const float4*>(lg);
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
      for (int i = threadIdx.x; i < n >> 2; i += kGThreads) {
        const float4 x = __ldcs(l4 + i);
        float4 y = x;
        if constexpr (MODE == kGumbel) y = __ldcs(g4 + i);
        consider(4 * i, score(x.x, y.x));
        consider(4 * i + 1, score(x.y, y.y));
        consider(4 * i + 2, score(x.z, y.z));
        consider(4 * i + 3, score(x.w, y.w));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kGThreads) {
        const float x = __ldcs(lg + i);
        consider(i, score(x, MODE == kGumbel ? __ldcs(g + i) : x));
      }
    }
    cluster_wait();              // rank 0 runs
  }
  warp_best(best, idx);
  if (lane == 0) {
    s_wval[warp] = best;
    s_widx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kGWarps ? s_wval[lane] : -INFINITY;
    idx = lane < kGWarps ? s_widx[lane] : INT_MAX;
    warp_best(best, idx);
    if (lane == 0) {
      *cluster.map_shared_rank(&s_val[rank], 0) = best;
      *cluster.map_shared_rank(&s_idx[rank], 0) = idx;
    }
  }
  cluster_sync();                   // every partial is in rank 0
  if (rank != 0 || warp != 0) return;
  const int c = (int)cluster.num_blocks();
  best = lane < c ? s_val[lane] : -INFINITY;
  idx = lane < c ? s_idx[lane] : INT_MAX;
  warp_best(best, idx);
  // every score -inf (no NaN): jnp.argmax's first column
  if (lane == 0) out[b] = best == -INFINITY ? 0 : idx;
}

// Columns of a CTA's slice (kernels/sampling.py gumbel_slice): the row
// over `cluster` CTAs, rounded up to a multiple of 4.
int gumbel_slice(int V, int cluster) {
  return ((V + cluster - 1) / cluster + 3) / 4 * 4;
}

// Lets the MODE kernel take `smem` bytes of dynamic shared memory and,
// for more than 8 CTAs, a non-portable cluster size, on the current
// device.  Each attribute is set once a device (a later launch asking no
// more sets nothing, so a launch under CUDA graph capture makes no such
// call).
template <int MODE>
cudaError_t allow(int smem, int cluster) {
  constexpr int kDevices = 64;
  static int smem_set[kDevices] = {};
  static bool wide_set[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(gumbel_cluster_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  if (cluster > 8 && !wide_set[dev]) {
    err = cudaFuncSetAttribute(gumbel_cluster_kernel<MODE>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    wide_set[dev] = true;
  }
  return cudaSuccess;
}

// One launch of the MODE kernel over B rows of V columns in clusters of
// `cluster` CTAs (kTopK: the logits slice's dynamic shared memory).
template <int MODE>
int launch(const float* lg, const float* g, int* out, int B, int V,
           int cluster, int top_k, float t, cudaStream_t stream) {
  const int slice = gumbel_slice(V, cluster);
  const int smem = MODE == kTopK ? slice * (int)sizeof(float) : 0;
  cudaError_t err = allow<MODE>(smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kGThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const bool vec = V % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(lg) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  err = cudaLaunchKernelEx(&cfg, gumbel_cluster_kernel<MODE>, lg, g, out, V,
                           slice, top_k, t, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_rows(int B, int V, int cluster) {
  return B <= 0 || V <= 0 || B > 65535 || cluster < 1 ||
         cluster > kMaxCluster;
}

}  // namespace

// Kernel 3: the argmax of each row, one cluster launch a call (grid
// (cluster, B), clusters of (cluster, 1, 1); the wrapper's plan picks
// the cluster size).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int rt_greedy_sample(const void* logits, void* out, int B, int V,
                                int cluster, void* stream) {
  if (bad_rows(B, V, cluster)) return cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  return launch<kArgmax>(lg, lg, static_cast<int*>(out), B, V, cluster, 0,
                         1.0f, static_cast<cudaStream_t>(stream));
}

// Kernel 4: one cluster launch a call, in clusters of `cluster` CTAs (1
// to 16); with top-k, `staged` holds each CTA's logits slice in shared
// memory (the wrapper's plan picks both, the slice within the shared
// memory a block may hold), else the select reads it from device memory.
extern "C" int rt_gumbel_sample(const void* logits, const void* gumbel,
                                void* out, int B, int V, int cluster,
                                int top_k, int staged, float temperature,
                                void* stream) {
  if (bad_rows(B, V, cluster) || top_k < 0 || top_k > V ||
      !(temperature > 0.0f))
    return cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  const float* g = static_cast<const float*>(gumbel);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!top_k)
    return launch<kGumbel>(lg, g, o, B, V, cluster, 0, temperature, s);
  if (staged)
    return launch<kTopK>(lg, g, o, B, V, cluster, top_k, temperature, s);
  return launch<kTopKWide>(lg, g, o, B, V, cluster, top_k, temperature, s);
}
