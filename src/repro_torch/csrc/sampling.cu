// On-device sampling: greedy argmax and temperature / top-k gumbel-max.
// Replace the Pallas kernels repro/kernels/sampling.py greedy_sample and
// gumbel_sample.
//
// Both are a per-row argmax of a score over the vocab:
//   greedy  score = logit
//   gumbel  score = g + logit / T           (IEEE division)
//           or, with top-k, -inf where logit < kth (the row's kth largest
//           logit, duplicates counted, as lax.top_k gives it)
// logits, g (B, V) float32 -> out (B,) int32.  Each row is cut into
// `chunks` contiguous column ranges, one CTA of 256 threads each, so a
// few rows still spread over the card's SMs: each thread scans columns
// lo + tid, lo + tid + 256, ... < hi (the tail past V is simply not
// visited), then a warp-shuffle and a shared-memory reduction give the
// chunk's (score, column).  With one chunk the CTA writes the token;
// otherwise it writes its partial result to `part` and a second kernel,
// one warp per row, reduces a row's partials.  The tie rule is
// jnp.argmax's, applied in every partial reduction: the larger value
// wins, equal values go to the LOWER column, and NaN counts as larger
// than any number (the first NaN wins).  A row of -inf gives column 0.
//
// Top-k: kth comes from a radix select over ordered(x), the uint32 image
// of x that sorts as the floats do, one 8-bit digit per pass from the
// top, over the same column chunks: pass p histograms digit p of the
// elements whose higher digits equal the prefix chosen so far (per-warp
// shared histograms, summed into a global (B, 256) histogram with one
// atomic per CTA and bin), and the CTAs of pass p + 1 (and of the
// argmax) first replay the choice of every earlier digit from those
// histograms, so no separate select launch is needed.  After four
// passes the prefix is ordered(kth) exactly.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;      // one 8-bit digit
constexpr int kPasses = 4;
static_assert(kBins == kThreads, "row_select: one bin per thread");

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

struct Prefix {
  unsigned value, mask;
};

// Called by every thread of a CTA: the digits of row b chosen by passes
// 0 .. npass-1, from their histograms hist[p][b][bin].  Thread t owns
// digit 255 - t, so an inclusive scan over t counts the elements at or
// above each digit; the kth largest falls in the digit where that count
// first reaches k.
__device__ Prefix row_select(const unsigned* __restrict__ hist, int b,
                             int B, int npass, int k) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_prefix, s_krem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int digit = kBins - 1 - (int)threadIdx.x;
  Prefix pre{0u, 0u};
  unsigned krem = (unsigned)k;
  for (int p = 0; p < npass; ++p) {
    const int shift = 24 - 8 * p;
    const unsigned cnt = hist[((long long)p * B + b) * kBins + digit];
    unsigned incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += s_warp[w];
    const unsigned above = incl - cnt;
    if (above < krem && incl >= krem) {
      s_prefix = pre.value | ((unsigned)digit << shift);
      s_krem = krem - above;
    }
    __syncthreads();
    pre.value = s_prefix;
    pre.mask |= (unsigned)(kBins - 1) << shift;
    krem = s_krem;
    __syncthreads();
  }
  return pre;
}

// grid (chunks, B): pass `pass` of the radix select over each chunk.
__global__ void __launch_bounds__(kThreads)
topk_hist_kernel(const float* __restrict__ logits, unsigned* __restrict__ hist,
                 int B, int V, int chunk, int pass, int k) {
  __shared__ unsigned s_hist[kWarps][kBins];
  const int b = blockIdx.y, c = blockIdx.x;
  const Prefix pre = row_select(hist, b, B, pass, k);
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&s_hist[0][0])[i] = 0;
  __syncthreads();
  const int shift = 24 - 8 * pass, warp = threadIdx.x >> 5;
  const float* row = logits + (long long)b * V;
  const int hi = min(V, (c + 1) * chunk);
#pragma unroll 4
  for (int i = c * chunk + threadIdx.x; i < hi; i += kThreads) {
    const unsigned u = ordered(__ldg(row + i));
    if ((u & pre.mask) == pre.value)
      atomicAdd(&s_hist[warp][(u >> shift) & (kBins - 1)], 1u);
  }
  __syncthreads();
  unsigned tot = 0;
  for (int w = 0; w < kWarps; ++w) tot += s_hist[w][threadIdx.x];
  if (tot)
    atomicAdd(&hist[((long long)pass * B + b) * kBins + threadIdx.x], tot);
}

// the score of column i of one row
struct GreedyRow {
  const float* lg;
  __device__ __forceinline__ float operator()(int i) const {
    return __ldg(lg + i);
  }
};

struct GumbelRow {
  const float* lg;
  const float* g;
  float thr;     // -inf without top-k: every column kept
  float t;
  __device__ __forceinline__ float operator()(int i) const {
    const float x = __ldg(lg + i);
    if (x < thr) return -INFINITY;
    return __fadd_rn(__ldg(g + i), __fdiv_rn(x, t));
  }
};

struct Greedy {
  const float* logits;
  __device__ GreedyRow row(int b, int V) const {
    return GreedyRow{logits + (long long)b * V};
  }
};

struct Gumbel {
  const float* logits;
  const float* g;
  const unsigned* hist;   // the top-k histograms, or null
  int B, k;
  float t;
  // called by every thread of the CTA (row_select synchronises it)
  __device__ GumbelRow row(int b, int V) const {
    const long long off = (long long)b * V;
    const float thr = hist ? from_ordered(row_select(hist, b, B, kPasses,
                                                     k).value)
                           : -INFINITY;
    return GumbelRow{logits + off, g + off, thr, t};
  }
};

// grid (chunks, B).  part: (B, chunks) values then (B, chunks) columns.
template <class Score>
__global__ void __launch_bounds__(kThreads)
argmax_chunk_kernel(Score score, int* __restrict__ out,
                    float* __restrict__ part_val, int* __restrict__ part_idx,
                    int V, int chunk) {
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int b = blockIdx.y, c = blockIdx.x, chunks = gridDim.x;
  const auto row = score.row(b, V);
  const int hi = min(V, (c + 1) * chunk);
  float best = -INFINITY;
  int idx = INT_MAX;
#pragma unroll 4
  for (int i = c * chunk + threadIdx.x; i < hi; i += kThreads) {
    const float x = row(i);
    if (better(x, i, best, idx)) {
      best = x;
      idx = i;
    }
  }
  warp_best(best, idx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kThreads / 32 ? s_val[lane] : -INFINITY;
  idx = lane < kThreads / 32 ? s_idx[lane] : INT_MAX;
  warp_best(best, idx);
  if (lane != 0) return;
  if (chunks == 1) {
    out[b] = idx == INT_MAX ? 0 : idx;
  } else {
    part_val[b * chunks + c] = best;
    part_idx[b * chunks + c] = idx;
  }
}

// grid B, one warp: the row's chunk partials -> its token.
__global__ void argmax_merge_kernel(const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx,
                                    int* __restrict__ out, int chunks) {
  const int b = blockIdx.x, lane = threadIdx.x;
  float best = -INFINITY;
  int idx = INT_MAX;
  for (int c = lane; c < chunks; c += 32) {
    const float x = part_val[b * chunks + c];
    const int i = part_idx[b * chunks + c];
    if (better(x, i, best, idx)) {
      best = x;
      idx = i;
    }
  }
  warp_best(best, idx);
  if (lane == 0) out[b] = idx == INT_MAX ? 0 : idx;
}

template <class Score>
int launch_argmax(Score score, void* out, void* part, int B, int V,
                  int chunks, cudaStream_t s) {
  const int chunk = (V + chunks - 1) / chunks;
  float* pv = static_cast<float*>(part);
  int* pi = static_cast<int*>(part) + (long long)B * chunks;
  argmax_chunk_kernel<<<dim3(chunks, B), kThreads, 0, s>>>(
      score, static_cast<int*>(out), pv, pi, V, chunk);
  if (chunks > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    argmax_merge_kernel<<<B, 32, 0, s>>>(pv, pi, static_cast<int*>(out),
                                         chunks);
  }
  return cudaGetLastError();
}

}  // namespace

// part: int32 scratch of 2 * B * chunks (unused when chunks == 1).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rt_greedy_sample(const void* logits, void* out, void* part,
                                int B, int V, int chunks, void* stream) {
  if (B <= 0 || V <= 0 || chunks < 1 || chunks > V || B > 65535)
    return cudaErrorInvalidValue;
  return launch_argmax(Greedy{static_cast<const float*>(logits)}, out, part,
                       B, V, chunks, static_cast<cudaStream_t>(stream));
}

// hist: uint32 scratch of kPasses * B * 256 (unused when top_k == 0).
extern "C" int rt_gumbel_sample(const void* logits, const void* gumbel,
                                void* out, void* part, void* hist, int B,
                                int V, int chunks, int top_k,
                                float temperature, void* stream) {
  if (B <= 0 || V <= 0 || chunks < 1 || chunks > V || B > 65535 ||
      top_k < 0 || top_k > V || !(temperature > 0.0f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  unsigned* h = nullptr;
  if (top_k > 0) {
    h = static_cast<unsigned*>(hist);
    cudaError_t err = cudaMemsetAsync(
        h, 0, sizeof(unsigned) * kPasses * B * kBins, s);
    if (err != cudaSuccess) return err;
    const int chunk = (V + chunks - 1) / chunks;
    for (int p = 0; p < kPasses; ++p) {
      topk_hist_kernel<<<dim3(chunks, B), kThreads, 0, s>>>(lg, h, B, V,
                                                            chunk, p, top_k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return launch_argmax(
      Gumbel{lg, static_cast<const float*>(gumbel), h, B, top_k,
             temperature},
      out, part, B, V, chunks, s);
}
