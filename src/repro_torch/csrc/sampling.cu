// Greedy sampling: per-row argmax over the vocab.  Replaces the Pallas
// kernel repro/kernels/sampling.py greedy_sample.
//
// logits (B, V) float32 -> out (B,) int32.  Each row is cut into
// `chunks` contiguous column ranges, one CTA of 256 threads each, so a
// few rows still spread over the card's SMs: each thread scans columns
// lo + tid, lo + tid + 256, ... < hi (the tail past V is simply not
// visited), then a warp-shuffle and a shared-memory reduction give the
// chunk's (value, column).  With one chunk the CTA writes the token;
// otherwise it writes its partial result to `part` and a second kernel,
// one warp per row, reduces a row's partials.  The tie rule is
// jnp.argmax's, applied in every partial reduction: the larger value
// wins, equal values go to the LOWER column, and NaN counts as larger
// than any number (the first NaN wins).  A row of -inf gives column 0.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

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

// grid (chunks, B).  part: (B, chunks) values then (B, chunks) columns.
__global__ void __launch_bounds__(kThreads)
greedy_chunk_kernel(const float* __restrict__ logits, int* __restrict__ out,
                    float* __restrict__ part_val, int* __restrict__ part_idx,
                    int V, int chunk) {
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int b = blockIdx.y, c = blockIdx.x, chunks = gridDim.x;
  const float* row = logits + (long long)b * V;
  const int hi = min(V, (c + 1) * chunk);
  float best = -INFINITY;
  int idx = INT_MAX;
#pragma unroll 4
  for (int i = c * chunk + threadIdx.x; i < hi; i += kThreads) {
    const float x = __ldg(row + i);
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
__global__ void greedy_merge_kernel(const float* __restrict__ part_val,
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

}  // namespace

// part: int32 scratch of 2 * B * chunks (unused when chunks == 1).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int rt_greedy_sample(const void* logits, void* out, void* part,
                                int B, int V, int chunks, void* stream) {
  if (B <= 0 || V <= 0 || chunks < 1 || chunks > V || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = (V + chunks - 1) / chunks;
  float* pv = static_cast<float*>(part);
  int* pi = static_cast<int*>(part) + (long long)B * chunks;
  greedy_chunk_kernel<<<dim3(chunks, B), kThreads, 0, s>>>(
      static_cast<const float*>(logits), static_cast<int*>(out), pv, pi, V,
      chunk);
  if (chunks > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    greedy_merge_kernel<<<B, 32, 0, s>>>(pv, pi, static_cast<int*>(out),
                                         chunks);
  }
  return cudaGetLastError();
}
