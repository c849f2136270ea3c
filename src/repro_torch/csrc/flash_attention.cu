// Flash-attention forward over full sequences (prefill), GQA, causal and
// sliding-window masks.  Replaces the Pallas kernel
// repro/kernels/flash_attention.py flash_attention_bhsd.
//
// q (B, Sq, H, HD), k/v (B, Sk, KV, HD) -> out (B, Sq, H, HD), read and
// written in that layout (no transpose, no pad of the head dim or of S:
// the ragged tails are masked).  Query position i and key position j
// both count from 0; j is visible to i when (not causal or j <= i) and
// (window == 0 or j > i - window).  Softmax in f32, online.
//
// One CTA = one (row b, kv head, tile of kRows query rows).  The Sq*G
// query rows that share a kv head (row index = i*G + g, G = H/KV heads
// per kv head) are cut into tiles of kRows = 64, so one K/V chunk staged
// in shared memory serves 64 query rows — all G heads of ~64/G query
// positions — where the decode kernels' tiles serve 8.  The queries of
// the tile sit in shared memory as f32; the keys the tile can see go in
// chunks of 32 (16-byte vector loads, all issued before any is stored,
// into shared memory as f32).  Each warp owns 8 query rows: a lane
// scores one key of the chunk against the warp's rows (the key read
// once from shared memory for all 8, four head-dim lanes a load), the
// online softmax runs across the warp, and each lane accumulates HD/32
// columns of the 8 output rows in registers.  Chunks past the last key
// any query of the tile sees (causal) or before the first (window) are
// never read; a warp skips a chunk none of its rows sees.  Tiles are
// launched heaviest first (the causal tiles near the end of the
// sequence see the most keys), two CTAs an SM.  CUDA cores in f32;
// tensor cores (mma.sync / wgmma) and TMA are later work.
#include "attend.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;

// Shared memory of one CTA, in floats: q (kRows, HD), k (kChunk, HD + 4)
// (the +4 keeps a lane-per-key float4 read free of bank conflicts), v
// (kChunk, HD).
template <int HD>
constexpr int smem_floats() {
  return kRows * HD + kChunk * (HD + 4) + kChunk * HD;
}

// two CTAs an SM (at most 128 registers a thread): while one waits at
// its barrier for a K/V chunk from device memory, the other computes
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KV, int causal, int window,
                       float scale) {
  constexpr int PER_LANE = HD / 32;
  constexpr int KS = HD + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][HD]
  float* ks = qs + kRows * HD;                   // [kChunk][KS]
  float* vs = ks + kChunk * KS;                  // [kChunk][HD]

  const int tiles = gridDim.x;
  const int tile = tiles - 1 - blockIdx.x;       // heaviest first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int n_rows = Sq * G;
  const int row0 = tile * kRows;
  const int row_end = min(row0 + kRows, n_rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows) {
      const int qi = gr / G, head = kv * G + gr % G;
      x = rt::to_f(q[(((long long)b * Sq + qi) * H + head) * HD + d]);
    }
    qs[i] = x;
  }

  // keys any query of the tile can see
  const int q_lo = row0 / G, q_hi = (row_end - 1) / G;
  const int k_end = causal ? min(q_hi + 1, Sk) : Sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  // and the query positions of this warp's rows
  const int wr0 = row0 + warp * kRowsPerWarp;
  const int wq_lo = min(wr0, n_rows - 1) / G;
  const int wq_hi = min(wr0 + kRowsPerWarp - 1, n_rows - 1) / G;
  const bool warp_live = wr0 < row_end;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][PER_LANE];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[rr][j] = 0.f;
  }

  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_TOKEN = HD / VEC;
  constexpr int NLOAD = kChunk * PER_TOKEN / kThreads;
  static_assert(NLOAD * kThreads == kChunk * PER_TOKEN, "chunk tiling");
  const long long kv_stride = (long long)KV * HD;   // between positions
  const T* kb = k + (long long)b * Sk * kv_stride + (long long)kv * HD;
  const T* vb = v + (long long)b * Sk * kv_stride + (long long)kv * HD;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and qs written, first time)
    {
      uint4 kr[NLOAD], vr[NLOAD];
#pragma unroll
      for (int i = 0; i < NLOAD; ++i) {
        const int idx = tid + i * kThreads;
        const int t = idx / PER_TOKEN, key = k0 + t;
        if (key < k_end) {
          const long long off = key * kv_stride + (idx % PER_TOKEN) * VEC;
          kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + off));
          vr[i] = __ldg(reinterpret_cast<const uint4*>(vb + off));
        } else {
          kr[i] = make_uint4(0, 0, 0, 0);
          vr[i] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int i = 0; i < NLOAD; ++i) {
        const int idx = tid + i * kThreads;
        const int t = idx / PER_TOKEN, d0 = (idx % PER_TOKEN) * VEC;
        const T* kx = reinterpret_cast<const T*>(&kr[i]);
        const T* vx = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ks[t * KS + d0 + j] = rt::to_f(kx[j]);
          vs[t * HD + d0 + j] = rt::to_f(vx[j]);
        }
      }
    }
    __syncthreads();
    // warp-uniform: a chunk that none of this warp's rows sees
    if (!warp_live || (causal && k0 > wq_hi) ||
        (window > 0 && k0 + kChunk - 1 <= wq_lo - window))
      continue;

    const int key = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* q4 = reinterpret_cast<const float4*>(
        qs + warp * kRowsPerWarp * HD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qq = q4[rr * (HD / 4) + d4];   // broadcast
        s[rr] = fmaf(qq.x, kk.x, s[rr]);
        s[rr] = fmaf(qq.y, kk.y, s[rr]);
        s[rr] = fmaf(qq.z, kk.z, s[rr]);
        s[rr] = fmaf(qq.w, kk.w, s[rr]);
      }
    }

    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int gr = wr0 + rr;
      const int qi = gr / G;
      const bool ok = gr < row_end && key < k_end &&
                      (!causal || key <= qi) &&
                      (window <= 0 || key > qi - window);
      const float sc = ok ? s[rr] * scale : -INFINITY;
      const float m_new = fmaxf(m[rr], rt::warp_max(sc));
      if (m_new == -INFINITY) {   // no visible key yet (warp-uniform)
        p[rr] = 0.f;
        alpha[rr] = 1.f;
        continue;
      }
      alpha[rr] = expf(m[rr] - m_new);
      p[rr] = ok ? expf(sc - m_new) : 0.f;
      l[rr] = l[rr] * alpha[rr] + rt::warp_sum(p[rr]);
      m[rr] = m_new;
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) acc[rr][j] *= alpha[rr];
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      float vv[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) vv[j] = vs[t * HD + lane + 32 * j];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pt = __shfl_sync(0xffffffffu, p[rr], t);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[rr][j] = fmaf(pt, vv[j], acc[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = wr0 + rr;
    if (gr >= row_end) continue;
    const int qi = gr / G, head = kv * G + gr % G;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* o = out + (((long long)b * Sq + qi) * H + head) * HD;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      o[lane + 32 * j] = rt::from_f<T>(acc[rr][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq * (H / KV) + kRows - 1) / kRows;
  dim3 grid(tiles, KV, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, int B, int Sq, int Sk, int H, int KV,
                  int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int B, int Sq,
                                  int Sk, int H, int KV, int hd, int causal,
                                  int window, float scale, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
