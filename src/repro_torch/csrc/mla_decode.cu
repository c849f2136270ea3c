// Absorbed-query MLA attention over the compressed latent cache.
// Replaces the Pallas kernels repro/kernels/mla_decode.py
// mla_views_attend (per-row latent views, the N-step loop) and
// mla_paged_attend (latent block pools, the fused step).
//
// q_lat (B, C, H, R), q_rope (B, C, H, RD), pos (B,) int32 -> out
// (B, C, H, R).  Latents: views ckv (B, S1, R) / kr (B, S1, RD) with slot
// j = position j, or pools ckv (nb, bs, R) / kr (nb, bs, RD) routed by
// the row's block table (B, NB).  Query c of row b sees keys
// j <= pos[b] + c; score (q_lat . ckv_j + q_rope . kr_j) * scale, value
// ckv_j; softmax in f32.  The trash view slot and the trash block hold
// positions no live query sees, so position masks them.
//
// Bound: bytes at decode (each visible latent read once, ~240 flops a
// byte at H = 128), operations at prefill.  The (C*H, R) f32 accumulator
// of a row (256 KB at H = 128) fits no CTA, so one CTA = (row b, 16 query
// rows (c, head), key split): 8 warps of 2 query rows, each lane holding
// 16 accumulator columns of both rows in registers.  The row's latents go
// through shared memory in chunks of 32 keys, as f32 rows of R + RD = 576
// (padded to 580 floats so that lanes reading different keys with float4
// loads hit distinct banks): a lane scores one key against the warp's two
// rows, the warp runs the online softmax across its lanes, then every
// lane adds the 32 probability-weighted latent rows into its columns with
// float4 loads that feed 8 FMAs each.  With nsplit > 1 the keys a tile
// sees are cut into nsplit ranges, one per CTA, and combine_splits
// (attend.cuh) merges the partial (m, l, acc).  f32 FMA on CUDA cores.
#include "attend.cuh"

namespace {

constexpr int kR = 512;
constexpr int kRD = 64;
constexpr int kK = kR + kRD;          // key width
constexpr int kLd = kK + 4;           // shared row stride, floats
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;
constexpr int kCols = kR / 32 / 4;    // float4 column groups a lane owns
constexpr size_t kSmemBytes = (size_t)(kTileRows + kChunk) * kLd * sizeof(float);

static_assert(kLd % 4 == 0, "float4 rows");
static_assert(kTileRows == 16, "the wrapper's TILE_ROWS");

// Token index of key position t of row b in the latent storage.
struct ViewLatents {
  int s1;
  __device__ __forceinline__ long long token(int b, int t) const {
    return (long long)b * s1 + t;
  }
};

struct PagedLatents {
  const int* bt;
  int nb_seq, bs;
  __device__ __forceinline__ long long token(int b, int t) const {
    return (long long)bt[(long long)b * nb_seq + t / bs] * bs + t % bs;
  }
};

__device__ __forceinline__ void store_f4(float* dst, float a, float b,
                                         float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// Stage keys [k0, k0 + kChunk) of row b, zeros at and past k_end, into
// ks as f32 rows [ckv | kr].  Every 16-byte load is issued before the
// first store, so their latencies overlap.
template <typename T, typename Lat>
__device__ __forceinline__ void load_latents(const T* __restrict__ ckv,
                                             const T* __restrict__ kr,
                                             const Lat& lat, int b, int k0,
                                             int k_end, float* ks) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PR = kR / VEC;
  constexpr int PER_KEY = kK / VEC;
  constexpr int N = kChunk * PER_KEY / kThreads;
  static_assert(N * kThreads == kChunk * PER_KEY, "chunk tiling");
  uint4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / PER_KEY, u = idx % PER_KEY, key = k0 + t;
    if (key < k_end) {
      const long long tok = lat.token(b, key);
      const T* src = u < PR ? ckv + tok * kR + u * VEC
                            : kr + tok * kRD + (u - PR) * VEC;
      v[i] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      v[i] = make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / PER_KEY, u = idx % PER_KEY;
    float* dst = ks + t * kLd + u * VEC;
    const T* x = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      store_f4(dst + j, rt::to_f(x[j]), rt::to_f(x[j + 1]),
               rt::to_f(x[j + 2]), rt::to_f(x[j + 3]));
  }
}

template <typename T, typename Lat>
__global__ void __launch_bounds__(kThreads, 2)
mla_attend_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ kr,
                  const Lat lat, const int* __restrict__ pos_,
                  T* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int C, int H, int n_keys,
                  float scale, int nsplit) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTileRows][kLd]
  float* ks = qs + kTileRows * kLd;             // [kChunk][kLd]

  const int tile = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = C * H;
  const int row0 = tile * kTileRows;
  const int row_end = min(row0 + kTileRows, n_rows);
  const long long qbase = (long long)b * n_rows;   // flat row of (b, 0, 0)
  const int pos = pos_[b];

  for (int i = tid; i < kTileRows * kK; i += kThreads) {
    const int r = i / kK, d = i % kK, gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows)
      x = d < kR ? rt::to_f(q_lat[(qbase + gr) * kR + d])
                 : rt::to_f(q_rope[(qbase + gr) * kRD + (d - kR)]);
    qs[r * kLd + d] = x;
  }

  // keys any query of the tile sees, then this CTA's share of them
  const int c_hi = (row_end - 1) / H;
  int k_begin = 0;
  int k_end = min(pos + c_hi, n_keys - 1) + 1;
  if (nsplit > 1) {
    const int span = max(k_end, 0);
    const int per = ((span + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
    k_begin = split * per;
    k_end = min(k_end, k_begin + per);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4 * kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kCols; ++j) acc[rr][j] = 0.f;
  }
  const float* q0 = qs + (warp * kRowsPerWarp) * kLd;
  const float* q1 = q0 + kLd;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and qs written, first time)
    load_latents<T>(ckv, kr, lat, b, k0, k_end, ks);
    __syncthreads();

    // scores: lane = key, against both of the warp's rows
    const int key = k0 + lane;
    const float* kp = ks + lane * kLd;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int d = 0; d < kK; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kp + d);
      const float4 a = *reinterpret_cast<const float4*>(q0 + d);
      const float4 c = *reinterpret_cast<const float4*>(q1 + d);
      s0 = fmaf(a.x, kv.x, s0); s0 = fmaf(a.y, kv.y, s0);
      s0 = fmaf(a.z, kv.z, s0); s0 = fmaf(a.w, kv.w, s0);
      s1 = fmaf(c.x, kv.x, s1); s1 = fmaf(c.y, kv.y, s1);
      s1 = fmaf(c.z, kv.z, s1); s1 = fmaf(c.w, kv.w, s1);
    }
    const float sc[kRowsPerWarp] = {s0 * scale, s1 * scale};

    float p[kRowsPerWarp], alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int gr = row0 + warp * kRowsPerWarp + rr;
      const bool ok = gr < row_end && key < k_end && key <= pos + gr / H;
      const float s = ok ? sc[rr] : -INFINITY;
      const float m_new = fmaxf(m[rr], rt::warp_max(s));
      if (m_new == -INFINITY) {       // no visible key yet (warp-uniform)
        alpha[rr] = 1.f;
        p[rr] = 0.f;
      } else {
        alpha[rr] = expf(m[rr] - m_new);
        p[rr] = ok ? expf(s - m_new) : 0.f;
        m[rr] = m_new;
      }
      l[rr] = l[rr] * alpha[rr] + rt::warp_sum(p[rr]);
#pragma unroll
      for (int j = 0; j < 4 * kCols; ++j) acc[rr][j] *= alpha[rr];
    }

    // acc += p . latent over the chunk's keys; lane owns columns
    // 4 * lane + 128 * g + (0..3)
    const int nt = min(kChunk, k_end - k0);
    for (int t = 0; t < nt; ++t) {
      const float p0 = __shfl_sync(0xffffffffu, p[0], t);
      const float p1 = __shfl_sync(0xffffffffu, p[1], t);
      const float* vrow = ks + t * kLd + 4 * lane;
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(vrow + 128 * g);
        float* a0 = acc[0] + 4 * g;
        float* a1 = acc[1] + 4 * g;
        a0[0] = fmaf(p0, v.x, a0[0]); a0[1] = fmaf(p0, v.y, a0[1]);
        a0[2] = fmaf(p0, v.z, a0[2]); a0[3] = fmaf(p0, v.w, a0[3]);
        a1[0] = fmaf(p1, v.x, a1[0]); a1[1] = fmaf(p1, v.y, a1[1]);
        a1[2] = fmaf(p1, v.z, a1[2]); a1[3] = fmaf(p1, v.w, a1[3]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int gr = row0 + warp * kRowsPerWarp + rr;
    if (gr >= row_end) continue;
    const long long orow = qbase + gr;
    if (nsplit > 1) {
      const long long prow = orow * nsplit + split;
#pragma unroll
      for (int g = 0; g < kCols; ++g)
        store_f4(part_acc + prow * kR + 4 * lane + 128 * g, acc[rr][4 * g],
                 acc[rr][4 * g + 1], acc[rr][4 * g + 2], acc[rr][4 * g + 3]);
      if (lane == 0) {
        part_ml[prow * 2] = m[rr];
        part_ml[prow * 2 + 1] = l[rr];
      }
      continue;
    }
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* o = out + orow * kR + 4 * lane;
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[128 * g + j] = rt::from_f<T>(acc[rr][4 * g + j] * inv);
  }
}

template <typename T, typename Lat>
cudaError_t launch(const void* ql, const void* qr, const void* ckv,
                   const void* kr, const Lat& lat, const void* pos, void* out,
                   void* pacc, void* pml, int B, int C, int H, int n_keys,
                   float scale, int nsplit, cudaStream_t stream) {
  auto kernel = mla_attend_kernel<T, Lat>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (C * H + kTileRows - 1) / kTileRows;
  dim3 grid(tiles * nsplit, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qr),
      static_cast<const T*>(ckv), static_cast<const T*>(kr), lat,
      static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(pacc), static_cast<float*>(pml), C, H, n_keys,
      scale, nsplit);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = B * C * H;
    rt::combine_splits<T, kR><<<(rows + rt::kWarps - 1) / rt::kWarps,
                                rt::kThreads, 0, stream>>>(
        static_cast<const float*>(pacc), static_cast<const float*>(pml),
        static_cast<T*>(out), rows, nsplit);
  }
  return cudaGetLastError();
}

template <typename Lat>
int by_dtype(int dtype, const void* ql, const void* qr, const void* ckv,
             const void* kr, const Lat& lat, const void* pos, void* out,
             void* pacc, void* pml, int B, int C, int H, int n_keys,
             float scale, int nsplit, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || n_keys <= 0 || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ql, qr, ckv, kr, lat, pos, out, pacc, pml, B, C, H,
                         n_keys, scale, nsplit, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ql, qr, ckv, kr, lat, pos, out, pacc, pml,
                                 B, C, H, n_keys, scale, nsplit, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Latent views (B, S1, R) / (B, S1, RD).  dtype: 0 = float32, 1 =
// bfloat16.  part_acc (B*C*H, nsplit, R) and part_ml (B*C*H, nsplit, 2)
// are f32 scratch, unused when nsplit == 1.  Returns cudaGetLastError()
// after the launches.
extern "C" int rt_mla_decode_views(const void* q_lat, const void* q_rope,
                                   const void* ckv, const void* kr, int S1,
                                   const void* pos, void* out, void* part_acc,
                                   void* part_ml, int B, int C, int H,
                                   float scale, int nsplit, int dtype,
                                   void* stream) {
  return by_dtype(dtype, q_lat, q_rope, ckv, kr, ViewLatents{S1}, pos, out,
                  part_acc, part_ml, B, C, H, S1, scale, nsplit, stream);
}

// Latent block pools (nb, bs, R) / (nb, bs, RD), block tables (B, nb_seq)
// int32; the rest as above.
extern "C" int rt_mla_decode_paged(const void* q_lat, const void* q_rope,
                                   const void* ckv_pool, const void* kr_pool,
                                   const void* block_tables, int nb_seq,
                                   int bs, const void* pos, void* out,
                                   void* part_acc, void* part_ml, int B,
                                   int C, int H, float scale, int nsplit,
                                   int dtype, void* stream) {
  const PagedLatents lat{static_cast<const int*>(block_tables), nb_seq, bs};
  return by_dtype(dtype, q_lat, q_rope, ckv_pool, kr_pool, lat, pos, out,
                  part_acc, part_ml, B, C, H, nb_seq * bs, scale, nsplit,
                  stream);
}
