// Mamba-2 SSD intra-chunk block (arXiv:2405.21060).  Replaces the Pallas
// kernel repro/kernels/ssd_chunk.py ssd_chunk_bchp.
//
// Per chunk c of length l and head h, with da = the within-chunk cumsum
// of dt * A:
//   y[i, :]   = sum_{j <= i} (C_i . B_j) exp(da_i - da_j) (x_j dt_j)[:]
//   st[n, :]  = sum_j B_j[n] exp(da_{l-1} - da_j) dt_j x_j[:]
// x (bc, l, h, p), B and C (bc, l, h, n) in float32 or bfloat16, dt and
// da (bc, l, h) float32 -> y (bc, l, h, p) in x's dtype, st (bc, h, n, p)
// float32.  Everything is summed in float32.
//
// Bound: at full width (l 256, p 64, n 128, bf16) the block moves about
// 15 MB per two chunks of 32 heads and does about 1.1 GFLOP, so the
// card's memory rate bounds it (the tensor cores would finish the
// products in a fifth of the time).  Design, a plain first version: the
// TPU kernel holds the whole (l, l) score tile in VMEM; on Hopper the
// 256 x 256 f32 tile (256 KB) does not fit a block's shared memory, so
// each CTA owns one tile of kTile query rows of one (chunk, head) and
// loops over the key tiles j <= i: C_i^T and B_j^T tiles (k-major, so a
// thread reads its rows as one vector) and the kTile x kTile masked
// score tile in shared memory, the (kTile, p) output in registers.  The
// chunk states are one more CTA (or a few, for large n * p) per (chunk,
// head) over slices of n.  Every product is scalar FMA on the CUDA cores
// over register tiles (2 x 2 scores, 2 x 4 outputs, 4 x 4 states a
// thread), so each shared-memory vector load feeds 4-16 FMAs; wgmma is
// for a later version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;           // query rows per CTA, keys per step
constexpr int kSP = kTile + 2;      // padded stride of the k-major tiles
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kYTiles = 2;          // (2 x 4) output tiles a thread, of y
constexpr int kStTiles = 2;         // (4 x 4) output tiles a thread, of st
constexpr int kStMax = kStTiles * kThreads * 16;  // state outputs a CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}

struct Dims {
  int l, h, p, n;
  int p4;           // p rounded up to 4 (the padded tile width)
  int q_tiles;      // CTAs of query rows per (chunk, head)
  int ns;           // state rows of n per state CTA (a multiple of 4)
};

template <class T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ da, const T* __restrict__ B,
                 const T* __restrict__ C, T* __restrict__ y,
                 float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z, tile = blockIdx.x;
  const int l = d.l, h = d.h, p = d.p, n = d.n, p4 = d.p4;
  const int l4 = (l + 3) & ~3;
  float* s_da = smem;                   // (l,)
  float* s_dt = s_da + l4;              // (l,)
  float* work = s_dt + l4;              // 16-byte aligned tiles
  for (int i = tid; i < l; i += kThreads) {
    const long long r = ((long long)bb * l + i) * h + hh;
    s_da[i] = da[r];
    s_dt[i] = dt[r];
  }
  __syncthreads();
  // row i of the (bc, l, h, f) tensors at this chunk and head
  auto at = [&](int i, int f) {
    return (((long long)bb * l + i) * h + hh) * f;
  };

  if (tile < d.q_tiles) {
    // ---- y for query rows q0 .. q0 + kTile ----
    const int q0 = tile * kTile;
    float* s_ct = work;                  // (n, kSP): C^T of the query rows
    float* s_bt = s_ct + n * kSP;        // (n, kSP): B^T of the key rows
    float* s_x = s_bt + n * kSP;         // (kTile, p4): x * dt of the keys
    float* s_mt = s_x + kTile * p4;      // (kTile, kSP): masked scores^T
    for (int e = tid; e < kTile * n; e += kThreads) {
      const int i = e / n, k = e % n;
      s_ct[k * kSP + i] = q0 + i < l ? to_f(C[at(q0 + i, n) + k]) : 0.0f;
    }
    // the (2 x 2) score tile of this thread: query rows si, si + 1 and
    // keys sj, sj + 1 of the key tile
    const int si = (tid % 16) * 2, sj = (tid / 16) * 2;
    float acc[kYTiles][8];
#pragma unroll
    for (int t = 0; t < kYTiles; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[t][k] = 0.0f;
    const int y_tiles = (kTile / 2) * (p4 / 4);
    for (int j0 = 0; j0 <= q0 && j0 < l; j0 += kTile) {
      __syncthreads();                   // the previous tile is consumed
      for (int e = tid; e < kTile * n; e += kThreads) {
        const int j = e / n, k = e % n;
        s_bt[k * kSP + j] = j0 + j < l ? to_f(B[at(j0 + j, n) + k]) : 0.0f;
      }
      for (int e = tid; e < kTile * p4; e += kThreads) {
        const int j = e / p4, c = e % p4;
        s_x[e] = (j0 + j < l && c < p)
                     ? __fmul_rn(to_f(x[at(j0 + j, p) + c]), s_dt[j0 + j])
                     : 0.0f;
      }
      __syncthreads();
      // masked scores: (C_i . B_j) * exp(da_i - da_j) for j <= i, else 0
      float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float2 c =
            *reinterpret_cast<const float2*>(s_ct + k * kSP + si);
        const float2 b =
            *reinterpret_cast<const float2*>(s_bt + k * kSP + sj);
        s00 = fmaf(c.x, b.x, s00);
        s01 = fmaf(c.x, b.y, s01);
        s10 = fmaf(c.y, b.x, s10);
        s11 = fmaf(c.y, b.y, s11);
      }
      const float sv[2][2] = {{s00, s01}, {s10, s11}};
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        float m[2];
#pragma unroll
        for (int di = 0; di < 2; ++di) {
          const int qi = q0 + si + di, kj = j0 + sj + dj;
          m[di] = (qi < l && kj <= qi)
                      ? __fmul_rn(sv[di][dj], expf(s_da[qi] - s_da[kj]))
                      : 0.0f;
        }
        *reinterpret_cast<float2*>(s_mt + (sj + dj) * kSP + si) =
            make_float2(m[0], m[1]);
      }
      __syncthreads();
      // y += M x_dt over the (2 x 4) output tiles of this thread
#pragma unroll
      for (int t = 0; t < kYTiles; ++t) {
        const int mt = tid + t * kThreads;
        if (mt < y_tiles) {
          const int i0 = (mt % 16) * 2, c0 = (mt / 16) * 4;
          float* a = acc[t];
#pragma unroll 8
          for (int j = 0; j < kTile; ++j) {
            const float2 m =
                *reinterpret_cast<const float2*>(s_mt + j * kSP + i0);
            const float4 v =
                *reinterpret_cast<const float4*>(s_x + j * p4 + c0);
            a[0] = fmaf(m.x, v.x, a[0]);
            a[1] = fmaf(m.x, v.y, a[1]);
            a[2] = fmaf(m.x, v.z, a[2]);
            a[3] = fmaf(m.x, v.w, a[3]);
            a[4] = fmaf(m.y, v.x, a[4]);
            a[5] = fmaf(m.y, v.y, a[5]);
            a[6] = fmaf(m.y, v.z, a[6]);
            a[7] = fmaf(m.y, v.w, a[7]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kYTiles; ++t) {
      const int mt = tid + t * kThreads;
      if (mt < y_tiles) {
        const int i0 = (mt % 16) * 2, c0 = (mt / 16) * 4;
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dc = 0; dc < 4; ++dc)
            if (q0 + i0 + di < l && c0 + dc < p)
              y[at(q0 + i0 + di, p) + c0 + dc] =
                  from_f<T>(acc[t][di * 4 + dc]);
      }
    }
    return;
  }

  // ---- chunk states for rows n0 .. n0 + ns of n ----
  const int n0 = (tile - d.q_tiles) * d.ns;
  const int ns = min(d.ns, n - n0);          // real rows of this slice
  const int ns4 = (ns + 3) & ~3;
  const float da_last = s_da[l - 1];
  float* s_bd = work;                 // (kTile, ns4): B * decay-to-end * dt
  float* s_x = s_bd + kTile * d.ns;   // (kTile, p4)
  const int rgroups = ns4 / 4;
  const int st_tiles = rgroups * (p4 / 4);
  float acc[kStTiles][16];
#pragma unroll
  for (int t = 0; t < kStTiles; ++t)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[t][k] = 0.0f;
  for (int j0 = 0; j0 < l; j0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * ns4; e += kThreads) {
      const int j = e / ns4, r = e % ns4;
      float v = 0.0f;
      if (j0 + j < l && r < ns) {
        const float dte =
            __fmul_rn(expf(da_last - s_da[j0 + j]), s_dt[j0 + j]);
        v = __fmul_rn(to_f(B[at(j0 + j, n) + n0 + r]), dte);
      }
      s_bd[e] = v;
    }
    for (int e = tid; e < kTile * p4; e += kThreads) {
      const int j = e / p4, c = e % p4;
      s_x[e] = (j0 + j < l && c < p) ? to_f(x[at(j0 + j, p) + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kStTiles; ++t) {
      const int mt = tid + t * kThreads;
      if (mt < st_tiles) {
        const int r0 = (mt % rgroups) * 4, c0 = (mt / rgroups) * 4;
        float* a = acc[t];
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(s_bd + j * ns4 + r0);
          const float4 v =
              *reinterpret_cast<const float4*>(s_x + j * p4 + c0);
          const float bv[4] = {b.x, b.y, b.z, b.w};
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int dr = 0; dr < 4; ++dr)
#pragma unroll
            for (int dc = 0; dc < 4; ++dc)
              a[dr * 4 + dc] = fmaf(bv[dr], xv[dc], a[dr * 4 + dc]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kStTiles; ++t) {
    const int mt = tid + t * kThreads;
    if (mt < st_tiles) {
      const int r0 = (mt % rgroups) * 4, c0 = (mt / rgroups) * 4;
#pragma unroll
      for (int dr = 0; dr < 4; ++dr)
#pragma unroll
        for (int dc = 0; dc < 4; ++dc)
          if (r0 + dr < ns && c0 + dc < p)
            st[(((long long)bb * h + hh) * n + n0 + r0 + dr) * p + c0 + dc] =
                acc[t][dr * 4 + dc];
    }
  }
}

size_t smem_bytes(const Dims& d) {
  const size_t lead = 2 * (((size_t)d.l + 3) & ~(size_t)3);   // da, dt
  const size_t y_tile = 2 * (size_t)d.n * kSP + (size_t)kTile * d.p4 +
                        (size_t)kTile * kSP;
  const size_t st_tile = (size_t)kTile * d.ns + (size_t)kTile * d.p4;
  return sizeof(float) * (lead + (y_tile > st_tile ? y_tile : st_tile));
}

template <class T>
int launch(const void* x, const void* dt, const void* da, const void* B,
           const void* C, void* y, void* st, int bc, const Dims& d,
           cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int st_ctas = (d.n + d.ns - 1) / d.ns;
  dim3 grid(d.q_tiles + st_ctas, d.h, bc);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(st),
      d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  Every tensor
// contiguous.  p <= 128, n <= 256, l <= 4096.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int rt_ssd_chunk(const void* x, const void* dt, const void* da,
                            const void* B, const void* C, void* y, void* st,
                            int bc, int l, int h, int p, int n, int dtype,
                            void* stream) {
  if (bc < 1 || bc > 65535 || l < 1 || l > 4096 || h < 1 || h > 65535 ||
      p < 1 || p > kMaxP || n < 1 || n > kMaxN || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  Dims d;
  d.l = l;
  d.h = h;
  d.p = p;
  d.n = n;
  d.p4 = (p + 3) & ~3;
  d.q_tiles = (l + kTile - 1) / kTile;
  // state rows per CTA: a multiple of 4 with ns * p4 <= kStMax
  const int cap = (kStMax / d.p4) & ~3;
  d.ns = ((n + 3) & ~3) < cap ? ((n + 3) & ~3) : cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, da, B, C, y, st, bc, d, s);
  return launch<__nv_bfloat16>(x, dt, da, B, C, y, st, bc, d, s);
}
